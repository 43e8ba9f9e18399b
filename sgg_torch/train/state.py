"""Model construction from a config, from ``sgg/train/state.py``.

:func:`make_generator` is the decoder switch of the reference's
``make_models``. The critic, the optimizers and the train state come with the
training slice of the port (ROADMAP A3).
"""

from __future__ import annotations

from torch import nn

from sgg_torch.config import Config


def make_generator(cfg: Config) -> nn.Module:
    """The generator ``cfg.model.decoder`` names: ``lstm`` (the
    attention-LSTM) or ``transformer`` (the slot decoder)."""
    decoder = cfg.model.decoder
    if decoder == "lstm":
        from sgg_torch.models.generator import AttentionLSTMGenerator

        return AttentionLSTMGenerator.from_config(cfg)
    if decoder == "transformer":
        from sgg_torch.models.transformer import TransformerTripleGenerator

        return TransformerTripleGenerator.from_config(cfg)
    raise ValueError(f"unknown decoder {decoder!r}")
