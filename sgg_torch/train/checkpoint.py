"""Workdir IO for inference, from ``sgg/train/checkpoint.py``.

A workdir holds ``config.json`` and ``vocab.json`` beside the weights. The
port keeps the generator's weights and their EMA (``g_params``, ``g_ema``,
either decoder),
and for a pixels-in config the frozen encoder's (``enc_params``, as the
reference's train state carries them), as port state_dicts in one torch
file, ``generator.pt``. The reference's orbax checkpoints are not read here:
``sgg_torch.convert_flax`` turns a restored flax tree into a state_dict, and
:func:`save_generator` writes it.
"""

from __future__ import annotations

import os

import torch

from sgg_torch.config import Config
from sgg_torch.data.vocab import Vocab

GENERATOR_FILE = "generator.pt"


def load_workdir(workdir: str) -> tuple[Config, Vocab]:
    """Read back the self-describing workdir: (config, vocab)."""
    with open(os.path.join(workdir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    vocab = Vocab.load(os.path.join(workdir, "vocab.json"))
    return cfg, vocab


def save_generator(
    workdir: str, g_params: dict, g_ema: dict | None = None, step: int = 0,
    enc_params: dict | None = None,
) -> str:
    """Write the generator's state_dict (and its EMA, and the encoder's
    state_dict for a pixels-in config) to ``workdir``."""
    path = os.path.join(workdir, GENERATOR_FILE)
    tmp = path + ".tmp"

    def cpu(sd):
        return None if sd is None else {k: v.detach().cpu() for k, v in sd.items()}

    torch.save(
        {"step": int(step), "g_params": cpu(g_params), "g_ema": cpu(g_ema),
         "enc_params": cpu(enc_params)},
        tmp,
    )
    os.replace(tmp, path)
    return path


def decoder_of(g_params: dict) -> str:
    """Which decoder a generator state_dict holds: ``transformer`` (it has
    ``slot_embed``) or ``lstm``."""
    return "transformer" if "slot_embed" in g_params else "lstm"


def load_generator(workdir: str, decoder: str | None = None) -> dict | None:
    """{'step', 'decoder', 'g_params', 'g_ema', 'enc_params'} from
    ``workdir`` (None for what the file lacks), or None if there is no file.
    With ``decoder`` (the config's ``model.decoder``), raises if the file
    holds the other decoder's weights."""
    path = os.path.join(workdir, GENERATOR_FILE)
    if not os.path.exists(path):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    ckpt.setdefault("enc_params", None)
    ckpt["decoder"] = decoder_of(ckpt["g_params"])
    if decoder is not None and ckpt["decoder"] != decoder:
        raise ValueError(f"{path} holds a {ckpt['decoder']!r} generator; the config's "
                         f"model.decoder is {decoder!r}")
    return ckpt
