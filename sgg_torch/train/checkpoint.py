"""Workdirs and checkpoints, from ``sgg/train/checkpoint.py``.

A workdir holds ``config.json`` and ``vocab.json`` beside the weights. The
generator's weights and their EMA (either decoder), and for a pixels-in config
the encoder's (``enc_params``), are port state_dicts in one torch file,
``generator.pt``, which ``sgg_torch.cli.generate`` reads. Training keeps its
whole state (the modules, their Adam states, the step) as
``checkpoints/<step>/state.pt``, at most ``max_to_keep`` of them, and
rewrites ``generator.pt`` at every save. The reference's orbax checkpoints are
not read here: ``sgg_torch.convert_flax`` turns restored flax trees into
state_dicts.
"""

from __future__ import annotations

import os
import shutil

import torch

from sgg_torch.config import Config
from sgg_torch.data.vocab import Vocab

GENERATOR_FILE = "generator.pt"
STATE_FILE = "state.pt"


def load_workdir(workdir: str) -> tuple[Config, Vocab]:
    """Read back the self-describing workdir: (config, vocab)."""
    with open(os.path.join(workdir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    vocab = Vocab.load(os.path.join(workdir, "vocab.json"))
    return cfg, vocab


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(sd):
    return None if sd is None else {k: v.detach().cpu() for k, v in sd.items()}


def save_generator(
    workdir: str, g_params: dict, g_ema: dict | None = None, step: int = 0,
    enc_params: dict | None = None,
) -> str:
    """Write the generator's state_dict (and its EMA, and the encoder's
    state_dict for a pixels-in config) to ``workdir``."""
    path = os.path.join(workdir, GENERATOR_FILE)
    _save_atomic({"step": int(step), "g_params": _cpu(g_params), "g_ema": _cpu(g_ema),
                  "enc_params": _cpu(enc_params)}, path)
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


class CheckpointManager:
    """Train-state checkpoints under ``workdir/checkpoints/<step>/``, with
    ``max_to_keep`` retention and resume from the latest."""

    def __init__(self, workdir: str, cfg: Config, max_to_keep: int = 3):
        self.workdir = os.path.abspath(workdir)
        self.ckpt_dir = os.path.join(self.workdir, "checkpoints")
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)
        with open(os.path.join(self.workdir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    def save_vocab(self, vocab: Vocab) -> None:
        vocab.save(os.path.join(self.workdir, "vocab.json"))

    def all_steps(self) -> list[int]:
        """Retained checkpoint steps, ascending."""
        return sorted(int(n) for n in os.listdir(self.ckpt_dir)
                      if n.isdigit()
                      and os.path.exists(os.path.join(self.ckpt_dir, n, STATE_FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state) -> None:
        """Write ``state`` at its step, prune to ``max_to_keep``, and rewrite
        ``generator.pt`` for generate."""
        step_dir = os.path.join(self.ckpt_dir, str(state.step))
        os.makedirs(step_dir, exist_ok=True)
        _save_atomic(state.state_dict(), os.path.join(step_dir, STATE_FILE))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(old)))
        save_generator(self.workdir, state.generator.state_dict(), state.g_ema, state.step,
                       None if state.encoder is None else state.encoder.state_dict())

    def restore(self, state, step: int | None = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place and return it, or None when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        # Loaded to the CPU: each module and optimizer moves its own tensors
        # to its parameters' device.
        sd = torch.load(os.path.join(self.ckpt_dir, str(step), STATE_FILE),
                        map_location="cpu", weights_only=True)
        state.load_state_dict(sd)
        return state
