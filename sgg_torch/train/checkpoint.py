"""Workdirs and checkpoints, from ``sgg/train/checkpoint.py``.

A workdir holds ``config.json`` and ``vocab.json`` beside the weights. The
generator's weights and their EMA (either decoder), and for a pixels-in config
the encoder's (``enc_params``), are port state_dicts in one torch file,
``generator.pt``, which ``sgg_torch.cli.generate`` reads. Training keeps its
whole state (the modules, their Adam states, the step) as
``checkpoints/<step>/state.pt``, at most ``max_to_keep`` of them, and
rewrites ``generator.pt`` at every save; with ``data_state`` (the grain
loader's iterator snapshot, ``sgg_torch.data.grain_pipeline``) a sidecar
``checkpoints/data_iter_<step>.bin`` rides along, pruned with the
checkpoints, and :meth:`CheckpointManager.restore_data_state` reads the
latest's back (``sgg/train/checkpoint.py:113-140``); ``restore_averaged`` and
:func:`restore_weights` read the mean of the last N. The reference's orbax
checkpoints are not read here: ``sgg_torch.convert_flax`` turns restored flax
trees into state_dicts.
"""

from __future__ import annotations

import os
import shutil

import torch

from sgg_torch.config import Config
from sgg_torch.data.vocab import Vocab
from sgg_torch.train.state import create_train_state

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

    def __init__(self, workdir: str, cfg: Config | None, max_to_keep: int = 3):
        """``cfg``, when given, is written to ``workdir/config.json``; a reader
        of an existing workdir passes None."""
        self.workdir = os.path.abspath(workdir)
        self.ckpt_dir = os.path.join(self.workdir, "checkpoints")
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if cfg is not None:
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

    def save(self, state, data_state: bytes | None = None) -> None:
        """Write ``state`` at its step (and ``data_state`` as its sidecar),
        prune both to ``max_to_keep``, and rewrite ``generator.pt`` for
        generate."""
        step_dir = os.path.join(self.ckpt_dir, str(state.step))
        os.makedirs(step_dir, exist_ok=True)
        _save_atomic(state.state_dict(), os.path.join(step_dir, STATE_FILE))
        if data_state is not None:
            path = self._data_state_path(state.step)
            with open(path + ".tmp", "wb") as f:
                f.write(data_state)
            os.replace(path + ".tmp", path)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(old)))
        keep = set(self.all_steps())
        for name in os.listdir(self.ckpt_dir):
            if (name.startswith("data_iter_") and name.endswith(".bin")
                    and int(name[len("data_iter_"):-len(".bin")]) not in keep):
                os.remove(os.path.join(self.ckpt_dir, name))
        save_generator(self.workdir, state.generator.state_dict(), state.g_ema, state.step,
                       None if state.encoder is None else state.encoder.state_dict())

    def _data_state_path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"data_iter_{step}.bin")

    def restore_data_state(self) -> bytes | None:
        """The input iterator's snapshot saved with the latest checkpoint, if
        any."""
        step = self.latest_step()
        if step is None or not os.path.exists(self._data_state_path(step)):
            return None
        with open(self._data_state_path(step), "rb") as f:
            return f.read()

    def restore(self, state, step: int | None = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place and return it, or None when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        # Loaded to the CPU: each module and optimizer moves its own tensors
        # to its parameters' device.
        state.load_state_dict(self._load(step))
        return state

    def _load(self, step: int) -> dict:
        return torch.load(os.path.join(self.ckpt_dir, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)

    def restore_averaged(self, state, last_n: int):
        """The latest checkpoint in ``state``, with the generator's weights
        (and their EMA, when tracked) replaced by their mean over the last
        ``last_n`` retained checkpoints; None when there is none.

        The sums run in float32 on the host, the latest checkpoint first and
        then the others oldest first, as the reference adds them; each mean
        is cast back to its tensor's dtype. Everything else (critic,
        optimizers, step, encoder) is the latest checkpoint's. One
        checkpoint is read at a time."""
        steps = self.all_steps()[-max(1, int(last_n)):]
        if not steps:
            return None
        self.restore(state, step=steps[-1])
        if len(steps) == 1:
            return state

        def f32(sd):
            return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in sd.items()}

        ref_g = state.generator.state_dict()
        sum_g = f32(ref_g)
        sum_e = None if state.g_ema is None else f32(state.g_ema)
        for s in steps[:-1]:
            sd = self._load(s)
            for k, v in sd["g_params"].items():
                sum_g[k] += v.float()
            if sum_e is not None:
                for k, v in sd["g_ema"].items():
                    sum_e[k] += v.float()
            del sd

        def mean_like(acc, ref):
            return {k: (a / torch.full_like(a, float(len(steps)))).to(ref[k].dtype)
                    for k, a in acc.items()}

        state.generator.load_state_dict(mean_like(sum_g, ref_g))
        if sum_e is not None:
            for k, v in mean_like(sum_e, state.g_ema).items():
                state.g_ema[k].copy_(v)
        return state


def restore_weights(workdir: str, cfg, avg_last: int, device):
    """(step, g_params, g_ema, enc_params, steps averaged) from the workdir:
    ``generator.pt``, or with ``avg_last > 1`` the mean over the last
    retained checkpoints; None when there are no weights."""
    if avg_last > 1:
        mgr = CheckpointManager(workdir, None)
        steps = mgr.all_steps()[-avg_last:]
        state = create_train_state(cfg, cfg.train.seed, device=device)
        if mgr.restore_averaged(state, avg_last) is None:
            return None
        enc = None if state.encoder is None else state.encoder.state_dict()
        return state.step, state.generator.state_dict(), state.g_ema, enc, steps
    ckpt = load_generator(workdir, decoder=cfg.model.decoder)
    if ckpt is None:
        return None
    return ckpt["step"], ckpt["g_params"], ckpt["g_ema"], ckpt["enc_params"], None
