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

Restores are lenient by default, as the reference's
(``sgg/train/checkpoint.py:57-95, 154-190``): a checkpoint whose tree differs
from the state's (a precomputed run resumed as an end-to-end one, a frozen
encoder's run resumed with ``train.train_encoder``, a grown vocabulary, EMA
turned on) falls back to :func:`merge_checkpoint`, leaf by leaf. The state's
tree flattens to paths such as ``g_params/<key>``, ``d_opt/mu/<key>``,
``enc_opt/count`` and ``step``: an optimizer's moments, lists by position in
the state, are keyed by their parameter's name, so each moment follows its
parameter and a drifted module never hands one parameter's moments to
another.
"""

from __future__ import annotations

import os
import shutil
import sys

import torch

from sgg_torch.config import Config
from sgg_torch.data.vocab import Vocab
from sgg_torch.train.state import Adam, create_train_state

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


_MODULES = {"g_opt": "g_params", "d_opt": "d_params", "enc_opt": "enc_params"}
_OPTIMIZERS = {"g_opt": "g_tx", "d_opt": "d_tx", "enc_opt": "enc_tx"}


def flatten_state(sd: dict) -> dict[tuple, object]:
    """A train state's ``state_dict`` (``GANTrainState.state_dict``'s
    layout, or a checkpoint's) → {path: leaf}, the reference's flattening of
    its ``GANTrainState``: ``("step",)``, ``(tree, key)`` for the modules and
    the EMA, ``(opt, "count")`` and ``(opt, "mu" | "nu", key)`` with ``key``
    the parameter's name in its module's state_dict (the modules hold no
    buffers, so the k-th moment is the k-th key's). None fields and leaves
    are left out."""
    out: dict = {}
    for field, value in sd.items():
        if value is None:
            continue
        if field == "step":
            out[("step",)] = value
        elif field in _MODULES:
            names = list(sd[_MODULES[field]].keys())
            mu, nu = Adam.moments_of(value, len(names))
            out[(field, "count")] = value["count"]
            for kind, moments in (("mu", mu), ("nu", nu)):
                for name, t in zip(names, moments, strict=True):
                    if t is not None:
                        out[(field, kind, name)] = t
        else:
            for key, t in value.items():
                out[(field, key)] = t
    return out


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def tree_mismatch(raw: dict, state) -> str | None:
    """Why checkpoint ``raw`` cannot load strictly into ``state`` (missing or
    unexpected leaves, or shapes that differ), or None when it can."""
    live, got = flatten_state(state.state_dict()), flatten_state(raw)
    missing = sorted("/".join(p) for p in live.keys() - got.keys())
    extra = sorted("/".join(p) for p in got.keys() - live.keys())
    shapes = sorted("/".join(p) for p in live.keys() & got.keys()
                    if _shape(live[p]) != _shape(got[p]))
    if not (missing or extra or shapes):
        return None
    return (f"missing {missing or '—'}; unexpected {extra or '—'}; shapes differ at "
            f"{shapes or '—'}")


def merge_checkpoint(raw: dict, state, verbose: bool = True) -> dict:
    """Graft checkpoint ``raw`` (a state_dict as ``GANTrainState.state_dict``
    writes it) onto ``state`` in place, leaf by leaf, the reference's
    contract: a leaf in both with the same shape restores (its dtype cast to
    the state's); a leaf only in the state (a field added since the
    checkpoint was written, or a leaf whose shape changed) keeps its
    initialized value; a leaf only in the checkpoint is ignored. ``step`` and
    each optimizer's count restore as scalars. Returns the report
    ``{"restored": n, "kept": [paths], "ignored": [paths]}``; with
    ``verbose`` a line on stderr lists both."""
    live = flatten_state(state.state_dict())
    got = flatten_state(raw)
    report = {"restored": 0, "kept": [], "ignored": []}
    with torch.no_grad():
        for path, leaf in live.items():
            val = got.pop(path, None)
            if val is None or _shape(val) != _shape(leaf):
                report["kept"].append("/".join(path))
                continue
            if path == ("step",):
                state.step = int(val)
            elif path[-1] == "count" and path[0] in _OPTIMIZERS:
                getattr(state, _OPTIMIZERS[path[0]])._count.fill_(int(val))
            else:
                leaf.copy_(val)
            report["restored"] += 1
    report["ignored"] = ["/".join(p) for p in got]
    if verbose and (report["kept"] or report["ignored"]):
        print(f"[sgg_torch.checkpoint] lenient restore: {report['restored']} leaves restored; "
              f"kept initialized: {report['kept'] or '—'}; ignored from checkpoint: "
              f"{report['ignored'] or '—'}", file=sys.stderr, flush=True)
    return report


def _fallback_line() -> None:
    print("[sgg_torch.checkpoint] strict restore failed (ValueError); falling back to lenient "
          "field-by-field restore", file=sys.stderr, flush=True)


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

    def save(self, state, data_state: bytes | None = None, sd: dict | None = None) -> None:
        """Write ``state`` at its step (and ``data_state`` as its sidecar),
        prune both to ``max_to_keep``, and rewrite ``generator.pt`` for
        generate. ``sd``: the state's global ``state_dict`` when the state
        is placed over a mesh (``sgg_torch.dist.sharding.gather_state``),
        so that a TP or FSDP run writes what a single process writes."""
        sd = state.state_dict() if sd is None else sd
        step_dir = os.path.join(self.ckpt_dir, str(state.step))
        os.makedirs(step_dir, exist_ok=True)
        _save_atomic(sd, os.path.join(step_dir, STATE_FILE))
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
        save_generator(self.workdir, sd["g_params"], sd["g_ema"], state.step, sd["enc_params"])

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

    def restore(self, state, lenient: bool = True, step: int | None = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place and return it, or None when there is none.

        The strict restore first: the checkpoint's tree must be the state's,
        leaf for leaf and shape for shape (:func:`tree_mismatch`), else it
        raises ValueError before it touches the state. With ``lenient`` (the
        default) that failure falls back, with the reference's line on
        stderr, to :func:`merge_checkpoint`: leaves in both with the same
        shape load, the state's other leaves keep their initialized values
        (a missing ``g_ema`` the generator's initial copy, a missing
        ``enc_opt`` its zeros), the checkpoint's others are ignored."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        # Loaded to the CPU: each module and optimizer moves its own tensors
        # to its parameters' device.
        raw = self._load(step)
        err = tree_mismatch(raw, state)
        if err is None:
            state.load_state_dict(raw)
        elif not lenient:
            raise ValueError(f"checkpoint {step} does not match the train state: {err}")
        else:
            _fallback_line()
            merge_checkpoint(raw, state)
        return state

    def _load(self, step: int) -> dict:
        return torch.load(os.path.join(self.ckpt_dir, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)

    def restore_averaged(self, state, last_n: int, lenient: bool = True):
        """The latest checkpoint in ``state``, with the generator's weights
        (and their EMA, when tracked) replaced by their mean over the last
        ``last_n`` retained checkpoints; None when there is none.

        The sums run in float32 on the host, the latest checkpoint first and
        then the others oldest first, as the reference adds them; each mean
        is cast back to its tensor's dtype. Everything else (critic,
        optimizers, step, encoder) is the latest checkpoint's. One
        checkpoint is read at a time. The latest restores as :meth:`restore`
        with ``lenient``; the others must match the state strictly (a
        drifted one raises), as the reference's: a lenient fallback would
        average initialized leaves into the weights."""
        steps = self.all_steps()[-max(1, int(last_n)):]
        if not steps:
            return None
        self.restore(state, lenient, step=steps[-1])
        if len(steps) == 1:
            return state

        def f32(sd):
            return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in sd.items()}

        ref_g = state.generator.state_dict()
        sum_g = f32(ref_g)
        sum_e = None if state.g_ema is None else f32(state.g_ema)
        for s in steps[:-1]:
            sd = self._load(s)
            err = tree_mismatch(sd, state)
            if err is not None:
                raise ValueError(f"checkpoint {s} does not match the train state: {err}")
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


_WEIGHT_FIELDS = ("step", "g_params", "g_ema", "enc_params")


def restore_weights(workdir: str, cfg, avg_last: int, device):
    """(step, g_params, g_ema, enc_params, steps averaged) from the workdir:
    ``generator.pt``, or with ``avg_last > 1`` the mean over the last
    retained checkpoints; None when there are no weights. As the reference's
    generate and evaluate restore, the file's weights are checked against a
    fresh state of the config (:func:`tree_mismatch`); weights that no
    longer fit are grafted onto it (:func:`merge_checkpoint`, after the
    fallback line). A field that the file lacks comes back None either way,
    for the CLIs' own refusals (``--ema`` without EMA weights, a pixels-in
    workdir without encoder weights)."""
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
    state = create_train_state(cfg, cfg.train.seed)
    # The file's fields over the fresh state's own: the rest matches as it is.
    raw = {**state.state_dict(), **{k: ckpt[k] for k in _WEIGHT_FIELDS if ckpt[k] is not None}}
    if tree_mismatch(raw, state) is not None:
        _fallback_line()
        merge_checkpoint(raw, state)
        enc = None if state.encoder is None else state.encoder.state_dict()
        merged = {"step": state.step, "g_params": state.generator.state_dict(),
                  "g_ema": state.g_ema, "enc_params": enc}
        ckpt = {k: None if ckpt[k] is None else merged[k] for k in _WEIGHT_FIELDS}
    return ckpt["step"], ckpt["g_params"], ckpt["g_ema"], ckpt["enc_params"], None
