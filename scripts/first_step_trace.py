"""Trace a process's first train step against the same step repeated, op by op.

  python3 scripts/first_step_trace.py [--config pipeline_v4] [--batch 256] [--no-trace]
      [--warm] [--cold] [--device cpu]

On the card: builds a seeded train state and one seeded super-batch at the
config's widths (float16 features, valid triples), runs one train step from
that state, then the same step from a fresh copy of the same state, and
prints which parameters, gradients and Adam moments differ between the two
(``--no-trace``), or with the trace (the default) records every aten
operator of both steps under a ``TorchDispatchMode`` (its name; each tensor
input's and output's shape, stride, dtype, data pointer modulo 256 and a
digest of its bytes) and prints the first operator whose output differs
while its inputs agree, its neighbours, and how many operators differ (the
two sequences aligned by operator and input shapes first; an operator only
one step ran is printed). Each
step's noise comes from its step counter, so the two steps are the same
computation. ``--warm`` runs one tiny backward on the device first.
``--cold`` leaves out the step's own warm-up (``sgg_torch.train.step.
warm_autograd``, which puts this thread's autograd sequence number above the
device's autograd thread's), as the step ran before it had one. Prints the
card's name and power limit first (``--device cpu``, a dry run, prints none),
and the two threads' autograd sequence numbers before and after the steps.
"""

from __future__ import annotations

import argparse
import collections
import difflib
import os
import subprocess
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sgg_torch.config import get_config  # noqa: E402
from sgg_torch.data import Vocab  # noqa: E402
from sgg_torch.train.state import create_train_state  # noqa: E402
from sgg_torch.train import step as step_mod  # noqa: E402
from sgg_torch.train.step import make_step_fn  # noqa: E402

_INT_OF = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def digest(t: torch.Tensor) -> torch.Tensor:
    """A 0-dim int64 of the tensor's bytes and their order (on its device)."""
    x = t.detach().contiguous().reshape(-1)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.view(_INT_OF[x.element_size()]).to(torch.int64)
    w = torch.arange(x.numel(), device=x.device, dtype=torch.int64) * 2654435761 + 97
    return (x * w).sum() if x.numel() else torch.zeros((), dtype=torch.int64, device=x.device)


class Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops, self.digests = [], []

    def _desc(self, ts):
        out = []
        for t in ts:
            self.digests.append(digest(t))
            out.append((tuple(t.shape), tuple(t.stride()), str(t.dtype), t.data_ptr() % 256))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        tin = [a for a in tree_flatten((args, kwargs or {}))[0] if isinstance(a, torch.Tensor)]
        start = len(self.digests)
        ins = self._desc(tin)  # before the operator runs: in-place ones write their inputs
        result = func(*args, **(kwargs or {}))
        tout = [a for a in tree_flatten(result)[0] if isinstance(a, torch.Tensor)]
        self.ops.append((str(func), ins, self._desc(tout), start, len(tin)))
        return result

    def finish(self):
        vals = (torch.stack([d.cpu() for d in self.digests]).numpy() if self.digests
                else np.zeros(0))
        return [(name, ins, outs, vals[s:s + n], vals[s + n:s + n + len(outs)])
                for name, ins, outs, s, n in self.ops]


def batch_for(cfg, vocab, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = cfg.train
    n_sub, B, R, F = t.n_critic + 1, t.batch_size, cfg.data.regions, cfg.data.feat_dim
    feats = torch.randn(n_sub, B, R, F, generator=gen, device=dev).half()
    objs = torch.from_numpy(np.flatnonzero(vocab.is_object)).to(dev)
    preds = torch.from_numpy(np.flatnonzero(vocab.is_predicate)).to(dev)
    pick = lambda pool: pool[torch.randint(len(pool), (n_sub, B), generator=gen,  # noqa: E731
                                           device=dev)]
    triples = torch.stack([pick(objs), pick(preds), pick(objs)], -1).to(torch.int32)
    return {"features": feats, "triples": triples}


def tensors(state):
    out = {f"g.{k}": v for k, v in state.generator.state_dict().items()}
    out.update({f"d.{k}": v for k, v in state.critic.state_dict().items()})
    for name, tx in (("g_opt", state.g_tx), ("d_opt", state.d_tx)):
        out.update({f"{name}.mu{i}": m for i, m in enumerate(tx.mu)})
        out.update({f"{name}.nu{i}": m for i, m in enumerate(tx.nu)})
    return out


def sequence_numbers(dev) -> tuple[int, int]:
    """(this thread's next autograd sequence number, the one of ``dev``'s
    autograd thread: a node its create_graph backward records)."""
    x = torch.ones(1, device=dev, requires_grad=True)
    (g,) = torch.autograd.grad((x * x).sum(), x, create_graph=True)
    return (x * 1).grad_fn._sequence_nr(), g.grad_fn._sequence_nr()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="pipeline_v4")
    p.add_argument("--batch", type=int, default=0, help="train.batch_size (0: the config's)")
    p.add_argument("--no-trace", action="store_true", help="compare the states only")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--warm", action="store_true",
                   help="run one tiny backward on the device before the two steps")
    p.add_argument("--cold", action="store_true",
                   help="leave out the step's warm_autograd")
    args = p.parse_args()
    if args.cold:
        step_mod.warm_autograd = lambda device: 0
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    vocab = Vocab.load(os.path.join(ROOT, "results", "run_v3_bal0.7_ckpt", "vocab.json"))
    cfg = get_config(args.config)
    if args.batch:
        cfg.train.batch_size = args.batch
    cfg.model.vocab_size = len(vocab)
    step = make_step_fn(cfg, step_mask=vocab.step_mask())
    batch = batch_for(cfg, vocab, dev)
    if args.warm:
        x = torch.ones(4, device=dev, requires_grad=True)
        (x * x).sum().backward()
    print(f"autograd sequence numbers before the steps (this thread, the device's): "
          f"{sequence_numbers(dev)}", flush=True)
    runs = []
    for i in range(2):
        state = create_train_state(cfg, cfg.train.seed, device=dev)
        if args.no_trace:
            step(state, batch)
            runs.append({k: v.detach().clone() for k, v in tensors(state).items()})
            continue
        rec = Recorder()
        with rec:
            step(state, batch)
        runs.append(rec.finish())
        print(f"step {i + 1}: {len(runs[-1])} operators recorded", flush=True)
    print(f"autograd sequence numbers after the steps: {sequence_numbers(dev)}", flush=True)
    if args.no_trace:
        a, b = runs
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        how = (" after a tiny backward" if args.warm else "") + (
            " without the step's warm-up" if args.cold else "")
        print(f"{args.config} B = {cfg.train.batch_size}{how}: "
              f"{len(differ)} of {len(a)} state tensors differ between the first and the "
              "repeated step", flush=True)
        for k in differ:
            d = (a[k].double() - b[k].double()).abs()
            print(f"  {k} {tuple(a[k].shape)}: {int((d > 0).sum())} elements differ, max "
                  f"{float(d.max()):.3e}", flush=True)
        return 0
    a, b = runs
    # Align the two operator sequences (name and input shapes), then compare
    # the operators both ran.
    key = lambda run: [(x[0], tuple(d[0] for d in x[1])) for x in run]  # noqa: E731
    pairs = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, key(a), key(b),
                                                      autojunk=False).get_opcodes():
        if tag == "equal":
            pairs += zip(range(i1, i2), range(j1, j2))
        else:
            print(f"{tag}: first step ops {i1}-{i2} {[x[0] for x in a[i1:i2]]}, repeat ops "
                  f"{j1}-{j2} {[x[0] for x in b[j1:j2]]}", flush=True)
    count = lambda run: collections.Counter(x[0] for x in run)  # noqa: E731
    print(f"operators only the first step runs: {dict(count(a) - count(b))}; only the "
          f"repeat: {dict(count(b) - count(a))}", flush=True)
    extra = [i for i, x in enumerate(a) if x[0] in (count(a) - count(b))]
    for i in extra[:3]:
        print(f"  e.g. op {i}: {a[i][0]} {[d[0] for d in a[i][1]]} -> "
              f"{[d[0] for d in a[i][2]]}; before it: {[x[0] for x in a[max(0, i - 6):i]]}",
              flush=True)
    differ = [(i, j) for i, j in pairs if not np.array_equal(a[i][4], b[j][4])]
    origin = [(i, j) for i, j in differ if np.array_equal(a[i][3], b[j][3])]
    print(f"{len(pairs)} operators aligned of {len(a)} and {len(b)}; {len(differ)} give another "
          f"output, {len(origin)} of them from the same inputs", flush=True)
    for i, j in origin[:6]:
        print(f"op {i} (repeat {j}): {a[i][0]}", flush=True)
        print(f"  inputs (shape, stride, dtype, ptr % 256) first {a[i][1]}", flush=True)
        print(f"                                          repeat {b[j][1]}", flush=True)
        print(f"  outputs first {a[i][2]} repeat {b[j][2]}", flush=True)
        for k in range(max(0, i - 3), min(len(a), i + 3)):
            print(f"    {k}{' <' if k == i else ''}: {a[k][0]} {[d[0] for d in a[k][1]]} -> "
                  f"{[d[0] for d in a[k][2]]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
