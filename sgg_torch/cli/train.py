"""Adversarial training with the WGAN-GP step, on one device.

Port of ``sgg/cli/train.py``:

  python -m sgg_torch.cli.train --config vg1k --workdir W --steps 2000
  python -m sgg_torch.cli.train --config vit_b16 --set train.train_encoder=true \\
      --steps N --workdir W
  python -m sgg_torch.cli.train --config smoke --device cpu --steps 4 --workdir W

Each step is ``n_critic`` critic updates and one generator update
(``sgg_torch.train.step``). The data stay on the device when they fit
``data.device_resident_max_bytes`` (one gather per step), else a host
iterator with prefetch draws the reference's own batches. Metrics go to stdout
and ``W/metrics.jsonl`` every ``train.log_every`` steps; the state is saved
under ``W/checkpoints/<step>/`` every ``train.checkpoint_every`` steps and at
the end (keeping ``train.max_checkpoints``), with ``W/generator.pt`` for
``sgg_torch.cli.generate``; a second run on the same workdir resumes from the
latest checkpoint. SIGTERM or SIGINT saves the state and exits.

It runs on CUDA unless ``--device cpu`` is given, and raises if CUDA is not
there. Not ported yet: ``--profile``, ``--debug-nans``, ``train.eval_every``,
meshes and the distributed tiers, REINFORCE, predicate balance, the int8
feature store, rotating subsets and grain. ``train.steps_per_dispatch``
exists for the reference's TPU relay and is not read.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

import torch

from sgg_torch.cli.common import (
    LATER,
    add_config_args,
    load_dataset,
    resolve_config,
    resolve_device,
)
from sgg_torch.config import Config
from sgg_torch.convert_flax import encoder_flax_to_state_dict, load_params_npz
from sgg_torch.data.pipeline import data_store, make_device_train_iterator, make_train_iterator
from sgg_torch.train.checkpoint import CheckpointManager
from sgg_torch.train.metrics import MetricLogger
from sgg_torch.train.state import create_train_state, param_count
from sgg_torch.train.step import make_step_fn, refuse_unported


def _refusal(args, cfg: Config) -> str | None:
    if args.profile:
        return f"--profile {LATER}"
    if args.debug_nans:
        return f"--debug-nans {LATER}"
    d = cfg.data
    if cfg.train.eval_every > 0:
        return f"train.eval_every (the in-loop eval probe) {LATER} (ROADMAP A6)"
    if d.predicate_balance > 0:
        return f"data.predicate_balance {LATER}"
    if d.feature_store_int8:
        return f"data.feature_store_int8 (the int8 feature store) {LATER}"
    if d.loader == "grain":
        return f"data.loader=grain {LATER}"
    try:
        refuse_unported(cfg)
    except (NotImplementedError, ValueError) as e:
        return str(e)
    return None


def _batches(cfg: Config, ds, device: torch.device):
    """(iterator of super-batches on ``device``, description)."""
    store, _ = data_store(ds)
    t = cfg.train
    if cfg.data.device_resident and store.nbytes <= cfg.data.device_resident_max_bytes:
        it = make_device_train_iterator(ds, t.batch_size, t.n_critic, seed=t.seed, device=device)
        return it, f"device-resident dataset ({store.nbytes / 1e6:.0f} MB on {device})"
    if cfg.data.device_resident and cfg.data.rotate_subsets:
        raise NotImplementedError(
            f"rotating device-resident subsets (a store of {store.nbytes / 1e9:.1f} GB over "
            f"data.device_resident_max_bytes) {LATER}; set data.device_resident=false for the "
            "host iterator")
    host = make_train_iterator(ds, t.batch_size, t.n_critic, seed=t.seed)

    def to_device():
        try:
            for b in host:
                yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        finally:
            host.close()

    return to_device(), "host iterator with prefetch"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(p)
    p.add_argument("--steps", type=int, default=None, help="override train.total_steps")
    p.add_argument("--encoder-ckpt", default=None,
                   help="initialize the backbone from an encoder_params.npz (or a directory "
                        "holding one) instead of random weights; pixels-in configs only")
    p.add_argument("--profile", action="store_true", help="not ported yet")
    p.add_argument("--debug-nans", action="store_true", help="not ported yet")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = resolve_config(args)
    if args.steps is not None:
        cfg.train.total_steps = args.steps
    refusal = _refusal(args, cfg)
    if refusal:
        print(f"[sgg.train] {refusal}", file=sys.stderr)
        return 2

    ds, vocab = load_dataset(cfg)
    cfg.model.vocab_size = len(vocab)
    print(f"[sgg.train] config={cfg.name} images={len(ds)} vocab={len(vocab)} "
          f"device={device}", flush=True)
    ckpt = CheckpointManager(cfg.workdir, cfg, max_to_keep=cfg.train.max_checkpoints)
    ckpt.save_vocab(vocab)

    enc_params = None
    if args.encoder_ckpt:
        if cfg.model.encoder == "precomputed":
            print("[sgg.train] --encoder-ckpt requires an end-to-end encoder config "
                  "(model.encoder != 'precomputed')", file=sys.stderr)
            return 1
        path = args.encoder_ckpt
        if os.path.isdir(path):
            path = os.path.join(path, "encoder_params.npz")
        enc_params = encoder_flax_to_state_dict(load_params_npz(path))
        print(f"[sgg.train] encoder weights <- {path}", flush=True)

    state = create_train_state(cfg, cfg.train.seed, enc_params=enc_params, device=device)
    if ckpt.restore(state) is not None:
        print(f"[sgg.train] resumed from step {state.step}", flush=True)
    enc_n = f" E={param_count(state.encoder):,}" if state.encoder is not None else ""
    print(f"[sgg.train] params: G={param_count(state.generator):,} "
          f"D={param_count(state.critic):,}{enc_n}", flush=True)

    step_fn = make_step_fn(cfg, step_mask=vocab.step_mask())
    it, how = _batches(cfg, ds, device)
    print(f"[sgg.train] {how}", flush=True)
    logger = MetricLogger(cfg.workdir)
    images_per_step = cfg.train.batch_size * (cfg.train.n_critic + 1)

    # SIGTERM/SIGINT save the current state before exiting; the handlers are
    # put back however the loop ends.
    preempted = {"flag": False}
    prev_handlers = {}

    def _on_term(signum, frame):
        preempted["flag"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_term)
        except ValueError:
            pass  # not the main thread

    t = cfg.train
    try:
        for i in range(state.step, t.total_steps):
            if preempted["flag"]:
                print(f"[sgg.train] preemption signal: checkpointing at step {i} and exiting",
                      flush=True)
                ckpt.save(state)
                return 0
            metrics = step_fn(state, next(it))
            step = i + 1
            if step % t.log_every == 0 or step == t.total_steps:
                logger.log(step, metrics, images_per_step=images_per_step)
            if step % t.checkpoint_every == 0 or step == t.total_steps:
                ckpt.save(state)
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        it.close()
        logger.close()
    print(f"[sgg.train] done at step {state.step} -> {cfg.workdir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
