"""Adversarial training with the WGAN-GP step, on one device.

Port of ``sgg/cli/train.py``:

  python -m sgg_torch.cli.train --config vg1k --workdir W --steps 2000
  python -m sgg_torch.cli.train --config vit_b16 --set train.train_encoder=true \\
      --steps N --workdir W
  python -m sgg_torch.cli.train --config smoke --device cpu --steps 4 --workdir W

Each step is ``n_critic`` critic updates and one generator update
(``sgg_torch.train.step``). The data stay on the device when they fit
``data.device_resident_max_bytes`` (one gather per step); a larger store
trains on rotating device-resident subsets of at most half of it, swapped in
as a thread uploads them (``data.rotate_subsets``, at least
``data.rotation_min_steps`` steps each); else (``data.device_resident=false``)
a host iterator with prefetch draws the reference's own batches.
``data.feature_store_int8`` keeps the features on the device as int8 with a
float32 scale per region, dequantized per batch; ``data.predicate_balance``
draws each image's triple by predicate-balanced weights. Metrics go to stdout
and ``W/metrics.jsonl`` every ``train.log_every`` steps; with
``train.eval_every`` the held-out probe (``sgg_torch.train.eval_probe``) adds
recall@``train.eval_k`` and keeps ``W/best_eval.json``. The state is saved
under ``W/checkpoints/<step>/`` every ``train.checkpoint_every`` steps and at
the end (keeping ``train.max_checkpoints``), with ``W/generator.pt`` for
``sgg_torch.cli.generate`` and ``sgg_torch.cli.evaluate``; a second run on the
same workdir resumes from the latest checkpoint. ``--profile`` traces steps
10 to 14 of the run with ``torch.profiler`` into ``W/profile/`` (a trace and
a table of the top device ops with the device's idle share). SIGTERM or
SIGINT saves the state and exits. ``--debug-nans`` fails the run at the first
step whose forward or backward makes a NaN (``sgg_torch.utils.debug``).
``--set train.estimator=reinforce`` trains the generator with the
score-function estimator (``--set train.rl_entropy=C`` adds its entropy
bonus).

  python -m sgg_torch.cli.train --config pipeline_v4 --workdir W \\
      --set data.data_dir=SHARDS [--profile]

It runs on CUDA unless ``--device cpu`` is given, and raises if CUDA is not
there. Not ported yet: meshes and the distributed tiers, and grain.
``train.steps_per_dispatch`` and ``train.host_rss_exit_gb`` exist for the
reference's TPU relay and are not read.
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
from sgg_torch.data import ArrayImageTripleDataset, TripleDataset
from sgg_torch.data.pipeline import (
    RotatingDeviceIterator,
    data_store,
    make_device_train_iterator,
    make_train_iterator,
)
from sgg_torch.train.checkpoint import CheckpointManager
from sgg_torch.train.eval_probe import EvalProbe
from sgg_torch.train.metrics import MetricLogger
from sgg_torch.train.state import create_train_state, param_count
from sgg_torch.train.step import make_step_fn, refuse_unported
from sgg_torch.utils.debug import assert_super_batch, enable_nan_checks
from sgg_torch.utils.profiling import StepProfiler


def _refusal(cfg: Config) -> str | None:
    if cfg.train.eval_every > 0 and cfg.model.encoder != "precomputed":
        return f"train.eval_every with a pixels-in encoder {LATER} (ROADMAP A6)"
    if cfg.data.loader == "grain":
        return f"data.loader=grain {LATER}"
    try:
        refuse_unported(cfg)
    except (NotImplementedError, ValueError) as e:
        return str(e)
    return None


def _batches(cfg: Config, ds, device: torch.device):
    """(iterator of super-batches on ``device``, description)."""
    store, _ = data_store(ds)
    t, d = cfg.train, cfg.data
    int8 = bool(d.feature_store_int8) and hasattr(ds, "features")
    # Bytes on the device: int8 keeps one byte per value and a float32 scale
    # per region.
    nbytes = store.size + store[..., 0].size * 4 if int8 else store.nbytes
    tag = ", int8+scale" if int8 else ""
    if d.device_resident and nbytes <= d.device_resident_max_bytes:
        it = make_device_train_iterator(ds, t.batch_size, t.n_critic, seed=t.seed,
                                        device=device, int8_store=int8)
        return it, f"device-resident dataset ({nbytes / 1e6:.0f} MB on {device}{tag})"
    if d.device_resident and d.rotate_subsets and isinstance(
            ds, (TripleDataset, ArrayImageTripleDataset)):
        subset_bytes = d.device_resident_max_bytes // 2
        it = RotatingDeviceIterator(
            ds, t.batch_size, t.n_critic, seed=t.seed, subset_bytes=subset_bytes,
            min_steps_per_subset=d.rotation_min_steps, int8_store=int8, device=device,
            log=lambda m: print(m, flush=True))
        return it, (f"rotating device-resident subsets ({nbytes / 1e9:.2f} GB over "
                    f"{it.n_subsets} subsets of {len(it.subsets[0])} images, <= "
                    f"{subset_bytes / 1e9:.2f} GB each{tag})")
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
    p.add_argument("--profile", action="store_true",
                   help="trace steps 10-14 of this run with torch.profiler into workdir/profile")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail at the first step whose forward or backward makes a NaN")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = resolve_config(args)
    if args.steps is not None:
        cfg.train.total_steps = args.steps
    refusal = _refusal(cfg)
    if refusal:
        print(f"[sgg.train] {refusal}", file=sys.stderr)
        return 2

    ds, vocab = load_dataset(cfg)
    cfg.model.vocab_size = len(vocab)
    print(f"[sgg.train] config={cfg.name} images={len(ds)} vocab={len(vocab)} "
          f"device={device}", flush=True)
    if cfg.data.predicate_balance > 0 and hasattr(ds, "set_predicate_balance"):
        ds.set_predicate_balance(cfg.data.predicate_balance)
        print(f"[sgg.train] predicate-balanced triple sampling "
              f"(alpha={cfg.data.predicate_balance})", flush=True)
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
    if args.debug_nans:
        step_fn = enable_nan_checks(step_fn)
    it, how = _batches(cfg, ds, device)
    print(f"[sgg.train] {how}", flush=True)
    logger = MetricLogger(cfg.workdir)
    images_per_step = cfg.train.batch_size * (cfg.train.n_critic + 1)
    probe = None
    if cfg.train.eval_every > 0:
        probe = EvalProbe(cfg, vocab, device, log=lambda m: print(m, flush=True))
        print(f"[sgg.train] eval probe every {cfg.train.eval_every} steps "
              f"({probe.n_images} held-out images, recall@{probe.k})", flush=True)
    profiler = None
    if args.profile:
        profiler = StepProfiler(os.path.join(cfg.workdir, "profile"),
                                start_step=state.step + 10)

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
    first = state.step
    try:
        for i in range(first, t.total_steps):
            if preempted["flag"]:
                print(f"[sgg.train] preemption signal: checkpointing at step {i} and exiting",
                      flush=True)
                ckpt.save(state)
                return 0
            batch = next(it)
            if i == first:
                assert_super_batch(batch, t.n_critic, t.batch_size)
            if profiler:
                profiler.maybe_start(i)
            metrics = step_fn(state, batch)
            step = i + 1
            if profiler and profiler.maybe_stop(step):
                print(f"[sgg.train] profile trace -> {profiler.logdir}\n"
                      f"{profiler.summary['table']}", flush=True)
            if step % t.log_every == 0 or step == t.total_steps:
                logger.log(step, metrics, images_per_step=images_per_step)
            if probe and (step % t.eval_every == 0 or step == t.total_steps):
                logger.log(step, probe.run(state, step))
            if step % t.checkpoint_every == 0 or step == t.total_steps:
                ckpt.save(state)
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        it.close()
        logger.close()
        if isinstance(it, RotatingDeviceIterator):
            print(f"[sgg.train] rotation: {it.swaps} swaps over {it.n_subsets} subsets, at "
                  f"most {it.max_alive} alive, {len(it.uploads)} uploads (host gather "
                  f"{sum(u[1] for u in it.uploads):.3f} s, device copy "
                  f"{sum(u[2] for u in it.uploads):.3f} s)", flush=True)
    print(f"[sgg.train] done at step {state.step} -> {cfg.workdir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
