"""Adversarial training with the WGAN-GP step, on one device or data parallel
over ranks.

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
``train.steps_per_dispatch`` = N > 1 on the device-resident store runs N
sample-and-step iterations per dispatch (``make_fused_device_stepper``: on
CUDA N replays of one captured CUDA graph), N rounded as the reference rounds
it (:func:`dispatch_stride`); log, probe, checkpoint, SIGTERM and the
watchdogs then act at dispatch boundaries, and the profile window opens at
the first boundary at or after its step. The rotating and the host iterators,
and ``--debug-nans``, fall back to one step per dispatch, each with a line
that says so. Two watchdogs hand a run over to a supervisor, as the
reference's do: with ``train.stall_exit_sec`` > 0 a thread exits the process
with 86 when no log boundary, probe or checkpoint has landed for that long;
with ``train.host_rss_exit_gb`` > 0 the run checkpoints and returns 75 at a
log or checkpoint boundary before the last step where the process's resident
memory exceeds it. A relaunch on the same workdir resumes.
``--set train.estimator=reinforce`` trains the generator with the
score-function estimator (``--set train.rl_entropy=C`` adds its entropy
bonus).

  python -m sgg_torch.cli.train --config pipeline_v4 --workdir W \\
      --set data.data_dir=SHARDS [--profile]

pipeline_v4's cadences (log 50, checkpoint 2,000, eval 5,000) round its
N = 32 to 2, in both packages. On the card, set the three to multiples of N
and a budget that holds the whole int8 store (VG's is about 10.8 GB):

  python -m sgg_torch.cli.train --config pipeline_v4 --workdir W \\
      --set data.data_dir=SHARDS --set data.device_resident_max_bytes=12000000000 \\
      --set train.log_every=32 --set train.checkpoint_every=2048 \\
      --set train.eval_every=5120

``--config vg_full`` trains on VG's JPEGs (``data.source=vg``,
``sgg/cli/train.py:157-175``): a path-backed dataset whose decoded corpus
fits ``data.device_resident_max_bytes`` is decoded once, with the reference's
lines, and trains on the device-resident store like any in-memory image
dataset (``train.steps_per_dispatch`` included); a larger one, as full VG's
16.3 GB, trains on the host iterator, decoding each step's images in its
prefetch thread, and the run ends with the host's decode time a step:

  python -m sgg_torch.cli.train --config vg_full --workdir W --set data.data_dir=VG \\
      --encoder-ckpt ENC

Data parallel over ranks, one process each (``mesh.data`` = -1, every
rank; ``v4_32`` is the reference's multi-process config):

  torchrun --nproc_per_node 2 -m sgg_torch.cli.train --config v4_32 \\
      --workdir W --set data.data_dir=VG
  torchrun --nproc_per_node 2 -m sgg_torch.cli.train --config smoke --device cpu \\
      --workdir W

Each rank joins torchrun's group (``sgg_torch.dist.initialize_multihost``:
NCCL when each rank has a card of its own, gloo on the CPU or when ranks share
a card), takes rank 0's initial or restored state, draws B images a sub-batch
from its own slice of the images with its own seed, and averages the
gradients with the others (``sgg_torch.train.step``); ``images_per_step``
counts every rank's. Rank 0 alone writes checkpoints, ``config.json``,
``vocab.json`` and ``metrics.jsonl``; a barrier follows each save, every rank
restores. As the reference's, a multi-process run takes the host iterator
(no device-resident, rotating or materialized store), skips the in-loop
probe and runs one step per dispatch, each with the reference's line. SIGTERM
and the host-RSS handover act on every rank at the same step (the ranks agree
on them over the group). A rank whose group fails or whose collective raises
or times out ends the run non-zero; no rank trains alone.

``--set data.loader=grain`` feeds the run from the grain loader
(``sgg_torch.data.grain_pipeline``, ``sgg/cli/train.py:200-219``): records
on the host, never a device-resident store, from this rank's shard, in
``data.grain_workers`` spawned worker processes; its iterator state is saved
beside every checkpoint (the SIGTERM and RSS saves too) and a resumed run
restores it, printing the reference's line, so the run continues the exact
mid-epoch sequence. With ``train.steps_per_dispatch`` > 1 it falls back to
one step per dispatch with the reference's line:

  python -m sgg_torch.cli.train --config pipeline_v4 --workdir W \
      --set data.data_dir=SHARDS --set data.loader=grain --set data.grain_workers=2

It runs on CUDA unless ``--device cpu`` is given, and raises if CUDA is not
there. A resumed run's host iterator continues the draws at the restored
step. Not ported yet: TP, FSDP, sequence, pipeline and expert parallelism
(ROADMAP A8b–A8e).
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import sys
import threading
import time

import torch
import torch.distributed as dist

from sgg_torch.cli.common import (
    add_config_args,
    load_dataset,
    resolve_config,
    resolve_device,
)
from sgg_torch.config import Config
from sgg_torch.convert_flax import encoder_flax_to_state_dict, load_params_npz
from sgg_torch.data import ArrayImageTripleDataset, ImageTripleDataset, TripleDataset
from sgg_torch.data.grain_pipeline import GrainTrainIterator, make_grain_iterator
from sgg_torch.dist import (
    host_local_to_global,
    initialize_multihost,
    mesh_from_config,
    process_shard_info,
    replicated_sharding,
)
from sgg_torch.data.pipeline import (
    RotatingDeviceIterator,
    data_store,
    make_device_train_iterator,
    make_fused_device_stepper,
    make_train_iterator,
)
from sgg_torch.train.checkpoint import CheckpointManager
from sgg_torch.train.eval_probe import EvalProbe
from sgg_torch.train.metrics import MetricLogger
from sgg_torch.train.state import create_train_state, param_count
from sgg_torch.train.step import make_step_fn, refuse_unported
from sgg_torch.utils.debug import assert_super_batch, enable_nan_checks, host_rss_gb
from sgg_torch.utils.profiling import StepProfiler

STALL_POLL_SEC = 30.0  # how often the stall watchdog looks


def _refusal(cfg: Config) -> str | None:
    try:
        refuse_unported(cfg)
    except (NotImplementedError, ValueError) as e:
        return str(e)
    return None


def data_route(cfg: Config, ds, processes: int = 1) -> tuple[str, int, bool]:
    """Which iterator feeds the run: ``device`` (the whole store on the
    device), ``rotating``, ``host`` or ``grain`` (``data.loader=grain``); with
    the store's bytes on the device and whether it is int8. Both device
    stores are the reference's single-process routes: ``processes`` > 1
    takes the host iterator."""
    d = cfg.data
    if d.loader == "grain":  # records on the host, never the device-resident store
        return "grain", 0, False
    if isinstance(ds, ImageTripleDataset):  # JPEGs decoded per step on the host
        return "host", ds.est_bytes, False
    store, _ = data_store(ds)
    int8 = bool(d.feature_store_int8) and hasattr(ds, "features")
    # Bytes on the device: int8 keeps one byte per value and a float32 scale
    # per region.
    nbytes = store.size + store[..., 0].size * 4 if int8 else store.nbytes
    if processes > 1:
        return "host", nbytes, False
    if d.device_resident and nbytes <= d.device_resident_max_bytes:
        return "device", nbytes, int8
    if d.device_resident and d.rotate_subsets and isinstance(
            ds, (TripleDataset, ArrayImageTripleDataset)):
        return "rotating", nbytes, int8
    return "host", nbytes, int8


def dispatch_stride(cfg: Config, route: str, resume_step: int,
                    debug_nans: bool = False) -> tuple[int, list[str]]:
    """(steps per dispatch, the lines to print), the reference's rule: N =
    ``train.steps_per_dispatch`` runs fused only on the device-resident store
    (``route`` as :func:`data_route` gives it), else the run falls back to one
    step per dispatch; N is rounded to the gcd of N, the log, checkpoint and
    eval cadences, the total steps and the resume step, so every boundary
    falls between two dispatches. ``--debug-nans`` checks every step, so it
    falls back too (the reference has no such case)."""
    t = cfg.train
    stride = max(1, int(t.steps_per_dispatch))
    if stride == 1:
        return 1, []
    if route != "device":
        return 1, ["[sgg.train] steps_per_dispatch needs the single-process device-resident "
                   "data path — falling back to per-step dispatch"]
    if debug_nans:
        return 1, ["[sgg.train] steps_per_dispatch with --debug-nans, which checks every "
                   "step — falling back to per-step dispatch"]
    for v in (t.log_every, t.checkpoint_every, t.eval_every or stride, t.total_steps,
              resume_step or stride):
        stride = math.gcd(stride, v)
    lines = []
    if stride != t.steps_per_dispatch:
        lines.append(f"[sgg.train] steps_per_dispatch rounded to {stride} (gcd of "
                     "log/checkpoint/eval cadences + resume step)")
    if stride > 1:
        lines.append(f"[sgg.train] fused dispatch: {stride} steps/program")
    return stride, lines


def _batches(cfg: Config, ds, device: torch.device, route: str, nbytes: int, int8: bool,
             shard=None, resume_step: int = 0):
    """(iterator of super-batches on ``device``, description). The host
    iterator draws from ``shard``'s slice of the images (a
    ``ProcessShard``) and continues its draws at ``resume_step``; the grain
    loader reads ``shard``'s records and is set to its saved state by the
    caller."""
    t, d = cfg.train, cfg.data
    tag = ", int8+scale" if int8 else ""
    if route == "grain":
        it = make_grain_iterator(ds, t.batch_size, t.n_critic, seed=t.seed,
                                 process_index=shard.index if shard else 0,
                                 process_count=shard.count if shard else 1,
                                 num_workers=d.grain_workers, device=device)
        return it, f"grain loader (workers={d.grain_workers})"
    if route == "device":
        it = make_device_train_iterator(ds, t.batch_size, t.n_critic, seed=t.seed,
                                        device=device, int8_store=int8)
        return it, _resident(nbytes, device, tag)
    if route == "rotating":
        subset_bytes = d.device_resident_max_bytes // 2
        it = RotatingDeviceIterator(
            ds, t.batch_size, t.n_critic, seed=t.seed, subset_bytes=subset_bytes,
            min_steps_per_subset=d.rotation_min_steps, int8_store=int8, device=device,
            log=lambda m: print(m, flush=True))
        return it, (f"rotating device-resident subsets ({nbytes / 1e9:.2f} GB over "
                    f"{it.n_subsets} subsets of {len(it.subsets[0])} images, <= "
                    f"{subset_bytes / 1e9:.2f} GB each{tag})")
    host = make_train_iterator(ds, t.batch_size, t.n_critic, seed=t.seed,
                               process_index=shard.index if shard else 0,
                               process_count=shard.count if shard else 1, skip=resume_step)

    def to_device():
        try:
            for b in host:
                yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        finally:
            host.close()

    if isinstance(ds, ImageTripleDataset):
        return to_device(), (f"host iterator with prefetch, decoding "
                             f"{t.batch_size * (t.n_critic + 1)} JPEGs a step ({nbytes / 1e9:.2f} "
                             f"GB decoded over the {d.device_resident_max_bytes / 1e9:.2f} GB "
                             "budget)")
    how = "host iterator with prefetch"
    if shard is not None and shard.count > 1:
        n = len(ds.process_slice(shard.index, shard.count))
        how += f" (process {shard.index} of {shard.count}: {n} of {len(ds)} images)"
    return to_device(), how


def _resident(nbytes: int, device: torch.device, tag: str) -> str:
    return f"device-resident dataset ({nbytes / 1e6:.0f} MB on {device}{tag})"


class StallWatchdog:
    """The reference's stall watchdog: with ``limit_s`` > 0 a daemon thread
    looks every ``STALL_POLL_SEC`` and exits the process with 86 when nothing
    has called :meth:`stamp` for ``limit_s`` seconds. The loop's own thread
    may be stuck inside a hung device call, so only another thread can see
    the stall; a supervisor relaunches into the resume. :meth:`stop` ends
    the thread. ``tag`` prefixes the stall line (``sgg.pretrain`` uses it
    too)."""

    def __init__(self, limit_s: float, tag: str = "sgg.train"):
        self.limit_s, self.tag = limit_s, tag
        self.last = time.time()
        self._stop = threading.Event()
        self.thread = None
        if limit_s > 0:
            self.thread = threading.Thread(target=self._watch, daemon=True,
                                           name="sgg-torch-stall-watchdog")
            self.thread.start()

    def stamp(self) -> None:
        self.last = time.time()

    def _watch(self) -> None:
        while not self._stop.wait(STALL_POLL_SEC):
            dt = time.time() - self.last
            if dt > self.limit_s:
                print(f"[{self.tag}] STALL: no log readback for {dt:.0f}s (hung device "
                      "call?) — exit 86 for supervised relaunch", flush=True)
                os._exit(86)

    def stop(self) -> None:
        self._stop.set()
        if self.thread is not None:
            self.thread.join(timeout=10)


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
    device = initialize_multihost(device, log=lambda m: print(m, flush=True))
    shard = process_shard_info()
    try:
        mesh = mesh_from_config(cfg.mesh, device)
    except ValueError as e:  # a data axis that the ranks do not fill
        print(f"[sgg.train] {e}", file=sys.stderr)
        return 2
    group, lead = mesh.group, shard.index == 0

    ds, vocab = load_dataset(cfg)
    cfg.model.vocab_size = len(vocab)
    print(f"[sgg.train] config={cfg.name} images={len(ds)} vocab={len(vocab)} "
          f"devices={mesh.data} processes={shard.count} device={device}", flush=True)
    if cfg.data.predicate_balance > 0 and hasattr(ds, "set_predicate_balance"):
        ds.set_predicate_balance(cfg.data.predicate_balance)
        print(f"[sgg.train] predicate-balanced triple sampling "
              f"(alpha={cfg.data.predicate_balance})", flush=True)
    # A path-backed image dataset whose decoded corpus fits the budget is
    # decoded once and trains on the device-resident store.
    if (cfg.data.device_resident and cfg.data.loader != "grain"
            and isinstance(ds, ImageTripleDataset) and shard.count == 1
            and ds.est_bytes <= cfg.data.device_resident_max_bytes):
        print(f"[sgg.train] materializing {len(ds)} images "
              f"({ds.est_bytes / 1e9:.1f} GB uint8) for device residency", flush=True)
        ds = ds.materialize(log=lambda m: print(m, flush=True))
    ckpt = CheckpointManager(cfg.workdir, cfg if lead else None,
                             max_to_keep=cfg.train.max_checkpoints)
    if lead:
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
    resumed = ckpt.restore(state) is not None
    if resumed:
        print(f"[sgg.train] resumed from step {state.step}", flush=True)
    # Every rank takes rank 0's state (a broadcast; no-op in one process).
    host_local_to_global(state, replicated_sharding(mesh))
    enc_n = f" E={param_count(state.encoder):,}" if state.encoder is not None else ""
    print(f"[sgg.train] params: G={param_count(state.generator):,} "
          f"D={param_count(state.critic):,}{enc_n}", flush=True)

    step_fn = (make_step_fn(cfg, step_mask=vocab.step_mask()) if group is None
               else make_step_fn(cfg, step_mask=vocab.step_mask(), group=group))
    if args.debug_nans:
        step_fn = enable_nan_checks(step_fn)
    t = cfg.train
    route, nbytes, int8 = data_route(cfg, ds, shard.count)
    stride, notes = dispatch_stride(cfg, route, state.step, debug_nans=args.debug_nans)
    it = stepper = None
    if stride > 1:
        stepper = make_fused_device_stepper(ds, step_fn, t.batch_size, t.n_critic, stride,
                                            seed=t.seed, device=device, int8_store=int8)
        how = _resident(nbytes, device, ", int8+scale" if int8 else "")
    else:
        it, how = _batches(cfg, ds, device, route, nbytes, int8, shard, state.step)
    grain_it = it if isinstance(it, GrainTrainIterator) else None
    # Every rank reads rank 0's sidecar: the state is the same on each.
    data_state = ckpt.restore_data_state() if grain_it is not None and resumed else None
    if data_state is not None:
        grain_it.set_state(data_state)
        how = "grain iterator state restored (exact mid-epoch resume)"
    print(f"[sgg.train] {how}", flush=True)
    for line in notes:
        print(line, flush=True)
    logger = MetricLogger(cfg.workdir, write=lead, chips=shard.count)
    # Images a step over every process, as the reference counts them.
    images_per_step = t.batch_size * (t.n_critic + 1) * shard.count
    probe = None
    if t.eval_every > 0 and shard.count > 1:
        print("[sgg.train] train.eval_every: in-loop probe is single-process only — "
              "skipping (evaluate offline)", flush=True)
    elif t.eval_every > 0:
        probe = EvalProbe(cfg, vocab, device, log=lambda m: print(m, flush=True))
        print(f"[sgg.train] eval probe every {t.eval_every} steps "
              f"({probe.n_images} held-out images, recall@{probe.k})", flush=True)
    profiler = None
    if args.profile:
        # Each rank traces its own process (rank r > 0 into profile_rank<r>).
        profiler = StepProfiler(os.path.join(cfg.workdir, "profile" if lead else
                                             f"profile_rank{shard.index}"),
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

    def save() -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if lead:
            ckpt.save(state, data_state=None if grain_it is None else grain_it.get_state())
        if group is not None:
            dist.barrier(group)

    def any_rank(flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (this rank's own in one
        process), so that every rank acts at the same step."""
        if group is None:
            return flag
        x = torch.tensor([float(flag)], device=device)
        dist.all_reduce(x, group=group)
        return bool(x.item() > 0)

    # Progress is stamped at every log boundary, probe and checkpoint.
    watchdog = StallWatchdog(t.stall_exit_sec)
    first = state.step
    try:
        for i in range(first, t.total_steps, stride):
            if any_rank(preempted["flag"]):
                print(f"[sgg.train] preemption signal: checkpointing at step {i} and exiting",
                      flush=True)
                save()
                return 0
            if profiler:
                profiler.maybe_start(i)
            if stepper is not None:
                metrics = stepper(state, i - first)  # sample steps count from this launch
            else:
                batch = next(it)
                if i == first:
                    assert_super_batch(batch, t.n_critic, t.batch_size)
                metrics = step_fn(state, batch)
            step = i + stride
            if profiler and profiler.maybe_stop(step):
                print(f"[sgg.train] profile trace -> {profiler.logdir}\n"
                      f"{profiler.summary['table']}", flush=True)
            if step % t.log_every == 0 or step == t.total_steps:
                logger.log(step, metrics, images_per_step=images_per_step)
                watchdog.stamp()
            if probe and (step % t.eval_every == 0 or step == t.total_steps):
                logger.log(step, probe.run(state, step))
                watchdog.stamp()
            at_ckpt = step % t.checkpoint_every == 0 or step == t.total_steps
            if at_ckpt:
                save()
                watchdog.stamp()
            # The host-RSS handover, at every log or checkpoint boundary
            # before the last step.
            limit = t.host_rss_exit_gb
            if limit > 0 and step < t.total_steps and (at_ckpt or step % t.log_every == 0):
                rss = host_rss_gb()
                if any_rank(rss > limit):
                    if not at_ckpt:
                        save()
                    print(f"[sgg.train] host RSS {rss:.1f} GB > {limit:.0f} GB limit — "
                          f"checkpointed at step {step}, exiting 75 for supervised relaunch",
                          flush=True)
                    return 75
    finally:
        watchdog.stop()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        if it is not None:
            it.close()
        logger.close()
        if isinstance(it, RotatingDeviceIterator):
            print(f"[sgg.train] rotation: {it.swaps} swaps over {it.n_subsets} subsets, at "
                  f"most {it.max_alive} alive, {len(it.uploads)} uploads (host gather "
                  f"{sum(u[1] for u in it.uploads):.3f} s, device copy "
                  f"{sum(u[2] for u in it.uploads):.3f} s)", flush=True)
        # The grain loader counts what its workers decoded.
        dec = grain_it or ds
        if isinstance(ds, ImageTripleDataset) and dec.decoded_images:
            per_step = dec.decode_seconds * images_per_step / dec.decoded_images
            print(f"[sgg.train] host decode: {dec.decoded_images} images in "
                  f"{dec.decode_seconds:.3f} s ({per_step:.4f} s per step of {images_per_step} "
                  "images)", flush=True)
        if grain_it is not None and grain_it.batches:
            print(f"[sgg.train] grain loader: {grain_it.batches} super-batches, "
                  f"{grain_it.wait_seconds:.3f} s waiting for them", flush=True)
        if stepper is not None and stepper.capture_s is not None:
            print(f"[sgg.train] CUDA graph of one step: captured in {stepper.capture_s:.3f} s, "
                  f"{stepper.capture_bytes / 1e9:.3f} GB reserved", flush=True)
    print(f"[sgg.train] done at step {state.step} -> {cfg.workdir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
