"""Tracing, from ``sgg/utils/profiling.py``: ``profile_trace`` (a device and
host trace of a block), ``annotate`` (a named region in the trace) and a
``torch.profiler`` window over train steps.

The train step wraps its parts in the reference's regions (``REGIONS``):
``sample_fakes_batched``, each ``critic_update``, the ``encoder``'s forward
inside a critic update and the ``generator_update``. ``region_split`` reads
them back from a trace: each region's calls, host ms and the device ms of the
kernels and copies launched inside it.

``sgg_torch.cli.train --profile`` traces steps ``start`` to ``start + 5`` (the
reference's window: its first step is the run's step 10) into
``W/profile/``: ``trace.json`` (a Chrome trace, open in Perfetto or
chrome://tracing) and ``top_ops.txt``, a table of the kernels and copies
with the most time on the device (of the ops with the most inclusive CPU time
when nothing ran on a device), with the window's wall seconds, the device's
busy seconds (the union of its kernels' and copies' intervals), its idle
share, 1 − busy / wall, the host's waits for the device: the CUDA runtime
calls of ``SYNC_CALLS`` in the window (a ``.item()``, a blocking copy, a
synchronize; the window's own closing synchronize among them), and the
regions' split.
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import json
import os
import shutil
import time

import torch

TOP_OPS = 25
REGIONS = ("sample_fakes_batched", "critic_update", "encoder", "generator_update")
GRAPH_LAUNCH = "cudaGraphLaunch"


DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def trace_events(path: str) -> list[tuple[str, str, float, float]]:
    """(name, category, start µs, duration µs) of every complete event in a
    Chrome trace that ``export_chrome_trace`` wrote. Device work is a
    category of ``DEVICE_WORK``; the annotations the profiler copies onto
    the device's timeline (``gpu_user_annotation``) span such work and are
    not counted as it. (The trace's categories, not the profiler's raw
    events, whose fields differ between torch versions; building the
    profiler's event tree instead costs tens of µs an event.)"""
    with open(path) as f:
        trace = json.load(f)
    return [(e.get("name", ""), e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "ts" in e]


def sync_sites(path: str) -> dict[str, int]:
    """Where the host waited for the device in a Chrome trace that
    ``export_chrome_trace`` wrote: for each runtime call of ``SYNC_CALLS``,
    the chain of ``cpu_op`` events that enclose it on its thread, outermost
    first, as one string; and how many calls each chain made."""
    with open(path) as f:
        trace = json.load(f)
    ops: dict = {}
    syncs = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
        if e.get("cat") == "cpu_op":
            ops.setdefault(e.get("tid"), []).append(span)
        elif e.get("cat") == "cuda_runtime" and e.get("name") in SYNC_CALLS:
            syncs.append((e.get("tid"), span))
    sites: dict[str, int] = {}
    for tid, (t0, t1, name) in syncs:
        around = sorted((a for a in ops.get(tid, []) if a[0] <= t0 and t1 <= a[1]),
                        key=lambda a: (a[0], -a[1]))
        key = " > ".join([a[2] for a in around] + [name])
        sites[key] = sites.get(key, 0) + 1
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def region_split(path: str, names=REGIONS) -> dict:
    """The regions of a Chrome trace that ``export_chrome_trace`` wrote.

    ``regions``: for each name of ``names`` that the trace holds on the host
    (a ``record_function`` range, ``annotate``), its ``calls``, ``host_ms``
    (the ranges' summed length) and, when the trace holds device work,
    ``device_ms`` (the summed length of the kernels and copies launched
    inside one of its ranges) and ``kernels`` (their launches by name); else
    those two are None. A kernel belongs to a region when the host call that
    launched it (the ``cuda_runtime`` or ``cuda_driver`` event with its
    correlation id, on any thread: the autograd engine launches a backward
    from its own device thread while the calling thread waits inside the
    region) lies inside one of the region's ranges. Regions nest, and each counts what lies inside
    it: ``encoder``'s time is also ``critic_update``'s.
    ``graph_launches``: the ``cudaGraphLaunch`` calls; a replayed CUDA graph's
    kernels have no host range, so with any of them ``regions`` is None.
    ``unattributed``: device events whose launch the trace does not hold."""
    with open(path) as f:
        trace = json.load(f)
    spans: dict[str, list] = {}
    launch_at, device, graphs = {}, [], 0
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat, name, t0 = e.get("cat", ""), e.get("name", ""), float(e["ts"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_WORK:
            device.append((name, corr, float(e.get("dur", 0.0))))
        elif cat in ("user_annotation", "cpu_op") and name in names:
            spans.setdefault(name, []).append((t0, t0 + float(e.get("dur", 0.0))))
        elif cat in ("cuda_runtime", "cuda_driver"):
            graphs += name == GRAPH_LAUNCH
            if corr is not None:
                launch_at[corr] = t0
    on_device = bool(device)
    out = {"graph_launches": graphs, "on_device": on_device, "unattributed": 0,
           "regions": None}
    if graphs:
        return out
    ranges = {name: sorted(spans[name]) for name in names if name in spans}
    regions = {name: {"calls": len(rs), "host_ms": sum(b - a for a, b in rs) / 1e3,
                      "device_ms": 0.0 if on_device else None,
                      "kernels": {} if on_device else None}
               for name, rs in ranges.items()}
    for kname, corr, dur in device:
        t = launch_at.get(corr)
        if t is None:
            out["unattributed"] += 1
            continue
        for name, rs in ranges.items():
            i = bisect.bisect_right(rs, (t, float("inf"))) - 1
            if i >= 0 and t <= rs[i][1]:
                r = regions[name]
                r["device_ms"] += dur / 1e3
                r["kernels"][kname] = r["kernels"].get(kname, 0) + 1
    out["regions"] = regions
    return out


def region_lines(split: dict) -> list[str]:
    """``region_split``'s numbers as the lines of ``top_ops.txt``."""
    if split["graph_launches"]:
        return [f"regions: the window replays a CUDA graph ({split['graph_launches']} "
                f"{GRAPH_LAUNCH} calls), whose kernels have no host range: no region split"]
    regions = split["regions"]
    if not regions:
        return ["regions: none traced"]
    lines = ["regions (inclusive: encoder also counts in critic_update; device ms of the "
             "kernels and copies launched inside"
             + ("" if split["on_device"] else "; no device kernel traced: not measured") + "):",
             f"{'calls':>7} {'host ms':>11} {'device ms':>12}  region"]
    for name, r in regions.items():
        dev = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
        lines.append(f"{r['calls']:7d} {r['host_ms']:11.3f} {dev:>12}  {name}")
    if split["unattributed"]:
        lines.append(f"device events without their launch in the trace: {split['unattributed']}")
    return lines


def _cuda_on() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if _cuda_on():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync() -> None:
    if _cuda_on():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(logdir: str, create_perfetto: bool = False):
    """Trace the enclosed block, host and (when a CUDA device is initialized)
    device, into ``logdir/trace.json``, a Chrome trace that Perfetto opens;
    with ``create_perfetto`` also its gzipped copy, ``perfetto_trace.json.gz``.
    The device is synchronized at both ends. Yields ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    _sync()
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    try:
        yield logdir
    finally:
        _sync()
        prof.__exit__(None, None, None)
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        if create_perfetto:
            with open(path, "rb") as src, \
                    gzip.open(os.path.join(logdir, "perfetto_trace.json.gz"), "wb") as dst:
                shutil.copyfileobj(src, dst)


def annotate(name: str):
    """A named region in the trace: ``with annotate('critic_update'):``."""
    return torch.profiler.record_function(name)


def busy_time(spans) -> float:
    """Length of the union of the (start, duration) spans."""
    busy, end = 0.0, None
    for a, d in sorted(spans):
        b = a + d
        if end is None or a > end:
            busy += d
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


class StepProfiler:
    """Trace a window of train steps from inside the loop: ``maybe_start(i)``
    before step i runs, ``maybe_stop(n)`` after the steps up to n have run;
    the device is synchronized at both ends. The window opens at the first
    call of ``maybe_start`` at or after ``start_step`` and closes at the
    first ``maybe_stop`` at or after ``start_step + num_steps``, so a loop
    that runs several steps per call (``train.steps_per_dispatch``) traces
    whole calls; with one step per call it is [start_step, start_step +
    num_steps). (The reference opens only at ``start_step`` itself, so with a
    stride that does not reach it its window never opens.)"""

    def __init__(self, logdir: str, start_step: int, num_steps: int = 5):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self._opened = False
        self._first = start_step
        self._t0 = 0.0
        self.summary: dict | None = None

    def maybe_start(self, step: int) -> None:
        if not self._opened and step >= self.start_step:
            self._opened, self._first = True, step
            os.makedirs(self.logdir, exist_ok=True)
            _sync()
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
            self._t0 = time.perf_counter()

    def maybe_stop(self, step: int) -> bool:
        if self._prof is None or step < self.stop_step:
            return False
        _sync()
        wall = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        path = os.path.join(self.logdir, "trace.json")
        prof.export_chrome_trace(path)
        self.summary = self._write_table(trace_events(path), wall, step, region_split(path))
        return True

    def _write_table(self, events, wall: float, step: int, split: dict) -> dict:
        dev = [(n, t0, d) for n, cat, t0, d in events if cat in DEVICE_WORK]
        on_device = bool(dev)
        rows = dev if on_device else [(n, t0, d) for n, cat, t0, d in events if cat == "cpu_op"]
        per_op: dict[str, list] = {}
        for name, _, d in rows:
            acc = per_op.setdefault(name, [0.0, 0])
            acc[0] += d
            acc[1] += 1
        total = sum(v[0] for v in per_op.values()) or 1.0
        busy = busy_time([(t0, d) for _, t0, d in dev]) / 1e6
        idle = 1.0 - busy / wall if on_device else None
        syncs = sum(1 for n, cat, _, _ in events if cat == "cuda_runtime" and n in SYNC_CALLS)
        steps = step - self._first
        what = "device time (kernels and copies)" if on_device else "CPU time, inclusive"
        lines = [f"steps {self._first}-{step - 1} ({steps} steps), wall {wall:.4f} s "
                 f"({wall / steps:.4f} s/step)",
                 (f"device busy {busy:.4f} s over {len(dev)} kernels and copies, idle share "
                  f"{idle:.4f}" if on_device else "no device kernel traced: device busy and "
                  "idle share not measured"),
                 f"top ops by {what}:",
                 f"{'ms':>10} {'share':>7} {'calls':>7}  op"]
        if on_device:
            lines.insert(2, f"host syncs {syncs} ({syncs / steps:.2f} a step)")
        top = []
        for name, (us, calls) in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]:
            lines.append(f"{us / 1e3:10.3f} {us / total:7.3f} {calls:7d}  {name}")
            top.append({"op": name, "ms": us / 1e3, "share": us / total, "calls": calls})
        lines += region_lines(split)
        with open(os.path.join(self.logdir, "top_ops.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return {"wall_s": wall, "steps": steps, "device_busy_s": busy if on_device else None,
                "idle_share": idle, "syncs": syncs if on_device else None,
                "events": len(events), "top": top, "regions": split["regions"],
                "graph_launches": split["graph_launches"], "table": "\n".join(lines)}
