"""A ``torch.profiler`` window over train steps, from ``sgg/utils/profiling.py``.

``sgg_torch.cli.train --profile`` traces steps ``start`` to ``start + 5`` (the
reference's window: its first step is the run's step 10) into
``W/profile/``: ``trace.json`` (a Chrome trace, open in Perfetto or
chrome://tracing) and ``top_ops.txt``, a table of the kernels and copies
with the most time on the device (of the ops with the most inclusive CPU time
when nothing ran on a device), with the window's wall seconds, the device's
busy seconds (the union of its kernels' and copies' intervals), its idle
share, 1 − busy / wall, and the host's waits for the device: the CUDA runtime
calls of ``SYNC_CALLS`` in the window (a ``.item()``, a blocking copy, a
synchronize; the window's own closing synchronize among them).
"""

from __future__ import annotations

import json
import os
import time

import torch

TOP_OPS = 25


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

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def maybe_start(self, step: int) -> None:
        if not self._opened and step >= self.start_step:
            self._opened, self._first = True, step
            os.makedirs(self.logdir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._t0 = time.perf_counter()

    def maybe_stop(self, step: int) -> bool:
        if self._prof is None or step < self.stop_step:
            return False
        self._sync()
        wall = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        path = os.path.join(self.logdir, "trace.json")
        prof.export_chrome_trace(path)
        self.summary = self._write_table(trace_events(path), wall, step)
        return True

    def _write_table(self, events, wall: float, step: int) -> dict:
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
        with open(os.path.join(self.logdir, "top_ops.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return {"wall_s": wall, "steps": steps, "device_busy_s": busy if on_device else None,
                "idle_share": idle, "syncs": syncs if on_device else None,
                "events": len(events), "top": top,
                "table": "\n".join(lines)}
