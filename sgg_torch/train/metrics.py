"""Training metrics to stdout and ``metrics.jsonl``, from
``sgg/train/metrics.py`` (whose clu writers the port does without).

Each :meth:`MetricLogger.log` writes one JSON line ``{"step": n, <metric>:
float, ...}`` with the reference's keys, adding throughput over the steps since
the previous log: ``images_per_sec`` = images per step × steps / seconds,
``images_per_sec_per_chip`` (per rank: over the ``chips`` ranks of a data-parallel
run) and ``steps_per_sec``. In a data-parallel run rank 0 writes the file
(``write=True``); every rank prints.
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, workdir: str, write: bool = True, chips: int = 1):
        self._jsonl = None
        if write:
            os.makedirs(workdir, exist_ok=True)
            self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a")
        self._chips = chips
        self._last_time: float | None = None
        self._last_step: int | None = None

    def log(self, step: int, metrics: dict, images_per_step: int | None = None) -> dict:
        """Write the scalars of ``metrics`` (numbers or 0-dim tensors) for
        ``step`` and print the losses, if any; returns what was written."""
        scalars = {k: float(v) for k, v in metrics.items()}
        now = time.perf_counter()
        if self._last_time is not None and images_per_step and step > self._last_step:
            dt, steps = now - self._last_time, step - self._last_step
            scalars["images_per_sec"] = images_per_step * steps / dt
            scalars["images_per_sec_per_chip"] = scalars["images_per_sec"] / self._chips
            scalars["steps_per_sec"] = steps / dt
        self._last_time, self._last_step = now, step
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()
        msg = " ".join(f"{k}={scalars[k]:.4f}" for k in ("d_loss", "g_loss", "w_dist", "gp")
                       if k in scalars)
        ips = scalars.get("images_per_sec")
        if msg or ips:
            print(f"[sgg.train] step {step}: {msg}{f' img/s={ips:.1f}' if ips else ''}",
                  flush=True)
        return scalars

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
