"""Numerics checks and the super-batch contract, from ``sgg/utils/debug.py``.

The reference's ``--debug-nans`` sets ``jax_debug_nans``, so the compiled
step fails at the first operation that makes a NaN. Eager torch has no such
switch; :func:`enable_nan_checks` wraps the step instead: its backward passes
run under anomaly detection with NaN checks (a backward function that returns
a NaN raises), and every loss and metric it returns must be finite. Either
failure raises ``FloatingPointError`` naming the step.
"""

from __future__ import annotations

from typing import Callable

import torch


def enable_nan_checks(step_fn: Callable[..., dict]) -> Callable[..., dict]:
    """``step_fn(state, batch, ...) → metrics``, failing at the first step
    whose forward or backward makes a NaN (``FloatingPointError``)."""

    def checked(state, batch, *args, **kwargs):
        step = state.step + 1
        try:
            with torch.autograd.set_detect_anomaly(True, check_nan=True):
                metrics = step_fn(state, batch, *args, **kwargs)
        except RuntimeError as e:
            if "returned nan values" not in str(e):
                raise
            raise FloatingPointError(f"step {step}: the backward made a NaN: {e}") from e
        for name, value in metrics.items():
            if not bool(torch.isfinite(torch.as_tensor(value)).all()):
                raise FloatingPointError(f"step {step}: {name} = {float(value)} is not finite")
        return metrics

    return checked


def _rank(x, want: int, what: str) -> None:
    if x.ndim != want:
        raise AssertionError(f"assert_rank failed: {what} has rank {x.ndim} (shape "
                             f"{tuple(x.shape)}) but expected {want}.")


def _axis(x, axis: int, want: int, what: str) -> None:
    if x.shape[axis] != want:
        raise AssertionError(f"assert_axis_dimension failed: expected {what} to have "
                             f"dimension equal to '{want}' on axis '{axis}' but got "
                             f"'{x.shape[axis]}' instead.")


def _type(x, want: str, what: str) -> None:
    got = str(x.dtype).removeprefix("torch.")  # numpy arrays and tensors alike
    if got != want:
        raise AssertionError(f"assert_type failed: {what} has type {got} but expected {want}.")


def assert_super_batch(batch: dict, n_critic: int, batch_size: int) -> None:
    """Check the train step's super-batch contract (numpy arrays or tensors):
    ``features`` [n_critic+1, B, R, F] or ``images`` uint8 [n_critic+1, B, H,
    W, 3], and ``triples`` int32 [n_critic+1, B, 3]; raises AssertionError."""
    n_sub = n_critic + 1
    key = "features" if "features" in batch else "images"
    data, triples = batch[key], batch["triples"]
    _rank(data, 4 if key == "features" else 5, key)
    _rank(triples, 3, "triples")
    _axis(data, 0, n_sub, key)
    _axis(triples, 0, n_sub, "triples")
    _axis(data, 1, batch_size, key)
    _axis(triples, 2, 3, "triples")
    _type(triples, "int32", "triples")
    if key == "images":
        _type(data, "uint8", key)


def host_rss_gb() -> float:
    """This process's resident set size in GB (0.0 if unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0
