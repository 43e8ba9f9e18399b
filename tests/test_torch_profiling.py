"""The port's tracing against ``sgg/utils/profiling.py``: ``profile_trace``,
``annotate`` and the train step's named regions, and ``StepProfiler``'s
region lines, on the CPU.

- ``profile_trace`` writes a Chrome trace (and with ``create_perfetto`` its
  gzipped copy) that holds each region of one step: on ``smoke``
  ``sample_fakes_batched`` once, ``critic_update`` n_critic times and
  ``generator_update`` once; on a small vit_b16 with ``train_encoder``
  ``encoder`` inside each ``critic_update``.
- The regions a port step traces are the scope names that the reference's
  step carries in its op metadata (``jax.jit(...).lower``, not compiled) for
  the same config, out of the scope names in ``sgg/train/step.py``.
- ``annotate`` with no profiler open changes no bit of a step.
- ``region_split`` attributes a kernel by its launch, on any thread, and
  gives no split when the window replays a CUDA graph (synthetic traces);
  ``top_ops.txt`` carries the region lines and says when nothing ran on a
  device.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import test_torch_train as ttrain
from sgg_torch.config import get_config
from sgg_torch.train import step as step_mod
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn
from sgg_torch.utils.profiling import (
    REGIONS,
    StepProfiler,
    annotate,
    profile_trace,
    region_lines,
    region_split,
    trace_events,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_ENC = {**ttrain.VIT_SETS, "train.train_encoder": True}


def _batch(cfg, seed=0):
    """One super-batch for ``cfg`` from a seeded numpy generator."""
    r = np.random.RandomState(seed)
    n, B, V = cfg.train.n_critic + 1, cfg.train.batch_size, cfg.model.vocab_size
    out = {"triples": torch.from_numpy(r.randint(2, V, (n, B, 3)))}
    if cfg.model.encoder == "precomputed":
        out["features"] = torch.from_numpy(
            r.standard_normal((n, B, cfg.data.regions, cfg.data.feat_dim)).astype(np.float32))
    else:
        S = cfg.data.image_size
        out["images"] = torch.from_numpy(r.randint(0, 256, (n, B, S, S, 3), dtype=np.uint8))
    return out


def _traced_step(cfg, logdir, perfetto=False):
    """One port step of ``cfg`` under ``profile_trace``; the regions' host
    ranges by name."""
    state = create_train_state(cfg, 0)
    step = make_step_fn(cfg)
    batch = _batch(cfg)
    with profile_trace(logdir, create_perfetto=perfetto) as got:
        assert got == logdir
        step(state, batch)
    spans: dict = {}
    for name, cat, t0, dur in trace_events(os.path.join(logdir, "trace.json")):
        if name in REGIONS and cat in ("user_annotation", "cpu_op"):
            spans.setdefault(name, []).append((t0, t0 + dur))
    return spans


def test_profile_trace_holds_the_regions_of_a_smoke_step(tmp_path):
    cfg = get_config("smoke")
    spans = _traced_step(cfg, str(tmp_path), perfetto=True)
    assert {k: len(v) for k, v in spans.items()} == {
        "sample_fakes_batched": 1, "critic_update": cfg.train.n_critic, "generator_update": 1}
    with gzip.open(tmp_path / "perfetto_trace.json.gz") as f:
        assert json.load(f) == json.loads((tmp_path / "trace.json").read_text())


def test_profile_trace_nests_the_encoder_in_each_critic_update(tmp_path):
    cfg = get_config("vit_b16").override([f"{k}={v}" for k, v in VIT_ENC.items()])
    spans = _traced_step(cfg, str(tmp_path))
    nc = cfg.train.n_critic
    assert {k: len(v) for k, v in spans.items()} == {
        "critic_update": nc, "encoder": nc, "generator_update": 1}
    for a, b in spans["encoder"]:
        assert sum(c <= a and b <= d for c, d in spans["critic_update"]) == 1


def _reference_scopes(name, sets):
    """The scope names of ``sgg/train/step.py`` that appear in the op
    metadata of its step for this config, lowered (not compiled); and the
    port's config with the same overrides."""
    with open(os.path.join(ROOT, "sgg", "train", "step.py")) as f:
        declared = set(re.findall(r'named_scope\("(\w+)"\)', f.read()))
    assert declared == set(REGIONS)
    jcfg, pcfg = ttrain._configs(name, sets)
    if jcfg.model.encoder == "precomputed":
        data = ttrain.jax_synthetic_dataset(num_images=jcfg.data.num_synthetic_images,
                                            regions=jcfg.data.regions,
                                            feat_dim=jcfg.data.feat_dim, seed=0)
        ds = ttrain.JaxTripleDataset(features=data["features"], triples=data["triples"])
        vocab = data["vocab"]
    else:
        ds, vocab = ttrain.jax_load_dataset(jcfg)
    jcfg.model.vocab_size = pcfg.model.vocab_size = len(vocab)
    it = ttrain.jax_make_train_iterator(ds, jcfg.train.batch_size, jcfg.train.n_critic,
                                        seed=0, process_index=0, process_count=1,
                                        device_put=False, prefetch=0)
    lowered = jax.jit(ttrain.jax_make_step_fn(jcfg, vocab.step_mask())).lower(
        ttrain._reference_state(jcfg, pcfg), next(it))
    locs = re.findall(r'loc\("([^"]*)"', lowered.as_text(debug_info=True))
    parts = {re.sub(r"^\w+\((\w+)\)$", r"\1", p) for loc in locs for p in loc.split("/")}
    return declared & parts, pcfg


@pytest.mark.parametrize("name,sets", [("smoke", {"train.critic_unroll": 1}),
                                       ("vit_b16", {**VIT_ENC, "train.critic_unroll": 1})],
                         ids=["smoke", "vit_train_encoder"])
def test_region_names_match_the_reference_scopes(tmp_path, name, sets):
    scopes, pcfg = _reference_scopes(name, sets)
    assert set(_traced_step(pcfg, str(tmp_path))) == scopes


def test_annotate_without_a_profiler_changes_no_bit():
    cfg = get_config("smoke")
    batch = _batch(cfg, seed=3)
    states = []
    for regions in (True, False):
        state = create_train_state(cfg, 0)
        step_mod.annotate = annotate if regions else (lambda name: contextlib.nullcontext())
        try:
            metrics = make_step_fn(cfg)(state, batch)
        finally:
            step_mod.annotate = annotate
        states.append(({**state.generator.state_dict(), **state.critic.state_dict()}, metrics))
    (a, ma), (b, mb) = states
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": [{"ph": "X", **e} for e in events]}, f)


def test_region_split_attributes_kernels_by_their_launch(tmp_path):
    path = str(tmp_path / "trace.json")
    _write_trace(path, [
        {"name": "critic_update", "cat": "user_annotation", "ts": 100, "dur": 100, "tid": 1},
        {"name": "encoder", "cat": "user_annotation", "ts": 110, "dur": 20, "tid": 1},
        {"name": "generator_update", "cat": "user_annotation", "ts": 300, "dur": 50, "tid": 1},
        # launched by another thread (the autograd engine's) inside critic_update
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 150, "dur": 2, "tid": 7,
         "args": {"correlation": 11}},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 115, "dur": 2, "tid": 1,
         "args": {"correlation": 12}},
        {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 320, "dur": 2, "tid": 1,
         "args": {"correlation": 13}},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 250, "dur": 2, "tid": 1,
         "args": {"correlation": 14}},
        # the device runs them later, outside the host ranges
        {"name": "flash_bwd_dq", "cat": "kernel", "ts": 400, "dur": 30, "args": {"correlation": 11}},
        {"name": "conv", "cat": "kernel", "ts": 430, "dur": 5, "args": {"correlation": 12}},
        {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 440, "dur": 4,
         "args": {"correlation": 13}},
        {"name": "between", "cat": "kernel", "ts": 450, "dur": 8, "args": {"correlation": 14}},
        {"name": "orphan", "cat": "kernel", "ts": 460, "dur": 1, "args": {"correlation": 99}},
        {"name": "critic_update", "cat": "gpu_user_annotation", "ts": 400, "dur": 40},
    ])
    split = region_split(path)
    r = split["regions"]
    assert split["graph_launches"] == 0 and split["unattributed"] == 1
    assert r["critic_update"] == {"calls": 1, "host_ms": pytest.approx(0.1),
                                  "device_ms": pytest.approx(0.035),
                                  "kernels": {"flash_bwd_dq": 1, "conv": 1}}
    assert r["encoder"] == {"calls": 1, "host_ms": pytest.approx(0.02),
                            "device_ms": pytest.approx(0.005), "kernels": {"conv": 1}}
    assert r["generator_update"]["kernels"] == {"Memcpy HtoD": 1}
    assert "sample_fakes_batched" not in r
    lines = region_lines(split)
    assert lines[-1] == "device events without their launch in the trace: 1"
    assert any(ln.split()[-1] == "critic_update" and ln.split()[0] == "1" for ln in lines)


def test_region_split_gives_no_split_under_a_graph_replay(tmp_path):
    path = str(tmp_path / "trace.json")
    _write_trace(path, [
        {"name": "cudaGraphLaunch", "cat": "cuda_runtime", "ts": 10, "dur": 5,
         "args": {"correlation": 3}},
        {"name": "k", "cat": "kernel", "ts": 20, "dur": 5, "args": {"correlation": 3}},
    ])
    split = region_split(path)
    assert split["regions"] is None and split["graph_launches"] == 1
    (line,) = region_lines(split)
    assert "CUDA graph" in line and "no region split" in line and "0.000" not in line


def test_top_ops_has_region_lines_and_says_no_device(tmp_path):
    cfg = get_config("smoke")
    state, step, batch = create_train_state(cfg, 0), make_step_fn(cfg), _batch(cfg)
    prof = StepProfiler(str(tmp_path), start_step=0, num_steps=2)
    for i in range(2):
        prof.maybe_start(i)
        step(state, batch)
    assert prof.maybe_stop(2)
    table = (tmp_path / "top_ops.txt").read_text().splitlines()
    head = [i for i, ln in enumerate(table) if ln.startswith("regions")]
    assert len(head) == 1 and "no device kernel traced: not measured" in table[head[0]]
    rows = {ln.split()[-1]: ln.split() for ln in table[head[0] + 2:]}
    assert {k: int(v[0]) for k, v in rows.items()} == {
        "sample_fakes_batched": 2, "critic_update": 2 * cfg.train.n_critic,
        "generator_update": 2}
    assert all(" ".join(v[2:4]) == "not measured" for v in rows.values())
    regions = prof.summary["regions"]
    assert {k: v["calls"] for k, v in regions.items()} == {k: int(v[0]) for k, v in rows.items()}
    assert all(v["device_ms"] is None and v["host_ms"] > 0 for v in regions.values())
