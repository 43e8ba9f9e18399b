"""The data-parallel tier (``sgg_torch.dist``, ``make_step_fn(group=...)``,
the train CLI across ranks, ``make_dp_sampler``, the engine and ``serve
--dp``) against ``sgg``'s on the CPU.

- DP parity: ``sgg``'s ``make_train_step(cfg, mesh=...)`` (shard_map with
  explicit pmeans) on a 2-device mesh against the port's step in two gloo
  ranks, each a subprocess that imports no JAX, from one state; rank r gets
  its half of dim 1 of each super-batch and the reference's noise for shard
  r (``test_torch_train.reference_noise``'s, the key folded with the shard's
  index). Cases: ``tests/dist/test_data_parallel.py``'s smoke
  (global batch 16, R 9, F 16, V 24) and a small vit_b16 with
  ``train_encoder`` (``test_torch_train.VIT_SETS``, global batch 8,
  attention off the kernels). After
  each of 2 steps the metrics sit within rtol 1e-5 + atol 1e-6 and the
  parameters within ``test_torch_train._assert_params_close``'s bounds, and
  the two ranks' states and metrics are equal bit for bit.
- A world of one (gloo, in process) against the single-device step: bit for
  bit, the draws included.
- The train CLI over two ranks at smoke widths (65 images: shards of 33 and
  32): the reference's probe and dispatch fallback lines, the ranks' printed
  losses equal, metrics.jsonl written once (rank 0 alone), and a run cut at
  step 2 and resumed equal to the unbroken run's checkpoint bit for bit.
- ``make_dp_sampler`` on four CPU devices against ``make_sampler`` given the
  same noise and the same generator, with and without log-probs; the engine
  with a mesh against one without; the refusals (``serve --dp`` with too
  few devices or a batch that the mesh does not divide; the still unported
  mesh axes, fsdp and gspmd; a data axis larger than the world).

Three 2-rank launches of the CLI (the first two at once) and one of the
parity worker, which runs while the reference compiles.
"""

import copy
import json
import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sgg.dist import MeshSpec as JaxMeshSpec
from sgg.dist import batch_sharding as jax_batch_sharding
from sgg.dist import make_mesh as jax_make_mesh
from sgg.dist import replicated_sharding as jax_replicated_sharding
from sgg.train.step import make_train_step as jax_make_train_step
from sgg_torch.cli import serve as serve_cli
from sgg_torch.cli import train as train_cli
from sgg_torch.config import get_config
from sgg_torch.convert_flax import (
    critic_flax_to_state_dict,
    encoder_flax_to_state_dict,
    generator_flax_to_state_dict,
    train_state_from_flax,
)
from sgg_torch.data import Vocab
from sgg_torch.dist import (
    MeshSpec,
    batch_sharding,
    initialize_multihost,
    make_mesh,
    mesh_from_config,
    pmean,
    process_shard_info,
)
from sgg_torch.dist.mesh import Mesh
from sgg_torch.eval.sampler import draw_noise, make_dp_sampler, make_sampler
from sgg_torch.serve import InferenceEngine, ServeWeights
from sgg_torch.train.checkpoint import save_generator
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn
from test_torch_train import (
    VIT_SETS,
    _assert_params_close,
    _configs,
    _reference_state,
    reference_noise,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
V = 24


def _start_ranks(argv, world=2):
    """Start one process per rank (python arguments ``argv``) with the
    environment torchrun gives its ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return [subprocess.Popen(
        [sys.executable, *argv], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                            LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port), OMP_NUM_THREADS="1"))
        for r in range(world)]


def _wait_ranks(procs, timeout=180, code=0):
    """[(stdout, stderr)] of each rank; asserts every rank exited ``code``."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == code, err[-3000:]
    return outs


# ------------------------------------------------------------- DP parity

PARITY_WORKER = """
import copy, json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from sgg_torch.config import Config
from sgg_torch.dist import initialize_multihost, process_shard_info
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn

d = sys.argv[1]
initialize_multihost("cpu", log=lambda m: None)
r = process_shard_info().index
for case in json.load(open(d + "/cases.json")):
    blob = torch.load(f"{d}/{case}.pt", weights_only=False)
    cfg = Config.from_json(blob["cfg"])
    state = create_train_state(cfg, 0)
    state.load_state_dict(blob["state"])
    step = make_step_fn(cfg, blob["mask"], group=dist.group.WORLD)
    out = []
    for s, (batch, noise) in enumerate(zip(blob["batches"], blob["noise"])):
        m = step(state, batch[r], noise[r])
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "state": copy.deepcopy(state.state_dict())})
    torch.save(out, f"{d}/{case}_rank{r}.pt")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "sgg"))
assert not bad, bad
dist.destroy_process_group()
"""


def _parity_case(name, sets, B, image_size=None):
    """(port config, the port worker's inputs, a function that runs the
    reference's shard_map step on a 2-device mesh for 2 steps from the same
    state and returns its metrics and parameters after each step)."""
    jcfg, pcfg = _configs(name, sets)
    jcfg.model.vocab_size = pcfg.model.vocab_size = V
    r = np.random.RandomState(0)
    n_sub, Bl = jcfg.train.n_critic + 1, B // 2  # Bl: each rank's rows
    batches = []
    for _ in range(STEPS):
        if image_size is None:
            data = {"features": r.randn(n_sub, B, jcfg.data.regions,
                                        jcfg.data.feat_dim).astype(np.float32)}
        else:
            data = {"images": r.randint(0, 256, (n_sub, B, image_size, image_size, 3),
                                        dtype=np.uint8)}
        batches.append({**data, "triples": r.randint(2, V, (n_sub, B, 3)).astype(np.int32)})
    mask = np.ones((3, V), bool)
    st = _reference_state(jcfg, pcfg)
    port0 = train_state_from_flax(pcfg, st)
    mesh = jax_make_mesh(JaxMeshSpec(data=2), devices=jax.devices()[:2])
    jstep = jax_make_train_step(jcfg, mask, mesh=mesh, donate=False)
    noise_fn = reference_noise(jcfg, Bl)
    noise = [[noise_fn(st.rng, s, shard=k) for k in range(2)] for s in range(STEPS)]

    def reference():
        out, st_ = [], jax.device_put(st, jax_replicated_sharding(mesh))
        for s in range(STEPS):
            st_, jm = jstep(st_, jax.device_put(batches[s], jax_batch_sharding(mesh)))
            out.append({"metrics": {k: float(v) for k, v in jm.items()},
                        "g": generator_flax_to_state_dict(st_.g_params, pcfg),
                        "d": critic_flax_to_state_dict(st_.d_params, pcfg),
                        "enc": (None if st_.enc_params is None else
                                encoder_flax_to_state_dict(jax.device_get(st_.enc_params)))})
        return out

    halves = [batch_sharding(Mesh(data=2, devices=("cpu",), rank=k_)) for k_ in range(2)]
    local = [[{k: torch.from_numpy(np.ascontiguousarray(h.local(v))) for k, v in b.items()}
              for h in halves] for b in batches]
    inputs = {"cfg": pcfg.to_json(), "state": port0.state_dict(), "mask": mask,
              "batches": local, "noise": noise}
    return pcfg, inputs, reference


PARITY_CASES = {
    "smoke": ("smoke", {"train.critic_unroll": 1, "data.regions": 9, "data.feat_dim": 16,
                        "train.n_critic": 2}, 16, None),
    # Attention on XLA in the reference and on the plain version here: the
    # kernels' parity is test_torch_train's; the collectives' is this one's.
    "vit_train_encoder": ("vit_b16", {**VIT_SETS, "train.train_encoder": True,
                                      "model.use_pallas": False}, 8, 64),
}


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The ranks run while the reference compiles its two steps, each in a
    thread of its own."""
    from concurrent.futures import ThreadPoolExecutor

    d = str(tmp_path_factory.mktemp("dp_parity"))
    cases = {}
    for name, (config, sets, B, size) in PARITY_CASES.items():
        cfg, inputs, reference = _parity_case(config, sets, B, size)
        torch.save(inputs, os.path.join(d, f"{name}.pt"))
        cases[name] = (cfg, reference)
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump(sorted(cases), f)
    procs = _start_ranks(["-c", PARITY_WORKER, d])
    with ThreadPoolExecutor(len(cases)) as pool:
        refs = {name: pool.submit(reference) for name, (_, reference) in cases.items()}
        refs = {name: f.result() for name, f in refs.items()}
    _wait_ranks(procs)
    return {name: (cfg, refs[name], [torch.load(os.path.join(d, f"{name}_rank{r}.pt"),
                                                weights_only=False) for r in range(2)])
            for name, (cfg, _) in cases.items()}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_two_ranks_match_the_reference_shard_map_step(parity, case):
    cfg, ref, ranks = parity[case]
    t = cfg.train
    for i, (want, got) in enumerate(zip(ref, ranks[0]), start=1):
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        sd = got["state"]
        _assert_params_close(sd["g_params"], want["g"], t.g_lr, i)
        _assert_params_close(sd["d_params"], want["d"], t.d_lr, i * t.n_critic)
        if want["enc"] is not None:
            _assert_params_close(sd["enc_params"], want["enc"], t.enc_lr, i * t.n_critic)


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_two_ranks_stay_equal_bit_for_bit(parity, case):
    _, _, (a, b) = parity[case]

    def leaves(x):
        if torch.is_tensor(x):
            return [x]
        if isinstance(x, dict):
            return [y for k in sorted(x, key=str) for y in leaves(x[k])]
        if isinstance(x, (list, tuple)):
            return [y for v in x for y in leaves(v)]
        return [torch.tensor(x)] if isinstance(x, (int, float)) else []

    for sa, sb in zip(a, b):
        assert sa["metrics"] == sb["metrics"]
        la, lb = leaves(sa["state"]), leaves(sb["state"])
        assert len(la) == len(lb) > 0
        assert all(torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------- world of one

def test_world_of_one_equals_the_single_device_step(tmp_path):
    import torch.distributed as dist

    cfg = get_config("smoke").override(["train.grad_accum=2", "train.ema_decay=0.9"])
    cfg.model.vocab_size = V
    r = np.random.RandomState(1)
    batches = [{"features": torch.from_numpy(r.randn(3, 8, 9, 16).astype(np.float32)),
                "triples": torch.from_numpy(r.randint(2, V, (3, 8, 3)).astype(np.int32))}
               for _ in range(2)]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        plain, dp = create_train_state(cfg, 0), create_train_state(cfg, 0)
        step_plain, step_dp = make_step_fn(cfg), make_step_fn(cfg, group=dist.group.WORLD)
        for b in batches:
            m1, m2 = step_plain(plain, b), step_dp(dp, b)
            assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
        assert all(torch.equal(x, y) for x, y in zip(plain.tensors(), dp.tensors()))
        bf = torch.randn(5, dtype=torch.bfloat16)
        (got,) = pmean([bf], dist.group.WORLD)
        assert got.dtype == torch.bfloat16 and torch.equal(got, bf)
        assert process_shard_info().count == 1
        mesh = mesh_from_config(cfg.mesh, "cpu")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.group is not None
    finally:
        dist.destroy_process_group()


def test_one_process_runtime_and_refused_meshes(monkeypatch):
    assert initialize_multihost("cpu") == torch.device("cpu")  # no torchrun: a no-op
    assert process_shard_info().count == 1
    mesh = make_mesh(MeshSpec(), devices=["cpu"] * 4)
    assert mesh.shape == {"data": 4, "model": 1}
    assert make_mesh(MeshSpec(data=3), devices=["cpu"] * 4).data == 3  # a sub-mesh
    with pytest.raises(ValueError, match="needs more than 4"):
        make_mesh(MeshSpec(data=5), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="do not divide"):
        make_mesh(MeshSpec(model=3), devices=["cpu"] * 4)
    for spec, slice_ in ((MeshSpec(model=2), "A8b"), (MeshSpec(seq=2), "A8c"),
                         (MeshSpec(expert=2), "A8e")):
        with pytest.raises(NotImplementedError, match=slice_):
            make_mesh(spec, devices=["cpu"] * 4)
    for sets, slice_ in ((["mesh.fsdp=true"], "A8b"), (["mesh.partition=gspmd"], "A8b")):
        with pytest.raises(NotImplementedError, match=slice_):
            mesh_from_config(get_config("smoke").override(sets).mesh, "cpu")
    with pytest.raises(ValueError, match="needs more than 1"):
        mesh_from_config(get_config("smoke").override(["mesh.data=2"]).mesh, "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2"):
        process_shard_info()


# ------------------------------------------------------------ the CLI

# The train CLI in a rank that, on rank 1 alone, sends itself SIGTERM once
# its state reaches step AT ("sigterm"), or reads a host RSS over any limit
# ("rss"): the other rank must act at the same step.
ONE_RANK_HOOK = """
import os, signal, sys
from sgg_torch.cli import train
hook, at = sys.argv[1], int(sys.argv[2])
if os.environ["RANK"] == "1" and hook == "sigterm":
    make = train.make_step_fn
    def make_step_fn(*a, **k):
        step = make(*a, **k)
        def run(state, *b, **kw):
            out = step(state, *b, **kw)
            if state.step == at:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return run
    train.make_step_fn = make_step_fn
if os.environ["RANK"] == "1" and hook == "rss":
    train.host_rss_gb = lambda: 1e6
sys.exit(train.main(sys.argv[3:]))
"""


def _cli_argvs(wd, steps):
    argv = ["-m", "sgg_torch.cli.train", "--config", "smoke", "--device", "cpu", "--workdir",
            str(wd), "--steps", str(steps)]
    for s in ("train.log_every=1", "train.checkpoint_every=2", "train.eval_every=2",
              "train.steps_per_dispatch=2", "data.num_synthetic_images=65"):
        argv += ["--set", s]
    return argv


def _losses(out):
    return re.findall(r"\[sgg\.train\] step (\d+): (d_loss=\S+ g_loss=\S+ w_dist=\S+ gp=\S+)",
                      out)


def _state(wd, step):
    return torch.load(os.path.join(wd, "checkpoints", str(step), "state.pt"),
                      weights_only=True)


def _same(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_two_rank_cli_shards_logs_once_and_resumes_bit_for_bit(tmp_path):
    """The cut comes from SIGTERM on rank 1 alone after step 2, and a third
    run's rank 1 alone reads its host RSS over the limit at step 1 (C2): both
    ranks checkpoint the same step and exit 0, then 75."""
    whole, cut, rss = tmp_path / "whole", tmp_path / "cut", tmp_path / "rss"
    first = [_start_ranks(_cli_argvs(whole, 4)),
             _start_ranks(["-c", ONE_RANK_HOOK, "sigterm", "2", *_cli_argvs(cut, 4)[2:]]),
             _start_ranks(["-c", ONE_RANK_HOOK, "rss", "1", *_cli_argvs(rss, 4)[2:],
                           "--set", "train.host_rss_exit_gb=1000"])]
    runs = [_wait_ranks(procs, code=code) for procs, code in zip(first, (0, 0, 75))]
    for out, _ in runs[1]:
        assert "[sgg.train] preemption signal: checkpointing at step 2 and exiting" in out
    for out, _ in runs[2]:
        assert "limit — checkpointed at step 1, exiting 75 for supervised relaunch" in out
    assert sorted(os.listdir(rss / "checkpoints")) == ["1"]
    assert sorted(os.listdir(cut / "checkpoints")) == ["2"]
    runs[2] = _wait_ranks(_start_ranks(_cli_argvs(cut, 4)))
    (out0, _), (out1, _) = runs[0]
    for r, out, n in ((0, out0, 33), (1, out1, 32)):
        assert f"[sgg.dist] rank {r} of 2 on cpu: backend gloo (ranks on the CPU)" in out
        assert "devices=2 processes=2" in out
        assert f"host iterator with prefetch (process {r} of 2: {n} of 65 images)" in out
        assert ("[sgg.train] train.eval_every: in-loop probe is single-process only — "
                "skipping (evaluate offline)") in out
        assert ("[sgg.train] steps_per_dispatch needs the single-process device-resident "
                "data path — falling back to per-step dispatch") in out
    assert _losses(out0) == _losses(out1) and len(_losses(out0)) == 4
    with open(whole / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4]  # rank 0 alone
    assert all("resumed from step 2" in out for out, _ in runs[2])
    assert _same(_state(whole, 4), _state(cut, 4))
    assert _same(_state(whole, 2), _state(cut, 2))


def test_process_slices_are_disjoint_and_cover_uneven_sets():
    from sgg_torch.data import TripleDataset
    from sgg_torch.data.images import ArrayImageTripleDataset, ImageTripleDataset

    for n in (1, 7, 64, 65, 100):
        tri = [np.zeros((1, 3), np.int32)] * n
        for ds in (TripleDataset(np.zeros((n, 1, 2), np.float32), tri),
                   ArrayImageTripleDataset(np.zeros((n, 2, 2, 3), np.uint8), tri),
                   ImageTripleDataset([f"{i}.jpg" for i in range(n)], tri)):
            for p in (1, 2, 3, 4, 7):
                shards = [ds.process_slice(i, p) for i in range(p)]
                assert sorted(np.concatenate(shards).tolist()) == list(range(n))
                sizes = [len(s) for s in shards]
                assert max(sizes) - min(sizes) <= 1


# ------------------------------------------------- sampler and serving

def _smoke(vocab_size=V):
    cfg = get_config("smoke")
    cfg.model.vocab_size = vocab_size
    return cfg


@pytest.mark.parametrize("with_logp", [False, True])
def test_dp_sampler_on_four_devices_matches_make_sampler(with_logp):
    cfg, K, B = _smoke(), 6, 16
    g = create_train_state(cfg, 0).generator.state_dict()
    feats = torch.from_numpy(np.random.RandomState(0).randn(B, 9, 16).astype(np.float32))
    mesh = make_mesh(MeshSpec(data=-1), devices=["cpu"] * 4)
    single = make_sampler(cfg, num_samples=K, with_logp=with_logp)
    dp = make_dp_sampler(cfg, mesh, num_samples=K, with_logp=with_logp)
    noise = draw_noise(torch.Generator().manual_seed(7), K, B, 8, V, torch.float32, "cpu")
    for kw in ({"noise": noise}, {"generator": None}):
        if "generator" in kw:
            got = dp(g, feats, generator=torch.Generator().manual_seed(7))
            want = single(g, feats, generator=torch.Generator().manual_seed(7))
        else:
            got, want = dp(g, feats, **kw), single(g, feats, **kw)
        if with_logp:
            assert torch.equal(got[0], want[0]) and got[1].shape == (B, K)
            torch.testing.assert_close(got[1], want[1], rtol=3e-7, atol=0)
        else:
            assert got.shape == (B, K, 3) and torch.equal(got, want)
    temps = torch.linspace(0.5, 1.5, B)
    assert torch.equal(dp(g, feats, noise=noise, temp=temps)[0] if with_logp
                       else dp(g, feats, noise=noise, temp=temps),
                       single(g, feats, noise=noise, temp=temps)[0] if with_logp
                       else single(g, feats, noise=noise, temp=temps))
    with pytest.raises(ValueError, match="divisible"):
        dp(g, feats[:6], noise=noise)


def test_engine_with_a_mesh_serves_what_one_device_serves():
    vocab = Vocab.build({f"o{i}": 2 for i in range(12)}, {f"p{i}": 2 for i in range(8)})
    cfg = _smoke(len(vocab))
    weights = ServeWeights(1, create_train_state(cfg, 0).generator.state_dict())
    mesh = make_mesh(MeshSpec(data=4), devices=["cpu"] * 4)
    kw = dict(device="cpu", batch_size=8, num_samples=4, seed=3, rank="logp")
    feats = np.random.RandomState(1).randn(3, 9, 16).astype(np.float32)
    got = InferenceEngine(cfg, vocab, weights, mesh=mesh, **kw).generate(feats)
    want = InferenceEngine(cfg, vocab, weights, **kw).generate(feats)
    assert len(got) == len(want) == 3
    for g_, w_ in zip(got, want):  # the same draws; logp within make_dp_sampler's bound
        key = lambda t: (t["subject"], t["predicate"], t["object"])  # noqa: E731
        g_t, w_t = sorted(g_["triples"], key=key), sorted(w_["triples"], key=key)
        assert [(key(t), t["count"]) for t in g_t] == [(key(t), t["count"]) for t in w_t]
        np.testing.assert_allclose([t["logp"] for t in g_t], [t["logp"] for t in w_t],
                                   rtol=3e-7, atol=0)
        assert sum(t["count"] for t in g_["triples"]) == 4
    with pytest.raises(ValueError, match="divisible"):
        InferenceEngine(cfg, vocab, weights, mesh=mesh, **dict(kw, batch_size=6))


def test_serve_dp_refusals(tmp_path, monkeypatch, capsys):
    vocab = Vocab.build({f"o{i}": 2 for i in range(12)}, {f"p{i}": 2 for i in range(8)})
    cfg = _smoke(len(vocab))
    with open(tmp_path / "config.json", "w") as f:
        f.write(cfg.to_json())
    vocab.save(str(tmp_path / "vocab.json"))
    save_generator(str(tmp_path), create_train_state(cfg, 0).generator.state_dict(), step=1)
    wd = str(tmp_path)
    # The engine's divisibility error, as the reference's ValueError: exit 2.
    assert serve_cli.main(["--workdir", wd, "--dp", "4", "--batch-size", "6",
                           "--device", "cpu"]) == 2
    assert "not divisible by the mesh's data axis (4)" in capsys.readouterr().err
    # Too few CUDA devices, where the reference's make_mesh raises: exit 2.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert serve_cli.main(["--workdir", wd, "--dp", "2"]) == 2
    assert "--dp 2 needs 2 CUDA devices; 1 visible" in capsys.readouterr().err
    # A data axis larger than the world refuses the train CLI alike.
    assert train_cli.main(["--config", "smoke", "--device", "cpu", "--workdir",
                           str(tmp_path / "t"), "--set", "mesh.data=2"]) == 2
    assert "needs more than 1 devices" in capsys.readouterr().err


def test_config_v4_32_matches_the_reference():
    import dataclasses

    from sgg.config import get_config as jax_get_config

    assert (dataclasses.asdict(get_config("v4_32"))
            == dataclasses.asdict(jax_get_config("v4_32")))
    assert copy.deepcopy(get_config("v4_32")).train.batch_size == 128
