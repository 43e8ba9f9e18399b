"""Tensor parallelism over the vocabulary and FSDP/ZeRO over 'data'
(``sgg_torch.dist.sharding``, the gspmd step ``make_step_fn(mesh=...)``, the
train CLI's gspmd route) against ``sgg``'s on the CPU.

- The sharding rule: the port's ``state_sharding`` against
  ``sgg.dist.state_sharding`` on smoke-width states, leaf by leaf after the
  layout map (the same axis, the same flax dimension): TP at data 4 x model 2,
  FSDP at data 8 with ``fsdp_min_size=64``, both, the vit_b16 transformer
  decoder with the critic (as ``tests/dist/test_tp_fsdp.py:45-83``), and a
  trained VGG-19's conv kernels under FSDP.
- Each collective Function (``all_gather``, ``split``, ``all_reduce``,
  ``copy_to``, ``reduce_scatter``) under ``gradcheck`` and ``gradgradcheck``
  in float64 over two gloo ranks: rank 0's input varies while rank 1 sends
  constants and zero cotangents, so rank 0 sees the Jacobian of its own
  output with respect to its own input through the collective. The
  vocab-parallel embedding and logits (``VocabShard``), replicated in and
  out, under both checks with the two ranks in step.
- The gspmd step at smoke widths with TP and FSDP on a data 2 x model 2
  mesh (four gloo ranks, subprocesses that import no JAX, FSDP at a
  ``fsdp_min_size`` of 256 so that it splits leaves at these widths) against
  ``sgg``'s ``make_train_step_gspmd`` on a 2 x 2 mesh of the CPU devices,
  fed the reference's ``jax.random`` draws at the global batch: after one and
  two steps the metrics within the reference's own rtol 1e-4 and the
  parameters within ``test_torch_train._assert_params_close``'s bounds. TP
  alone (model 2) and FSDP alone (data 2, a small vit_b16 with
  ``train_encoder``, a clip and the EMA; and VGG-19 at 32 px with
  ``train_encoder`` and ``use_pallas``, its HWIO kernels split, one step at
  n_critic 1: ``CASE_STEPS``), each two ranks, against the port's
  single-device step at the global batch, within the same bounds; each
  rank's state bytes: every split leaf (and its moments and EMA) holds 1/n
  of its elements.
- The train CLI over four ranks (``mesh.model=2``, ``mesh.fsdp=true``): cut
  by SIGTERM on one rank after step 1 and resumed, equal to the unbroken run
  bit for bit; its global checkpoint is read by ``sgg_torch.cli.evaluate``.
- The route rule against ``sgg/cli/train.py:116-119`` (the expression read
  from the reference's source) for every ``partition``, ``model``, ``fsdp``,
  ``seq`` and ``sp_mode``, on one rank and on four; the port reproduces every case, so
  none is refused. On one rank, as the reference's has no mesh on one
  device, ``mesh.fsdp`` trains the single-device step and a model axis
  larger than the world is refused.

The three worker worlds (8 processes) run while the reference compiles.
"""

import inspect
import itertools
import os
import re

import jax
import numpy as np
import pytest
import torch

from sgg.cli import train as jax_train_cli
from sgg.config import get_config as jax_get_config
from sgg.dist import MeshSpec as JaxMeshSpec
from sgg.dist import make_mesh as jax_make_mesh
from sgg.dist import place_state as jax_place_state
from sgg.dist import state_sharding as jax_state_sharding
from sgg.train.state import create_train_state as jax_create_train_state
from sgg.train.step import make_train_step_gspmd as jax_make_train_step_gspmd
from sgg_torch.cli import evaluate as evaluate_cli
from sgg_torch.cli import train as train_cli
from sgg_torch.config import get_config
from sgg_torch.convert_flax import (
    _GENERATOR_MAP,
    critic_flax_to_state_dict,
    generator_flax_to_state_dict,
    train_state_from_flax,
)
from sgg_torch.dist.mesh import Mesh
from sgg_torch.dist.sharding import DATA_AXIS, MODEL_AXIS, state_sharding
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn
from test_torch_dist import (
    ONE_RANK_HOOK,
    _cli_argvs,
    _free_ports,
    _same,
    _start_ranks,
    _state,
    _wait_ranks,
)
from test_torch_train import VIT_SETS, _assert_params_close, _configs, _reference_state
from test_torch_train import reference_noise

torch.set_num_threads(1)

V = 24
STEPS = 2

# --------------------------------------------------------- the rule


def _spec_of(p):
    """(axis, dim) of a reference PartitionSpec; (None, None) replicated."""
    hit = [(a, i) for i, a in enumerate(tuple(p)) if a is not None]
    return hit[0] if hit else (None, None)


def _reference_leaves(sh, decoder):
    """{(tree, kind, port key): (axis, flax dim)} of a reference sharding
    tree: kind 'params', 'mu', 'nu', 'ema' or 'scalar'."""
    lstm = {path: key for path, key, _ in _GENERATOR_MAP} if decoder == "lstm" else {}
    out = {}

    def visit(path, leaf):
        names = []
        for k in path:
            for attr in ("key", "name", "idx"):
                if hasattr(k, attr):
                    names.append(str(getattr(k, attr)))
                    break
        tree = names[0]
        if tree in ("step", "rng") or "count" in names:
            out[(tree, "scalar", "/".join(names))] = _spec_of(leaf.spec)
            return
        if "mu" in names or "nu" in names:
            kind = "mu" if "mu" in names else "nu"
            rest = names[names.index(kind) + 1:]
            tree = tree.replace("_opt_state", "_params")
        else:
            kind, rest = ("ema", names[1:]) if tree == "g_ema" else ("params", names[1:])
        if rest and rest[0] == "params":
            rest = rest[1:]
        base = "g" if tree in ("g_params", "g_ema") else tree.split("_")[0]
        # VGG-19's flat flax names ("conv1_1/kernel") are the port's dotted keys.
        key = (lstm.get(tuple(rest), ".".join(rest)) if base == "g"
               else ".".join(rest).replace("/", "."))
        out[(base, kind, key)] = _spec_of(leaf.spec)

    jax.tree_util.tree_map_with_path(visit, sh)
    return out


def _port_leaves(specs):
    out = {}
    for k, s in specs.items():
        parts = k.split("/")
        if parts[0] == "step" or parts[-1] == "count":
            continue
        tree, rest = parts[0].split("_")[0], parts[1:]
        if parts[0] == "g_ema":
            out[("g", "ema", rest[0])] = (s.axis, s.flax_dim)
        elif parts[0].endswith("_opt"):
            out[(tree, rest[0], rest[1])] = (s.axis, s.flax_dim)
        else:
            out[(tree, "params", rest[0])] = (s.axis, s.flax_dim)
    return out


RULE_CASES = {
    "tp": ("smoke", {}, (4, 2), True, False, 2 ** 16),
    "fsdp": ("smoke", {}, (8, 1), False, True, 64),
    "tp_fsdp": ("smoke", {"train.ema_decay": 0.99}, (4, 2), True, True, 64),
    "vit_transformer": ("vit_b16", {**VIT_SETS, "model.vocab_size": V}, (4, 2), True, True,
                        64),
    # VGG-19's HWIO conv kernels, trained (their moments split with them).
    "vgg_train_encoder": ("smoke", {"model.encoder": "vgg19", "data.image_size": 32,
                                    "data.regions": 4, "data.feat_dim": 512,
                                    "train.train_encoder": True}, (8, 1), False, True, 64),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_state_sharding_matches_the_reference_leaf_by_leaf(case):
    name, sets, (data, model), tp, fsdp, min_size = RULE_CASES[case]
    jcfg, pcfg = _configs(name, {"model.vocab_size": V, **sets})
    abstract = jax.eval_shape(lambda k: jax_create_train_state(jcfg, k), jax.random.key(0))
    mesh = jax_make_mesh(JaxMeshSpec(data=data, model=model))
    want = _reference_leaves(jax_state_sharding(abstract, mesh, tp=tp, fsdp=fsdp,
                                                fsdp_min_size=min_size), jcfg.model.decoder)
    state = create_train_state(pcfg, 0)
    specs = state_sharding(state, Mesh(data=data, devices=("cpu",), model=model), tp=tp,
                           fsdp=fsdp, fsdp_min_size=min_size)
    got = _port_leaves(specs)
    scalars = {k: v for k, v in want.items() if k[1] == "scalar"}
    assert all(v == (None, None) for v in scalars.values()) and specs["step"].axis is None
    want = {k: v for k, v in want.items() if k[1] != "scalar"}
    assert got == want, case
    axes = {a for a, _ in got.values()}
    assert ({MODEL_AXIS} if tp else set()) | ({DATA_AXIS} if fsdp else set()) <= axes
    # A Linear weight [out, in] takes the flax kernel's dimension transposed.
    if name == "smoke" and tp:
        s = specs["g_params/vocab_proj.weight"]
        assert (s.axis, s.dim, s.flax_dim) == (MODEL_AXIS, 0, 1)


# ------------------------------------------------------- rank workers

# Runs in each rank (no JAX): the gradient checks (2-rank worlds that ask for
# them), then the case's gspmd steps from the given state, batches and global
# noise; writes the metrics and the gathered state after each step, the
# state bytes and each placed leaf's stored size.
WORKER = """
import copy, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from sgg_torch.config import Config
from sgg_torch.dist import batch_sharding, initialize_multihost, mesh_from_config
from sgg_torch.dist import multihost as mh
from sgg_torch.dist.sharding import (VocabShard, gather_state, place_state, state_bytes,
                                     state_sharding)
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn

d, case = sys.argv[1], sys.argv[2]
initialize_multihost("cpu", log=lambda m: None)
r, W = dist.get_rank(), dist.group.WORLD
blob = torch.load(f"{d}/{case}.pt", weights_only=False)
out = {}
if blob.get("gradcheck"):
    from torch.autograd import gradcheck, gradgradcheck
    c = torch.randn(3, 4, dtype=torch.float64, generator=torch.Generator().manual_seed(9))

    def alone(fn):  # rank 0's input varies; rank 1 sends constants, zero cotangents
        return (lambda x: fn(x)) if r == 0 else (lambda x: fn(x * 0 + c) * 0)

    fns = {"all_gather": lambda x: mh.all_gather(x, W, -1),
           "split": lambda x: mh.split(x, W, -1),
           "all_reduce": lambda x: mh.all_reduce(x, W),
           "copy_to": lambda x: mh.copy_to(x, W),
           "reduce_scatter": lambda x: mh.reduce_scatter(x, W, -1)}
    g = torch.Generator().manual_seed(1)
    table = torch.randn(4, 5, dtype=torch.float64, generator=g)
    proj = torch.randn(5, 4, dtype=torch.float64, generator=g)
    vs = VocabShard(W)
    mine = slice(2 * r, 2 * r + 2)
    fns["vocab_embed"] = lambda y: vs.embed(y, table[mine], torch.float64)
    fns["vocab_logits"] = lambda x: vs.logits(lambda u: u @ proj[:, mine], x)
    checks = {}
    for name, fn in fns.items():
        vocab = name.startswith("vocab")
        torch.manual_seed(5)
        x = torch.randn(3, 4 if name != "vocab_logits" else 5, dtype=torch.float64,
                        requires_grad=True)
        f = fn if vocab else alone(fn)
        checks[name] = (bool(gradcheck(f, (x,), raise_exception=False)),
                        bool(gradgradcheck(f, (x,), raise_exception=False)))
    out["checks"] = checks
cfg = Config.from_json(blob["cfg"])
state = create_train_state(cfg, 0)
state.load_state_dict(blob["state"])
mesh = mesh_from_config(cfg.mesh, "cpu")
whole = state_bytes(state)
specs = state_sharding(state, mesh, tp=cfg.mesh.model > 1, fsdp=bool(cfg.mesh.fsdp),
                       fsdp_min_size=blob["min_size"])
place_state(state, specs, mesh)
pl = state.placement
out["bytes"] = (whole, state_bytes(state))
out["stored"] = {t: {k: v.numel() for k, v in pl.stored(mp.module).items()}
                 for t, mp in pl.modules.items()}
out["moments"] = {t: [m.numel() for m in getattr(state, t + "_tx").mu]
                  for t in ("g", "d", "enc") if getattr(state, t + "_tx", None) is not None}
out["ema"] = None if state.g_ema is None else {k: v.numel() for k, v in state.g_ema.items()}
out["specs"] = {k: (s.axis, s.dim) for k, s in specs.items()}
step = make_step_fn(cfg, blob["mask"], mesh=mesh)
sh = batch_sharding(mesh)
out["steps"] = []
for batch, noise in zip(blob["batches"], blob["noise"]):
    m = step(state, {k: sh.local(v) for k, v in batch.items()}, noise)
    out["steps"].append({"metrics": {k: float(v) for k, v in m.items()},
                         "state": copy.deepcopy(gather_state(state))})
torch.save(out, f"{d}/{case}_rank{r}.pt")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "sgg"))
assert not bad, bad
dist.destroy_process_group()
"""

SMOKE = {"train.critic_unroll": 1, "data.regions": 9, "data.feat_dim": 16, "train.n_critic": 2}
# name: (config, sets, global batch, image size, world, ranks' min size)
STEP_CASES = {
    "tp_fsdp": ("smoke", {**SMOKE, "train.grad_clip": 1.0, "train.ema_decay": 0.9,
                          "mesh.model": 2, "mesh.fsdp": True}, 16, None, 4, 256),
    "tp": ("smoke", {**SMOKE, "train.grad_clip": 1.0, "mesh.model": 2}, 8, None, 2, 256),
    "fsdp": ("vit_b16", {**VIT_SETS, "train.train_encoder": True, "model.use_pallas": False,
                         "train.grad_clip": 1.0, "train.ema_decay": 0.9, "mesh.fsdp": True},
             8, 64, 2, 1024),
    # VGG-19 trained end to end on its kernel-route setting (the library conv),
    # one step at n_critic 1 (CASE_STEPS).
    "fsdp_vgg": ("smoke", {**SMOKE, "model.encoder": "vgg19", "model.use_pallas": True,
                           "data.regions": 4, "data.feat_dim": 512, "train.train_encoder": True,
                           "train.n_critic": 1, "train.grad_clip": 1.0, "mesh.fsdp": True},
                 4, 32, 2, 1024),
}

# Steps of a case, where not STEPS: VGG-19's one step, since past an Adam
# update the two runs part (the critic's and encoder's gradients are
# differences of nearly equal terms at initialization, so a float32 sum in
# another order moves Adam's sign at many elements;
# tests/test_torch_train_encoder_cnn.py).
CASE_STEPS = {"fsdp_vgg": 1}


def _step_case(name):
    config, sets, B, size, world, min_size = STEP_CASES[name]
    jcfg, pcfg = _configs(config, sets)
    jcfg.model.vocab_size = pcfg.model.vocab_size = V
    r = np.random.RandomState(0)
    n_sub = jcfg.train.n_critic + 1
    batches = []
    for _ in range(CASE_STEPS.get(name, STEPS)):
        if size is None:
            data = {"features": r.randn(n_sub, B, jcfg.data.regions,
                                        jcfg.data.feat_dim).astype(np.float32)}
        else:
            data = {"images": r.randint(0, 256, (n_sub, B, size, size, 3), dtype=np.uint8)}
        batches.append({**data, "triples": r.randint(2, V, (n_sub, B, 3)).astype(np.int32)})
    mask = np.ones((3, V), bool)
    st = _reference_state(jcfg, pcfg)
    port0 = train_state_from_flax(pcfg, st)
    noise_fn = reference_noise(jcfg, B)
    noise = [noise_fn(st.rng, s) for s in range(len(batches))]
    tensors = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    inputs = {"cfg": pcfg.to_json(), "state": port0.state_dict(), "mask": mask,
              "batches": tensors, "noise": noise, "min_size": min_size,
              "gradcheck": world == 2 and name == "tp"}
    return jcfg, pcfg, st, mask, batches, tensors, noise, inputs


def _reference_gspmd(jcfg, pcfg, st, mask, batches):
    """The reference's gspmd step with TP and FSDP on a 2 x 2 mesh: its
    metrics and parameters after each step."""
    mesh = jax_make_mesh(JaxMeshSpec(data=2, model=2), devices=jax.devices()[:4])
    step, state_sh = jax_make_train_step_gspmd(jcfg, mesh, step_mask=mask, tp=True, fsdp=True,
                                               donate=False)
    st_ = jax_place_state(st, state_sh)
    out = []
    for b in batches:
        st_, m = step(st_, b)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "g": generator_flax_to_state_dict(jax.device_get(st_.g_params), pcfg),
                    "d": critic_flax_to_state_dict(jax.device_get(st_.d_params), pcfg),
                    "ema": generator_flax_to_state_dict(jax.device_get(st_.g_ema), pcfg)})
    return out


@pytest.fixture(scope="module")
def gspmd(tmp_path_factory):
    """Every worker world runs while the reference compiles."""
    d = str(tmp_path_factory.mktemp("gspmd"))
    cases, procs = {}, {}
    for name, port in zip(STEP_CASES, _free_ports(len(STEP_CASES))):
        case = _step_case(name)
        torch.save(case[-1], os.path.join(d, f"{name}.pt"))
        cases[name] = case
        procs[name] = _start_ranks(["-c", WORKER, d, name], world=STEP_CASES[name][4], port=port)
    jcfg, pcfg, st, mask, batches, *_ = cases["tp_fsdp"]
    try:
        ref = _reference_gspmd(jcfg, pcfg, st, mask, batches)
    finally:
        for p in procs.values():
            _wait_ranks(p, timeout=240)
    ranks = {name: [torch.load(os.path.join(d, f"{name}_rank{r}.pt"), weights_only=False)
                    for r in range(STEP_CASES[name][4])] for name in STEP_CASES}
    return cases, ref, ranks


def _check_steps(cfg, got_steps, want_steps, rtol):
    t = cfg.train
    for i, (got, want) in enumerate(zip(got_steps, want_steps), start=1):
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol, atol=1e-6, err_msg=k)
        sd = got["state"]
        _assert_params_close(sd["g_params"], want["g"], t.g_lr, i)
        _assert_params_close(sd["d_params"], want["d"], t.d_lr, i * t.n_critic)
        if want.get("enc") is not None:
            _assert_params_close(sd["enc_params"], want["enc"], t.enc_lr, i * t.n_critic)
        if want.get("ema") is not None:
            _assert_params_close(sd["g_ema"], want["ema"], t.g_lr, i)


def test_gspmd_step_on_2x2_matches_the_reference(gspmd):
    cases, ref, ranks = gspmd
    cfg = cases["tp_fsdp"][1]
    axes = {a for a, _ in ranks["tp_fsdp"][0]["specs"].values()}
    assert {MODEL_AXIS, DATA_AXIS} <= axes  # both rules split leaves here
    for rank in ranks["tp_fsdp"]:
        _check_steps(cfg, rank["steps"], ref, rtol=1e-4)
    # Every rank gathers the same global state.
    for rank in ranks["tp_fsdp"][1:]:
        for a, b in zip(rank["steps"], ranks["tp_fsdp"][0]["steps"]):
            assert a["metrics"] == b["metrics"] and _same(a["state"], b["state"])


@pytest.mark.parametrize("case", ["tp", "fsdp", "fsdp_vgg"])
def test_tp_alone_and_fsdp_alone_match_the_single_device_step(gspmd, case):
    cases, _, ranks = gspmd
    _, cfg, _, mask, _, tensors, noise, inputs = cases[case]
    plain = create_train_state(cfg, 0)
    plain.load_state_dict(inputs["state"])
    step = make_step_fn(cfg, mask)
    def copy(sd):
        return None if sd is None else {k: v.clone() for k, v in sd.items()}

    want = []
    for b, n in zip(tensors, noise):
        m = step(plain, b, n)
        want.append({"metrics": {k: float(v) for k, v in m.items()},
                     "g": copy(plain.generator.state_dict()), "d": copy(plain.critic.state_dict()),
                     "enc": None if plain.encoder is None else copy(plain.encoder.state_dict()),
                     "ema": copy(plain.g_ema)})
    axis = MODEL_AXIS if case == "tp" else DATA_AXIS
    assert axis in {a for a, _ in ranks[case][0]["specs"].values()}
    for rank in ranks[case]:
        _check_steps(cfg, rank["steps"], want, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_each_split_leaf_holds_its_share(gspmd, case):
    cases, _, ranks = gspmd
    cfg = cases[case][1]
    whole_state = create_train_state(cfg, 0)
    for rank in ranks[case]:
        specs = rank["specs"]
        n = {MODEL_AXIS: cfg.mesh.model, DATA_AXIS: STEP_CASES[case][4] // cfg.mesh.model}
        freed = 0
        for tree, mod in (("g", whole_state.generator), ("d", whole_state.critic),
                          ("enc", whole_state.encoder)):
            if mod is None:
                continue
            tx = getattr(whole_state, tree + "_tx")
            names = [k for k, _ in mod.named_parameters()]
            for k, t in mod.state_dict().items():
                axis, _ = specs[f"{tree}_params/{k}"]
                share = t.numel() // n[axis] if axis else t.numel()
                assert rank["stored"][tree][k] == share, (tree, k)
                copies = 1 + (2 if tx is not None and k in names else 0)
                if tree == "g" and rank["ema"] is not None:
                    assert rank["ema"][k] == share
                    copies += 1
                freed += (t.numel() - share) * t.element_size() * copies
            if tx is not None:
                for k, size in zip(names, rank["moments"][tree]):
                    axis, _ = specs[f"{tree}_opt/mu/{k}"]
                    assert size == (mod.state_dict()[k].numel() // n[axis] if axis else
                                    mod.state_dict()[k].numel())
        whole, mine = rank["bytes"]
        assert freed > 0 and mine == whole - freed


def test_collectives_pass_gradcheck_and_gradgradcheck(gspmd):
    _, _, ranks = gspmd
    for rank in ranks["tp"]:
        checks = rank["checks"]
        assert len(checks) == 7
        assert all(ok == (True, True) for ok in checks.values()), checks


# ------------------------------------------------------------ the CLI

def _gspmd_argvs(wd, steps):
    return _cli_argvs(wd, steps) + ["--set", "mesh.model=2", "--set", "mesh.fsdp=true"]


def test_four_rank_cli_resumes_bit_for_bit_and_evaluates(tmp_path):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    ports = _free_ports(2)
    first = [_start_ranks(_gspmd_argvs(whole, 2), world=4, port=ports[0]),
             _start_ranks(["-c", ONE_RANK_HOOK, "sigterm", "1", *_gspmd_argvs(cut, 2)[2:]],
                          world=4, port=ports[1])]
    runs = [_wait_ranks(p, timeout=240) for p in first]
    for out, _ in runs[0]:
        assert "[sgg.train] gspmd partition: tp=True fsdp=True" in out
        assert "[sgg.train] mesh={'data': 2, 'model': 2}" in out
        assert re.search(r"state bytes on this rank: [\d,]+ \(data parallel: [\d,]+\)", out)
        assert ("[sgg.train] steps_per_dispatch needs the single-process device-resident "
                "data path — falling back to per-step dispatch") in out
    for out, _ in runs[1]:
        assert "checkpointing at step 1 and exiting" in out
    outs = _wait_ranks(_start_ranks(_gspmd_argvs(cut, 2), world=4), timeout=240)
    assert all("resumed from step 1" in out for out, _ in outs)
    assert _same(_state(whole, 2), _state(cut, 2))
    # The checkpoint is the global state, in the single-process format.
    plain = create_train_state(get_config("smoke").override(["model.vocab_size=26"]), 0)
    plain.load_state_dict(_state(whole, 2))
    assert evaluate_cli.main(["--workdir", str(whole), "--device", "cpu", "--num-samples", "2",
                              "--k", "5"]) == 0


# ---------------------------------------------------------- the route

def _reference_route():
    """``sgg/cli/train.py``'s use_gspmd expression, from its source."""
    src = inspect.getsource(jax_train_cli)
    expr = re.search(r"use_gspmd = (mesh is not None and \(.*?\n    \))", src, re.S).group(1)
    return lambda mesh, cfg: eval(expr, {}, {"mesh": mesh, "cfg": cfg})


@pytest.mark.parametrize("world", [1, 4])
def test_route_rule_matches_the_reference(world):
    rule = _reference_route()
    for partition, model, fsdp, seq, sp in itertools.product(
            ("auto", "shard_map", "gspmd"), (1, 2), (False, True), (1, 2), ("", "ring")):
        sets = [f"mesh.partition={partition}", f"mesh.model={model}",
                f"mesh.fsdp={str(fsdp).lower()}", f"mesh.seq={seq}", f"model.sp_mode={sp}"]
        jcfg = jax_get_config("smoke")
        jcfg.mesh.partition, jcfg.mesh.model, jcfg.mesh.fsdp = partition, model, fsdp
        jcfg.mesh.seq, jcfg.model.sp_mode = seq, sp
        cfg = get_config("smoke").override(sets)
        want = rule(None if world == 1 else object(), jcfg)
        assert train_cli.gspmd_route(cfg.mesh, world) == want, sets


def test_world_of_one_trains_fsdp_plainly_and_refuses_a_model_axis(tmp_path, capsys):
    argv = ["--config", "smoke", "--device", "cpu", "--steps", "1"]
    assert train_cli.main(argv + ["--workdir", str(tmp_path / "f"), "--set",
                                  "mesh.fsdp=true"]) == 0
    assert "gspmd partition" not in capsys.readouterr().out
    assert train_cli.main(argv + ["--workdir", str(tmp_path / "m"), "--set",
                                  "mesh.model=2"]) == 2
    assert "do not divide device count 1" in capsys.readouterr().err
