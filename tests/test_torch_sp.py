"""Ring and Ulysses sequence parallelism (``sgg_torch.dist.sequence_parallel``,
the ring-shift and all-to-all collectives of ``sgg_torch.dist.multihost``,
the 'seq' mesh axis and the gspmd step with ``model.sp_mode``) against
``sgg``'s on the CPU.

- Attention: ring and Ulysses over 2 and 4 gloo ranks (a mesh axis over the
  whole world, as the reference test's ``seq_axis='data'``) against
  ``sgg.dist.sequence_parallel.make_sp_attention`` on a mesh of as many CPU
  devices, at the reference test's shapes (B 2, H 8, S 128, D 32), forward
  and the gradients of ``sum(o²)``. float32: within 1e-5 × the largest
  |value| of each tensor (the reference test holds 2e-3 against full
  attention); the ring also in bfloat16 (its partials rounded to bf16
  before the float32 merge, on both sides): within 2^-7 × the largest
  |value| (a partial's rounding flipped, which scales with |v|, and the
  final cast), with at most 1 % of the elements differing at all. float32
  also against the port's plain full attention and its autograd gradients
  within 5e-5 × max.
- Ulysses' head rule: H not divisible by the axis size is refused with the
  reference's message, on every rank.
- The ViT with each mode plugged into its attention layers equals the ViT
  without it (``tests/dist/test_vit_sp.py``): the features within 1e-5 ×
  their max, the gradients within 1e-5 × the largest gradient.
- ``gradcheck`` and ``gradgradcheck`` of the ring shift (two hops, home
  again) and of the all-to-all and its inverse over two ranks in float64:
  rank 0's input varies while rank 1 sends constants and zero cotangents.
- The gspmd step at small ViT widths (``tests/dist/test_sp_in_step.py``'s
  dims: ``vit_dims`` 64 x 2 x 4 at 64 px, 16 patches) with ``train_encoder``:
  Ulysses at data 2 x model 2 with TP over the vocabulary on the same
  group, and ring at data 2 x seq 2, each four gloo ranks against
  ``sgg``'s ``make_train_step_gspmd`` on the same mesh of CPU devices, fed
  the reference's ``jax.random`` draws at the global batch: after one and
  two steps the metrics within rtol 1e-4 and the parameters within
  ``test_torch_train._assert_params_close``'s bounds; every rank gathers
  the same state.
- The refusals: an unknown mode (by name), and the reference's own message
  for ``sp_mode`` with ``pp_microbatches`` on a mesh without 'seq'.

The three worker worlds (10 processes, no JAX) and the four reference
programs (a process each) run at once.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg.dist import MeshSpec as JaxMeshSpec
from sgg.dist import make_mesh as jax_make_mesh
from sgg.dist import place_state as jax_place_state
from sgg.dist.sequence_parallel import make_sp_attention as jax_make_sp_attention
from sgg.train.step import make_step_fn as jax_make_step_fn
from sgg.train.step import make_train_step_gspmd as jax_make_train_step_gspmd
from sgg_torch.convert_flax import (
    critic_flax_to_state_dict,
    encoder_flax_to_state_dict,
    generator_flax_to_state_dict,
    train_state_from_flax,
)
from sgg_torch.dist.mesh import Mesh
from sgg_torch.dist.sequence_parallel import make_sp_attention
from sgg_torch.train.step import make_step_fn
from test_torch_dist import _free_ports, _same, _start_ranks, _wait_ranks
from test_torch_tp_fsdp import _check_steps
from test_torch_train import VIT_SETS, _configs, _reference_state, reference_noise

torch.set_num_threads(1)

B, H, S, D = 2, 8, 128, 32
V = 24
STEPS = 2
# The attention's bounds against the reference, relative to each tensor's
# largest |value|: float32; bfloat16, and the share of its elements that may
# differ at all.
F32_TOL, BF16_TOL, BF16_SHARE = 1e-5, 2 ** -7, 0.01
# bfloat16 for the ring alone, whose partials are rounded before the merge;
# Ulysses' arithmetic is full attention's.
DTYPES = {"ring": ((jnp.float32, "torch.float32"), (jnp.bfloat16, "torch.bfloat16")),
          "ulysses": ((jnp.float32, "torch.float32"),)}

# Runs in each rank (no JAX): the attention cases, the head rule, the ViT,
# the gradient checks (as the case asks), then the case's gspmd steps.
WORKER = """
import copy, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from sgg_torch.config import Config
from sgg_torch.dist import batch_sharding, initialize_multihost, mesh_from_config
from sgg_torch.dist import multihost as mh
from sgg_torch.dist.mesh import Mesh
from sgg_torch.dist.sequence_parallel import make_sp_attention, sp_encoder
from sgg_torch.dist.sharding import gather_state, place_state, state_sharding
from sgg_torch.kernels.flash_attention import attention_reference
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn

d, case = sys.argv[1], sys.argv[2]
initialize_multihost("cpu", log=lambda m: None)
r, W, n = dist.get_rank(), dist.group.WORLD, dist.get_world_size()
blob = torch.load(f"{d}/{case}.pt", weights_only=False)
out = {}
line = Mesh(data=n, devices=("cpu",), rank=r, group=W)  # one axis over the world
modes = ("ring", "ulysses")
if "qkv" in blob:
    att = {}
    for mode in modes:
        sp = make_sp_attention(line, mode, "data")
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(x).to(dt).requires_grad_() for x in blob["qkv"])
            o = sp(q, k, v)
            (o.float() ** 2).sum().backward()
            att[(mode, str(dt))] = [t.detach().float() for t in (o, q.grad, k.grad, v.grad)]
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in blob["qkv"])
    o = attention_reference(q, k, v)
    (o ** 2).sum().backward()
    att["full"] = [t.detach() for t in (o, q.grad, k.grad, v.grad)]
    out["attention"] = att
    try:
        make_sp_attention(line, "ulysses", "data")(*(torch.zeros(1, n + 1, 2 * n, 16),) * 3)
    except ValueError as e:
        out["heads"] = str(e)
if "vit" in blob:
    from sgg_torch.models.vit import ViTB16Features
    torch.manual_seed(0)
    vit = ViTB16Features(embed_dim=64, num_heads=4, num_layers=2, num_patches=16)
    x = torch.from_numpy(blob["vit"])
    params = list(vit.parameters())

    def run():
        f = vit(x)
        return [f.detach()] + list(torch.autograd.grad((f ** 2).sum(), params))

    out["vit"] = {"plain": run()}
    for mode in modes:
        with sp_encoder(vit, make_sp_attention(line, mode, "data")):
            out["vit"][mode] = run()
    assert all(m.attn_fn is None for m in vit.modules() if hasattr(m, "attn_fn"))
if blob.get("gradcheck"):
    from torch.autograd import gradcheck, gradgradcheck
    c = torch.randn(2, 4, 6, dtype=torch.float64, generator=torch.Generator().manual_seed(9))

    def alone(fn):  # rank 0's input varies; rank 1 sends constants, zero cotangents
        return (lambda x: fn(x)) if r == 0 else (lambda x: fn(x * 0 + c) * 0)

    fns = {"ring_shift": lambda x: mh.ring_shift(mh.ring_shift(x, W, 1), W, 1),
           "ring_shift_back": lambda x: mh.ring_shift(mh.ring_shift(x, W, -1), W, -1),
           "all_to_all": lambda x: mh.all_to_all(x, W, 1, 2),
           "all_to_all_inverse": lambda x: mh.all_to_all(x, W, 2, 1)}
    checks = {}
    for name, fn in fns.items():
        torch.manual_seed(5)
        x = torch.randn(2, 4, 6, dtype=torch.float64, requires_grad=True)
        checks[name] = (bool(gradcheck(alone(fn), (x,), raise_exception=False)),
                        bool(gradgradcheck(alone(fn), (x,), raise_exception=False)))
    out["checks"] = checks
if "cfg" in blob:
    cfg = Config.from_json(blob["cfg"])
    state = create_train_state(cfg, 0)
    state.load_state_dict(blob["state"])
    mesh = mesh_from_config(cfg.mesh, "cpu")
    out["mesh"] = (mesh.shape, mesh.rank, mesh.seq_rank, mesh.model_rank)
    place_state(state, state_sharding(state, mesh, tp=cfg.mesh.model > 1), mesh)
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

SP_SETS = {**VIT_SETS, "train.train_encoder": True, "model.vocab_size": V}
# name: (world, step sets or None, what else the world runs)
WORLDS = {
    "two": (2, None, {"attention": True, "vit": True, "gradcheck": True}),
    "ring": (4, {**SP_SETS, "model.sp_mode": "ring", "mesh.seq": 2,
                 "mesh.partition": "gspmd"}, {"attention": True}),
    "ulysses": (4, {**SP_SETS, "model.sp_mode": "ulysses", "mesh.model": 2}, {}),
}
GLOBAL_B = 8  # two data coordinates of 4


def _qkv():
    r = np.random.RandomState(0)
    return [r.randn(B, H, S, D).astype(np.float32) for _ in range(3)]


def _step_inputs(sets):
    jcfg, pcfg = _configs("vit_b16", sets)
    r = np.random.RandomState(0)
    n_sub, size = jcfg.train.n_critic + 1, jcfg.data.image_size
    batches = [{"images": r.randint(0, 256, (n_sub, GLOBAL_B, size, size, 3), dtype=np.uint8),
                "triples": r.randint(2, V, (n_sub, GLOBAL_B, 3)).astype(np.int32)}
               for _ in range(STEPS)]
    mask = np.ones((3, V), bool)
    st = _reference_state(jcfg, pcfg)
    noise_fn = reference_noise(jcfg, GLOBAL_B)
    noise = [noise_fn(st.rng, s) for s in range(STEPS)]
    blob = {"cfg": pcfg.to_json(), "state": train_state_from_flax(pcfg, st).state_dict(),
            "mask": mask, "noise": noise,
            "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]}
    return jcfg, pcfg, st, mask, batches, blob


def _reference_steps(jcfg, pcfg, st, mask, batches):
    """``sgg``'s gspmd step on the case's mesh of CPU devices: the metrics
    and parameters after each step."""
    spec = JaxMeshSpec(data=2, seq=jcfg.mesh.seq, model=jcfg.mesh.model)
    mesh = jax_make_mesh(spec, devices=jax.devices()[:4])
    step, state_sh = jax_make_train_step_gspmd(jcfg, mesh, step_mask=mask,
                                               tp=jcfg.mesh.model > 1, donate=False)
    st_ = jax_place_state(st, state_sh)
    out = []
    for b in batches:
        st_, m = step(st_, b)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "g": generator_flax_to_state_dict(jax.device_get(st_.g_params), pcfg),
                    "d": critic_flax_to_state_dict(jax.device_get(st_.d_params), pcfg),
                    "enc": encoder_flax_to_state_dict(jax.device_get(st_.enc_params))})
    return out


def _reference_attention(qkv, n):
    """{(mode, dtype): [o, dq, dk, dv]} of ``sgg``'s sequence-parallel
    attention over n CPU devices, the gradients of sum(o²)."""
    mesh = jax_make_mesh(JaxMeshSpec(data=n, model=1), devices=jax.devices()[:n])
    out = {}
    for mode in ("ring", "ulysses"):
        sp = jax_make_sp_attention(mesh, mode=mode, seq_axis="data")

        def loss(q, k, v):
            o = sp(q, k, v)
            return (o.astype(jnp.float32) ** 2).sum(), o

        fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
        for dt, name in DTYPES[mode]:
            (_, o), grads = fn(*(jnp.asarray(x, dt) for x in qkv))
            out[(mode, name)] = [torch.from_numpy(np.array(t.astype(jnp.float32)))
                                 for t in (o, *grads)]
    return out


# Runs one reference program in a process of its own (its tracing holds the
# GIL, so threads would take turns): ``job`` 2 or 4 (the attention over that
# many devices) or a step case's name.
REFERENCE = """
import sys
sys.path[:0] = [sys.argv[3], sys.argv[4]]
import conftest  # 8 CPU devices
import torch
import test_torch_sp as t
job = sys.argv[2]
if job.isdigit():
    out = t._reference_attention(t._qkv(), int(job))
else:
    out = t._reference_steps(*t._step_inputs(t.WORLDS[job][1])[:5])
torch.save(out, sys.argv[1])
"""


def _start_reference(d, job):
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, os.path.join(d, f"ref_{job}.pt"), str(job), here,
         os.path.dirname(here)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """Every worker world and every reference program run at once."""
    d = str(tmp_path_factory.mktemp("sp"))
    qkv = _qkv()
    steps, procs = {}, {}
    for name, port in zip(WORLDS, _free_ports(len(WORLDS))):
        world, sets, extra = WORLDS[name]
        blob = {}
        if extra.get("attention"):
            blob["qkv"] = qkv
        if extra.get("vit"):
            blob["vit"] = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
        blob["gradcheck"] = bool(extra.get("gradcheck"))
        if sets is not None:
            steps[name] = _step_inputs(sets)
            blob.update(steps[name][-1])
        torch.save(blob, os.path.join(d, f"{name}.pt"))
        procs[name] = _start_ranks(["-c", WORKER, d, name], world=world, port=port)
    jobs = [2, 4, *steps]
    refs = [_start_reference(d, job) for job in jobs]
    try:
        _wait_ranks(refs, timeout=300)
    finally:
        for p in procs.values():
            _wait_ranks(p, timeout=300)
    ref = {job: torch.load(os.path.join(d, f"ref_{job}.pt"), weights_only=False)
           for job in jobs}
    ref = {"attention": {n: ref[n] for n in (2, 4)}, "steps": {k: ref[k] for k in steps}}
    ranks = {name: [torch.load(os.path.join(d, f"{name}_rank{r}.pt"), weights_only=False)
                    for r in range(WORLDS[name][0])] for name in WORLDS}
    return steps, ref, ranks


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode,dtype", [(m, name) for m, dts in DTYPES.items()
                                        for _, name in dts])
def test_sp_attention_and_gradients_match_the_reference(sp_runs, n, mode, dtype):
    _, ref, ranks = sp_runs
    world = "two" if n == 2 else "ring"
    want = ref["attention"][n][(mode, dtype)]
    for rank in ranks[world]:  # the output and gradients are replicated
        got = rank["attention"][(mode, dtype)]
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            err = ((g - w).abs().max() / w.abs().max()).item()
            if dtype == "torch.float32":
                assert err <= F32_TOL, (name, err)
            else:
                assert err <= BF16_TOL and (g != w).float().mean() <= BF16_SHARE, (name, err)
        if dtype == "torch.float32":  # and the plain full attention's
            for name, g, w in zip(("o", "dq", "dk", "dv"), got, rank["attention"]["full"]):
                err = (g.double() - w.double()).abs().max() / w.abs().max()
                assert err <= 5e-5, (name, err.item())


@pytest.mark.parametrize("world", ["two", "ring"])
def test_ulysses_refuses_heads_that_do_not_divide(sp_runs, world):
    _, _, ranks = sp_runs
    n = WORLDS[world][0]
    for rank in ranks[world]:
        assert rank["heads"] == f"ulysses needs heads ({n + 1}) divisible by axis size ({n})"


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_vit_with_sp_equals_the_vit_without(sp_runs, mode):
    _, _, ranks = sp_runs
    for rank in ranks["two"]:
        (f, *g), (f0, *g0) = rank["vit"][mode], rank["vit"]["plain"]
        assert (f - f0).abs().max() <= 1e-5 * f0.abs().max()
        # Against the largest gradient of all: some are rounding noise (the
        # key bias's, which the softmax cancels).
        top = max(w.abs().max() for w in g0)
        assert max((a - b).abs().max() for a, b in zip(g, g0)) <= 1e-5 * top


def test_ring_shift_and_all_to_all_pass_gradcheck_and_gradgradcheck(sp_runs):
    _, _, ranks = sp_runs
    for rank in ranks["two"]:
        checks = rank["checks"]
        assert len(checks) == 4
        assert all(ok == (True, True) for ok in checks.values()), checks


@pytest.mark.parametrize("case", ["ring", "ulysses"])
def test_gspmd_step_with_sp_matches_the_reference(sp_runs, case):
    steps, ref, ranks = sp_runs
    pcfg = steps[case][1]
    seq, model = pcfg.mesh.seq, pcfg.mesh.model
    for r, rank in enumerate(ranks[case]):
        d, s, m = r // (seq * model), r // model % seq, r % model
        want_shape = {"data": 2, "seq": 2, "model": 1} if seq > 1 else {"data": 2, "model": 2}
        assert rank["mesh"] == (want_shape, d, s, m)
        _check_steps(pcfg, rank["steps"], ref["steps"][case], rtol=1e-4)
    for rank in ranks[case][1:]:
        for a, b in zip(rank["steps"], ranks[case][0]["steps"]):
            assert a["metrics"] == b["metrics"] and _same(a["state"], b["state"])


def test_unknown_mode_and_pp_without_seq_are_refused():
    line = Mesh(data=1, devices=("cpu",))
    with pytest.raises(ValueError, match="unknown sp_mode 'zigzag' .*ring, ulysses"):
        make_sp_attention(line, "zigzag", "data")
    sets = {**SP_SETS, "model.sp_mode": "ring", "model.pp_microbatches": 2, "mesh.model": 2,
            "train.train_encoder": False}
    jcfg, pcfg = _configs("vit_b16", sets)
    with pytest.raises(ValueError) as want:
        jax_make_step_fn(jcfg, sp_mesh=jax_make_mesh(JaxMeshSpec(data=2, model=2),
                                                     devices=jax.devices()[:4]))
    with pytest.raises(ValueError) as got:
        make_step_fn(pcfg, mesh=Mesh(data=2, devices=("cpu",), model=2))
    assert str(got.value) == str(want.value)
    assert "contend for the single 'model' axis" in str(got.value)
