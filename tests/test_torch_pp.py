"""Pipeline parallelism (``sgg_torch.dist.pipeline_parallel`` and
``model.pp_microbatches`` in the gspmd step) against ``sgg``'s on the CPU.

- ``pipeline_apply`` with the reference test's stage (``tanh(x @ w + b)``)
  at (stages, microbatches) (4, 4) and (4, 8) over a model axis of four
  gloo ranks, and (2, 2) over the model axis of a data 2 x model 2 world
  (its batch whole on every rank), against ``sgg``'s ``pipeline_apply`` on
  as many CPU devices: within rtol 1e-5, atol 1e-6
  (``tests/dist/test_pipeline_parallel.py``).
- ``pipeline_vit_features`` (a ViT of width 32, 4 heads, 4 layers at 32 px)
  at data 2 x model 2, and at seq 2 x model 2 with the ring and with
  Ulysses (each seq rank carrying its S/2 patch rows), against ``sgg``'s
  on the same mesh: within rtol and atol 2e-5 (``tests/dist/
  test_dp_sp_pp.py``).
- The gspmd step with PP on the reference test's tiny ViT GAN in float32
  (width 128, 2 layers, 4 heads at 32 px, B 8, n_critic 2, TP over the
  vocabulary on the model group as the CLI turns it on) at data 2 x model 2, and DP×SP×PP
  (ring over 'seq') at seq 2 x model 2, each four gloo ranks against
  ``sgg``'s ``make_train_step_gspmd`` on the same mesh, fed the reference's
  ``jax.random`` draws at the global batch: after one and two steps the
  metrics within rtol 1e-4 and the parameters within
  ``test_torch_train._assert_params_close``'s bounds; every rank gathers
  the same state.
- The refusals by the reference's messages: ``train.train_encoder`` with
  PP, PP with expert-parallel MoE, and the stage and microbatch
  divisibility errors.

The three worker worlds (12 processes, no JAX) and the reference programs
(three processes) run at once.
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
from sgg.dist.pipeline_parallel import pipeline_apply as jax_pipeline_apply
from sgg.dist.pipeline_parallel import pipeline_vit_features as jax_pipeline_vit_features
from sgg.dist.pipeline_parallel import stack_layer_params as jax_stack_layer_params
from sgg.models.vit import ViTB16Features as JaxViT
from sgg.train.step import make_step_fn as jax_make_step_fn
from sgg.train.step import make_train_step_gspmd as jax_make_train_step_gspmd
from sgg_torch.convert_flax import (
    critic_flax_to_state_dict,
    encoder_flax_to_state_dict,
    encoder_state_dict_to_flax,
    generator_flax_to_state_dict,
    train_state_from_flax,
)
from sgg_torch.dist.mesh import Mesh
from sgg_torch.dist.pipeline_parallel import pipeline_apply, stack_layer_params
from sgg_torch.models.vit import ViTB16Features
from sgg_torch.train.step import make_step_fn
from test_torch_dist import _free_ports, _same, _start_ranks, _wait_ranks
from test_torch_tp_fsdp import _check_steps
from test_torch_train import _configs, _reference_state, reference_noise

torch.set_num_threads(1)

STEPS, GLOBAL_B, V = 2, 8, 64
D, B = 16, 16  # pipeline_apply's width and batch
APPLY_TOL = dict(rtol=1e-5, atol=1e-6)
VIT_TOL = dict(rtol=2e-5, atol=2e-5)
# The reference test's tiny ViT GAN (tests/dist/test_pipeline_parallel.py).
PP_SETS = {"model.decoder": "lstm", "model.vocab_size": V, "model.hidden": 32,
           "model.embed_dim": 16, "model.attn_dim": 16, "model.noise_dim": 8,
           "model.critic_hidden": 32, "model.vit_dim": 128, "model.vit_layers": 2,
           "model.vit_heads": 4, "data.image_size": 32, "data.regions": 4,
           "data.feat_dim": 128, "train.n_critic": 2, "train.batch_size": GLOBAL_B,
           "model.pp_microbatches": 4, "mesh.partition": "gspmd",
           "model.compute_dtype": "float32"}
# name: (world, mesh (data, seq, model), pipeline_apply cases (stages, micro),
# pipeline_vit_features modes, the step's extra sets or None)
WORLDS = {
    "stages4": (4, (1, 1, 4), [(4, 4), (4, 8)], [], None),
    "dp_pp": (4, (2, 1, 2), [(2, 2)], [None], {"mesh.model": 2}),
    "sp_pp": (4, (1, 2, 2), [], ["ring", "ulysses"],
              {"mesh.model": 2, "mesh.seq": 2, "model.sp_mode": "ring"}),
}

# Runs in each rank (no JAX): its world's pipeline_apply cases, its
# pipeline_vit_features cases, then its gspmd steps.
WORKER = """
import copy, sys, types
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from sgg_torch.config import Config
from sgg_torch.dist import batch_sharding, initialize_multihost, mesh_from_config
from sgg_torch.dist.pipeline_parallel import pipeline_apply, pipeline_vit_features
from sgg_torch.dist.sharding import gather_state, place_state, state_sharding
from sgg_torch.models.vit import ViTB16Features
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn

d, case = sys.argv[1], sys.argv[2]
initialize_multihost("cpu", log=lambda m: None)
r = dist.get_rank()
blob = torch.load(f"{d}/{case}.pt", weights_only=False)
data, seq, model = blob["mesh"]
mesh = mesh_from_config(types.SimpleNamespace(data=data, seq=seq, model=model, expert=1), "cpu")
out = {"mesh": (mesh.shape, mesh.rank, mesh.seq_rank, mesh.model_rank)}


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


out["apply"] = {}
for (n_stages, n_micro), (stacked, x) in blob["apply"].items():
    out["apply"][(n_stages, n_micro)] = pipeline_apply(
        stage_fn, stacked, x, mesh, axis_name="model", num_microbatches=n_micro)
if blob["vit_modes"]:
    vit = ViTB16Features(embed_dim=32, num_heads=4, num_layers=4, num_patches=4)
    vit.load_state_dict(blob["vit_state"])
    x = batch_sharding(mesh, leading_stacked=False).local(blob["vit_x"])
    out["vit"] = {}
    for mode in blob["vit_modes"]:
        out["vit"][mode] = pipeline_vit_features(
            vit, x, mesh, num_microbatches=4, batch_axis="data",
            seq_axis=None if mode is None else "seq", sp_mode=mode or "ring")
if "cfg" in blob:
    cfg = Config.from_json(blob["cfg"])
    state = create_train_state(cfg, 0)
    state.load_state_dict(blob["state"])
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


def _apply_inputs(n_stages):
    r = np.random.RandomState(0)
    w = (r.randn(n_stages, D, D) * 0.5).astype(np.float32)
    b = (r.randn(n_stages, D) * 0.1).astype(np.float32)
    x = r.randn(B, D).astype(np.float32)
    return w, b, x


def _vit_inputs():
    """(the port ViT's state_dict from a seed, images [8, 32, 32, 3])."""
    torch.manual_seed(0)
    vit = ViTB16Features(embed_dim=32, num_heads=4, num_layers=4, num_patches=4)
    x = np.random.RandomState(0).rand(8, 32, 32, 3).astype(np.float32)
    return vit.state_dict(), x


def _step_inputs(sets):
    jcfg, pcfg = _configs("vit_b16", {**PP_SETS, **sets})
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


def _jax_mesh(data, seq, model):
    return jax_make_mesh(JaxMeshSpec(data=data, seq=seq, model=model),
                         devices=jax.devices()[:data * seq * model])


def _reference_steps(name):
    """``sgg``'s gspmd step on the world's mesh of CPU devices (TP over the
    vocabulary, as the CLI turns it on): the metrics and parameters after
    each step."""
    jcfg, pcfg, st, mask, batches, _ = _step_inputs(WORLDS[name][4])
    step, state_sh = jax_make_train_step_gspmd(jcfg, _jax_mesh(*WORLDS[name][1]),
                                               step_mask=mask, tp=True, donate=False)
    st_ = jax_place_state(st, state_sh)
    out = []
    for b in batches:
        st_, m = step(st_, b)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "g": generator_flax_to_state_dict(jax.device_get(st_.g_params), pcfg),
                    "d": critic_flax_to_state_dict(jax.device_get(st_.d_params), pcfg),
                    "enc": encoder_flax_to_state_dict(jax.device_get(st_.enc_params))})
    return out


def _reference_pipelines():
    """{("apply", stages, micro): y} of ``sgg``'s pipeline_apply and
    {("vit", world, mode): features} of its pipeline_vit_features."""
    out = {}

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    for name, (_, mesh_dims, cases, modes, _) in WORLDS.items():
        mesh = _jax_mesh(*mesh_dims)
        for n_stages, n_micro in cases:
            w, b, x = _apply_inputs(n_stages)
            y = jax.jit(lambda p, x_, n_=n_micro, mesh_=mesh: jax_pipeline_apply(
                stage_fn, p, x_, mesh_, axis_name="model", num_microbatches=n_))(
                {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
            out[("apply", n_stages, n_micro)] = np.asarray(y)
        if modes:
            sd, x = _vit_inputs()
            m = JaxViT(embed_dim=32, num_heads=4, num_layers=4, num_patches=4, patch=16)
            v = jax.tree.map(jnp.asarray, encoder_state_dict_to_flax(sd, "vit_b16"))
            for mode in modes:
                f = jax.jit(lambda v_, x_, mode_=mode, mesh_=mesh: jax_pipeline_vit_features(
                    m, v_, x_, mesh_, num_microbatches=4, batch_axis="data",
                    seq_axis=None if mode_ is None else "seq", sp_mode=mode_ or "ring"))(
                    v, jnp.asarray(x))
                out[("vit", name, mode)] = np.asarray(f)
    return out


# One reference program in a process of its own: ``job`` "pipelines" or a
# world's name (its gspmd steps).
REFERENCE = """
import sys
sys.path[:0] = [sys.argv[3], sys.argv[4]]
import conftest  # 8 CPU devices
import torch
import test_torch_pp as t
job = sys.argv[2]
out = t._reference_pipelines() if job == "pipelines" else t._reference_steps(job)
torch.save(out, sys.argv[1])
"""


def _start_reference(d, job):
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, os.path.join(d, f"ref_{job}.pt"), job, here,
         os.path.dirname(here)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """Every worker world and every reference program run at once."""
    d = str(tmp_path_factory.mktemp("pp"))
    steps, procs = {}, {}
    sd, vit_x = _vit_inputs()
    for name, port in zip(WORLDS, _free_ports(len(WORLDS))):
        world, mesh_dims, cases, modes, sets = WORLDS[name]
        blob = {"mesh": mesh_dims, "vit_modes": modes, "vit_state": sd,
                "vit_x": torch.from_numpy(vit_x), "apply": {}}
        for n_stages, n_micro in cases:
            w, b, x = _apply_inputs(n_stages)
            blob["apply"][(n_stages, n_micro)] = (
                {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
        if sets is not None:
            steps[name] = _step_inputs(sets)
            blob.update(steps[name][-1])
        torch.save(blob, os.path.join(d, f"{name}.pt"))
        procs[name] = _start_ranks(["-c", WORKER, d, name], world=world, port=port)
    jobs = ["pipelines", *steps]
    refs = [_start_reference(d, job) for job in jobs]
    try:
        _wait_ranks(refs, timeout=300)
    finally:
        for p in procs.values():
            _wait_ranks(p, timeout=300)
    ref = {job: torch.load(os.path.join(d, f"ref_{job}.pt"), weights_only=False)
           for job in jobs}
    ranks = {name: [torch.load(os.path.join(d, f"{name}_rank{r}.pt"), weights_only=False)
                    for r in range(WORLDS[name][0])] for name in WORLDS}
    return steps, ref, ranks


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (4, 8), (2, 2)])
def test_pipeline_apply_matches_the_reference(pp_runs, n_stages, n_micro):
    _, ref, ranks = pp_runs
    world = "stages4" if n_stages == 4 else "dp_pp"
    want = ref["pipelines"][("apply", n_stages, n_micro)]
    w, b, x = _apply_inputs(n_stages)
    seq = x
    for s in range(n_stages):  # and the plain sequential stack
        seq = np.tanh(seq @ w[s] + b[s])
    np.testing.assert_allclose(want, seq, rtol=1e-5, atol=1e-6)
    for rank in ranks[world]:  # every rank holds the result
        np.testing.assert_allclose(rank["apply"][(n_stages, n_micro)].numpy(), want,
                                   **APPLY_TOL)


@pytest.mark.parametrize("world,mode", [("dp_pp", None), ("sp_pp", "ring"),
                                        ("sp_pp", "ulysses")])
def test_pipeline_vit_features_match_the_reference(pp_runs, world, mode):
    _, ref, ranks = pp_runs
    want = ref["pipelines"][("vit", world, mode)]
    data = WORLDS[world][1][0]
    per = want.shape[0] // data
    for rank in ranks[world]:
        d = rank["mesh"][1]
        np.testing.assert_allclose(rank["vit"][mode].numpy(), want[d * per:(d + 1) * per],
                                   **VIT_TOL)


@pytest.mark.parametrize("world", ["dp_pp", "sp_pp"])
def test_gspmd_step_with_pp_matches_the_reference(pp_runs, world):
    steps, ref, ranks = pp_runs
    pcfg = steps[world][1]
    data, seq, model = WORLDS[world][1]
    for r, rank in enumerate(ranks[world]):
        shape = {"data": data, "seq": seq, "model": model} if seq > 1 else \
            {"data": data, "model": model}
        assert rank["mesh"] == (shape, r // (seq * model), r // model % seq, r % model)
        _check_steps(pcfg, rank["steps"], ref[world], rtol=1e-4)
    for rank in ranks[world][1:]:
        for a, b in zip(rank["steps"], ranks[world][0]["steps"]):
            assert a["metrics"] == b["metrics"] and _same(a["state"], b["state"])


def _refusal_pair(sets, jax_mesh, port_mesh):
    jcfg, pcfg = _configs("vit_b16", {**PP_SETS, **sets})
    with pytest.raises(ValueError) as want:
        jax_make_step_fn(jcfg, sp_mesh=jax_mesh)
    with pytest.raises(ValueError) as got:
        make_step_fn(pcfg, mesh=port_mesh)
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_train_encoder_and_expert_parallel_moe_with_pp_are_refused():
    msg = _refusal_pair({"train.train_encoder": True, "mesh.model": 2},
                        _jax_mesh(2, 1, 2), Mesh(data=2, devices=("cpu",), model=2))
    assert "incompatible with model.pp_microbatches" in msg
    msg = _refusal_pair(
        {"model.moe_experts": 4, "mesh.model": 2, "mesh.expert": 2},
        jax_make_mesh(JaxMeshSpec(data=2, expert=2, model=2), devices=jax.devices()[:8]),
        Mesh(data=2, devices=("cpu",), model=2, expert=2))
    assert "expert-parallel MoE is unsupported" in msg


def test_stage_and_microbatch_divisibility_are_refused():
    def stage_fn(p, x):
        return x

    one = {"w": np.zeros((2, 4, 4), np.float32)}
    cases = [  # (reference x, port x (this rank's rows), mesh (data, model), kw)
        (np.zeros((5, 4)), np.zeros((5, 4)), (1, 2), {"num_microbatches": 2}),
        (np.zeros((12, 4)), np.zeros((6, 4)), (2, 2),
         {"num_microbatches": 4, "batch_axis": "data"}),
        (np.zeros((4, 5, 4)), np.zeros((4, 5, 4)), (1, 2),
         {"num_microbatches": 2, "seq_axis": "seq"}),
    ]
    for jx, px, (data, model), kw in cases:
        seq = 2 if "seq_axis" in kw else 1
        jmesh = jax_make_mesh(JaxMeshSpec(data=data, seq=seq, model=model),
                              devices=jax.devices()[:data * seq * model])
        with pytest.raises(ValueError) as want:
            jax_pipeline_apply(stage_fn, jax.tree.map(jnp.asarray, one), jnp.asarray(jx),
                               jmesh, **kw)
        with pytest.raises(ValueError) as got:
            pipeline_apply(stage_fn, {"w": torch.zeros(2, 4, 4)}, torch.from_numpy(px),
                           Mesh(data=data, devices=("cpu",), model=model, seq=seq), **kw)
        assert str(got.value) == str(want.value)
        assert "divisible" in str(got.value)
    layers = {f"block{i}": {"w": jnp.zeros((2,))} for i in range(3)}
    with pytest.raises(ValueError) as want:
        jax_stack_layer_params(layers, "block", 3, 2)
    with pytest.raises(ValueError) as got:
        stack_layer_params({f"block{i}.w": torch.zeros(2) for i in range(3)}, "block", 3, 2)
    assert str(got.value) == str(want.value) == "3 layers not divisible into 2 stages"
