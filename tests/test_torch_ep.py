"""Expert parallelism (``sgg_torch.dist.expert_parallel``, the 'expert' mesh
axis, its storage rule and ``mesh.expert`` in the gspmd step) against
``sgg``'s on the CPU.

- ``moe_forward_ep`` at data 2 x expert 2 and data 1 x expert 4, four gloo
  ranks each, at the reference test's shapes (M 16, H 32, E 8, S 12, G 8,
  top-2, capacity factor 1.5; ``tests/dist/test_expert_parallel.py``),
  against ``sgg``'s ``moe_forward_ep`` on a mesh of as many CPU devices: y
  within rtol 2e-5, atol 2e-6; aux (the reference's EP term, the mean of
  the shards' terms) within 1e-6; the gradients of mean(y²) and of aux with
  respect to router, wi, wo and x within 1e-5 × each one's largest |value|,
  each rank's reduced as the step reduces them (the parameters' averaged
  over 'data'; x's rows of its data coordinate).
- The indivisible-experts error by the reference's message, on every rank,
  and from the gspmd step, which decides EP from the mesh; the step's
  refusal of a state not placed over the 'expert' axis.
- The gspmd step with ``train_encoder`` on a MoE ViT (4 experts, top-2) in
  float32 at data 2 x expert 2, four gloo ranks against ``sgg``'s
  ``make_train_step_gspmd`` on the same mesh, fed the reference's
  ``jax.random`` draws at the global batch: after one and two steps the
  metrics (``moe_aux`` the EP term) within rtol 1e-4 and the parameters
  within ``test_torch_train._assert_params_close``'s bounds; every rank
  gathers the same state, and holds half the experts.
- ``state_sharding`` with an 'expert' axis leaf by leaf against the
  reference's (EP before TP and FSDP), and ``mesh_from_config`` reaching
  ``mesh.expert`` with the rank order ``((d·seq + s)·expert + e)·model + m``.

The two worker worlds (8 processes, no JAX) and the reference programs
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

from sgg.config import Config as JaxConfig
from sgg.dist import MeshSpec as JaxMeshSpec
from sgg.dist import make_mesh as jax_make_mesh
from sgg.dist import mesh_from_config as jax_mesh_from_config
from sgg.dist import place_state as jax_place_state
from sgg.dist.expert_parallel import moe_forward_ep as jax_moe_forward_ep
from sgg.dist.sharding import state_sharding as jax_state_sharding
from sgg.models.moe import moe_capacity
from sgg.train.state import create_train_state as jax_create_train_state
from sgg.train.step import make_train_step_gspmd as jax_make_train_step_gspmd
from sgg_torch.convert_flax import (
    critic_flax_to_state_dict,
    encoder_flax_to_state_dict,
    generator_flax_to_state_dict,
    train_state_from_flax,
)
from sgg_torch.dist.mesh import EXPERT_AXIS, Mesh, MeshSpec, make_mesh
from sgg_torch.dist.sharding import state_sharding
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn
from test_torch_dist import _free_ports, _same, _start_ranks, _wait_ranks
from test_torch_tp_fsdp import _check_steps, _port_leaves, _reference_leaves
from test_torch_train import VIT_SETS, _configs, _reference_state, reference_noise

torch.set_num_threads(1)

M, H, E, S, G, TOP_K = 16, 32, 8, 12, 8, 2
CAP = moe_capacity(E, TOP_K, S, 1.5)
STEPS, GLOBAL_B, V = 2, 8, 24
EP_SETS = {**VIT_SETS, "train.train_encoder": True, "model.vocab_size": V,
           "model.moe_experts": 4, "mesh.expert": 2, "mesh.partition": "gspmd"}
# name: (world, mesh (data, expert), runs the gspmd step)
WORLDS = {"d2e2": (4, (2, 2), True), "d1e4": (4, (1, 4), False)}

# Runs in each rank (no JAX): the layer's forward, aux and gradients, the
# indivisible-experts error, then the world's gspmd steps.
WORKER = """
import copy, sys, types
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from sgg_torch.config import Config
from sgg_torch.dist import batch_sharding, initialize_multihost, mesh_from_config
from sgg_torch.dist import multihost as mh
from sgg_torch.dist.expert_parallel import moe_forward_ep
from sgg_torch.dist.sharding import gather_state, place_state, state_sharding
from sgg_torch.train.state import create_train_state
from sgg_torch.train.step import make_step_fn

d, case = sys.argv[1], sys.argv[2]
initialize_multihost("cpu", log=lambda m: None)
r = dist.get_rank()
blob = torch.load(f"{d}/{case}.pt", weights_only=False)
data, expert = blob["mesh"]
mesh = mesh_from_config(types.SimpleNamespace(data=-1, seq=1, model=1, expert=expert), "cpu")
out = {"mesh": (mesh.shape, mesh.rank, mesh.expert_rank)}
rows = batch_sharding(mesh, leading_stacked=False)
names = ("router", "wi", "wo")
layer = {}
for what in ("y", "aux"):
    params = {k: v.clone().requires_grad_() for k, v in blob["params"].items()}
    x = rows.local(blob["x"]).clone().requires_grad_()
    y, aux = moe_forward_ep(params, x, mesh, blob["top_k"], blob["cap"])
    loss = (y ** 2).mean() if what == "y" else aux
    grads = torch.autograd.grad(loss, [params[k] for k in names] + [x], allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip([params[k] for k in names] + [x], grads)]
    # As the step reduces them: the parameters' averaged over 'data'; x's
    # rows are this data coordinate's, whose loss is 1/data of the global.
    reduced = mh.pmean(grads[:3], mesh.group) if mesh.group is not None else grads[:3]
    layer[what] = {"y": y.detach(), "aux": aux.detach(),
                   "grads": dict(zip(names, reduced)), "x_grad": grads[3] / mesh.data}
out["layer"] = layer
try:
    moe_forward_ep(dict(blob["params"], wi=blob["params"]["wi"][:6]), rows.local(blob["x"]),
                   mesh, blob["top_k"], blob["cap"])
except ValueError as e:
    out["indivisible"] = str(e)
if "cfg" in blob:
    cfg = Config.from_json(blob["cfg"])
    state = create_train_state(cfg, 0)
    state.load_state_dict(blob["state"])
    place_state(state, state_sharding(state, mesh), mesh)
    out["experts_held"] = state.encoder.block0.moe.wi.shape[0]
    out["ep_mesh"] = all(b.moe.ep_mesh is mesh for b in (state.encoder.block0,
                                                          state.encoder.block1))
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


def _layer_inputs():
    """The reference test's params and x (``RandomState(0)``)."""
    rng = np.random.RandomState(0)
    params = {"router": rng.randn(M, E).astype(np.float32) * 0.1,
              "wi": rng.randn(E, M, H).astype(np.float32) * 0.1,
              "wo": rng.randn(E, H, M).astype(np.float32) * 0.1}
    return params, rng.randn(G, S, M).astype(np.float32)


def _step_inputs():
    jcfg, pcfg = _configs("vit_b16", EP_SETS)
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


def _jax_mesh(data, expert):
    return jax_make_mesh(JaxMeshSpec(data=data, expert=expert),
                         devices=jax.devices()[:data * expert])


def _reference_layer(data, expert):
    """{"y"|"aux": {y, aux, grads of router/wi/wo, x_grad}} of ``sgg``'s
    moe_forward_ep on a data x expert mesh: the loss mean(y²), or aux."""
    params, x = _layer_inputs()
    p = jax.tree.map(jnp.asarray, params)
    mesh = _jax_mesh(data, expert)
    fn = jax.jit(lambda p_, x_: jax_moe_forward_ep(p_, x_, mesh, TOP_K, CAP))
    out = {}
    for what in ("y", "aux"):
        def loss(p_, x_, what=what):
            y, aux = fn(p_, x_)
            return ((y ** 2).mean() if what == "y" else aux), (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
        out[what] = {"y": np.asarray(y), "aux": float(aux),
                     "grads": {k: np.asarray(v) for k, v in gp.items()},
                     "x_grad": np.asarray(gx)}
    bad = dict(p, wi=p["wi"][:6])
    try:
        jax_moe_forward_ep(bad, jnp.asarray(x), _jax_mesh(2, 4), TOP_K, CAP)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _reference_steps():
    """``sgg``'s gspmd step on the data 2 x expert 2 mesh of CPU devices:
    the metrics and parameters after each step."""
    jcfg, pcfg, st, mask, batches, _ = _step_inputs()
    step, state_sh = jax_make_train_step_gspmd(jcfg, _jax_mesh(2, 2), step_mask=mask,
                                               donate=False)
    st_ = jax_place_state(st, state_sh)
    out = []
    for b in batches:
        st_, m = step(st_, b)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "g": generator_flax_to_state_dict(jax.device_get(st_.g_params), pcfg),
                    "d": critic_flax_to_state_dict(jax.device_get(st_.d_params), pcfg),
                    "enc": encoder_flax_to_state_dict(jax.device_get(st_.enc_params))})
    return out


# One reference program in a process of its own: ``job`` a world's name
# (the layer on its mesh) or "steps".
REFERENCE = """
import sys
sys.path[:0] = [sys.argv[3], sys.argv[4]]
import conftest  # 8 CPU devices
import torch
import test_torch_ep as t
job = sys.argv[2]
out = t._reference_steps() if job == "steps" else t._reference_layer(*t.WORLDS[job][1])
torch.save(out, sys.argv[1])
"""


def _start_reference(d, job):
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, os.path.join(d, f"ref_{job}.pt"), job, here,
         os.path.dirname(here)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """Every worker world and every reference program run at once."""
    d = str(tmp_path_factory.mktemp("ep"))
    params, x = _layer_inputs()
    steps, procs = None, {}
    for name, port in zip(WORLDS, _free_ports(len(WORLDS))):
        world, mesh_dims, with_step = WORLDS[name]
        blob = {"mesh": mesh_dims, "params": {k: torch.from_numpy(v) for k, v in params.items()},
                "x": torch.from_numpy(x), "top_k": TOP_K, "cap": CAP}
        if with_step:
            steps = _step_inputs()
            blob.update(steps[-1])
        torch.save(blob, os.path.join(d, f"{name}.pt"))
        procs[name] = _start_ranks(["-c", WORKER, d, name], world=world, port=port)
    jobs = [*WORLDS, "steps"]
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


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("what", ["y", "aux"])
def test_moe_forward_ep_and_its_gradients_match_the_reference(ep_runs, world, what):
    _, ref, ranks = ep_runs
    want = ref[world][what]
    data, expert = WORLDS[world][1]
    per = G // data
    for r, rank in enumerate(ranks[world]):
        d = r // expert
        assert rank["mesh"] == ({"data": data, "expert": expert, "model": 1}, d, r % expert)
        got = rank["layer"][what]
        rows = slice(d * per, (d + 1) * per)
        np.testing.assert_allclose(got["y"].numpy(), want["y"][rows], rtol=2e-5, atol=2e-6)
        assert abs(float(got["aux"]) - want["aux"]) <= 1e-6
        for k, g in {**got["grads"], "x": got["x_grad"]}.items():
            w = want["grads"][k] if k != "x" else want["x_grad"][rows]
            scale = max(1e-8, np.abs(want["grads"][k] if k != "x" else want["x_grad"]).max())
            assert np.abs(g.numpy() - w).max() <= 1e-5 * scale, (k, world, what)


def test_indivisible_experts_are_refused_with_the_reference_message(ep_runs):
    _, ref, ranks = ep_runs
    want = ref["d1e4"]["indivisible"]
    assert want == "num_experts 6 not divisible by 'expert' axis size 4"
    assert all(rank["indivisible"] == want for rank in ranks["d1e4"])


def test_gspmd_step_refuses_indivisible_experts_with_the_reference_message(ep_runs):
    """The step decides EP from the mesh, as ``sgg/train/step.py:151-163``
    does: 6 experts over an 'expert' axis of 4 raise, where the storage rule
    alone would leave them replicated."""
    _, ref, _ = ep_runs
    _, pcfg = _configs("vit_b16", {**EP_SETS, "model.moe_experts": 6, "mesh.expert": 4})
    with pytest.raises(ValueError) as got:
        make_step_fn(pcfg, mesh=Mesh(data=1, devices=("cpu",), expert=4))
    assert str(got.value) == ref["d1e4"]["indivisible"]


def test_gspmd_step_refuses_a_state_not_placed_over_the_expert_axis():
    _, pcfg = _configs("vit_b16", EP_SETS)
    step = make_step_fn(pcfg, mesh=Mesh(data=1, devices=("cpu",), expert=2))
    with pytest.raises(ValueError, match="place_state"):
        step(create_train_state(pcfg, 0), {})


def test_gspmd_step_with_ep_matches_the_reference(ep_runs):
    steps, ref, ranks = ep_runs
    pcfg = steps[1]
    for rank in ranks["d2e2"]:
        assert rank["experts_held"] == 2 and rank["ep_mesh"]
        assert "moe_aux" in rank["steps"][0]["metrics"]
        _check_steps(pcfg, rank["steps"], ref["steps"], rtol=1e-4)
    for rank in ranks["d2e2"][1:]:
        for a, b in zip(rank["steps"], ranks["d2e2"][0]["steps"]):
            assert a["metrics"] == b["metrics"] and _same(a["state"], b["state"])


def test_state_sharding_with_an_expert_axis_matches_the_reference_leaf_by_leaf():
    sets = {**EP_SETS, "train.ema_decay": 0.99}
    jcfg, pcfg = _configs("vit_b16", sets)
    abstract = jax.eval_shape(lambda k: jax_create_train_state(jcfg, k), jax.random.key(0))
    jmesh = jax_make_mesh(JaxMeshSpec(data=2, expert=2, model=2))
    want = _reference_leaves(jax_state_sharding(abstract, jmesh, tp=True, fsdp=True,
                                                fsdp_min_size=64), jcfg.model.decoder)
    state = create_train_state(pcfg, 0)
    specs = state_sharding(state, Mesh(data=2, devices=("cpu",), model=2, expert=2),
                           tp=True, fsdp=True, fsdp_min_size=64)
    got = _port_leaves(specs)
    assert got == {k: v for k, v in want.items() if k[1] != "scalar"}
    experts = {k for k, (a, _) in got.items() if a == EXPERT_AXIS}
    assert experts and all(k[2].split(".")[-1] in ("wi", "wo") and ".moe." in k[2]
                           for k in experts)


def test_mesh_from_config_reaches_the_expert_axis(monkeypatch):
    jcfg = JaxConfig.from_dict({"mesh": {"data": 2, "expert": 4}})
    want = dict(jax_mesh_from_config(jcfg.mesh).shape)
    assert want == {"data": 2, "expert": 4, "model": 1}
    assert make_mesh(MeshSpec(data=2, expert=4), devices=["cpu"] * 8).shape == want
    from sgg_torch.config import Config

    cfg = Config.from_dict({"mesh": {"data": 2, "expert": 4}})
    assert cfg.mesh.expert == 4
    # Across 8 ranks: the groups that mesh_from_config forms on each.
    import torch.distributed as dist

    from sgg_torch.dist import mesh as mesh_mod

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
    for r in range(8):
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=r: r)
        mesh = mesh_mod.mesh_from_config(cfg.mesh, "cpu")
        d, e = divmod(r, 4)
        assert mesh.shape == want and (mesh.rank, mesh.expert_rank) == (d, e)
        assert mesh.expert_group == tuple(range(4 * d, 4 * d + 4))
        assert mesh.group == (e, 4 + e)
