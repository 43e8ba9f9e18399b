"""CNN encoders trained end to end (``train.train_encoder`` on VGG-19 and
ResNet-50, the configs that set ``model.use_pallas``) against ``sgg``'s, on
the CPU.

- VGG-19 at the reference's own widths (``tests/unit/test_train.py``'s
  ``_enc_cfg``: 32 px, B 2, n_critic 2, float32) with ``model.use_pallas``:
  two port steps against ``sgg``'s jitted step from one state, batches and
  noise (``test_torch_train._run``). Held against ``sgg``: the first critic
  iteration's metrics within 1e-5 relative plus 1e-6 absolute, and its
  critic and encoder gradients within 1e-4 x max|ref| per tensor plus 1e-6
  of the largest, from the common initial state; step 1's generator
  gradient from the port's critic and encoder after the critic loop, within
  1e-3 x max (below); the encoder's parameters after step 1 within
  ``test_torch_train._assert_params_close``'s bound. Every update of both
  steps (generator, critic, encoder) is the reference's optimizer (optax,
  clip and schedule) fed the port's own gradients, within 1e-6 relative.
  The steps' metrics are held finite, with the reference's keys.
  Past the first Adam update the two runs part: the critic scores real and
  fake triples nearly alike at initialization (w_dist about 2e-5 of the
  scores), so its and the encoder's gradients are differences of nearly
  equal terms, and the two packages' conv sums (VGG-19's features 3e-6
  apart, relative) come out about 5e-5 of each gradient's max apart,
  element by element (measured); Adam's first update then moves every
  element whose gradient lies within that distance of 0 by a different
  ±lr (4 % of the critic's elements), and the later gradients, metrics and
  parameters follow. The generator's gradient is ill-conditioned too: the
  reference's own moves 3.5e-4 x max (3.7e-4 relative L2) when its
  encoder's weights are jittered by 1e-6 relative; the port's lies 1.3e-4 x
  max from it, a step from a stale critic or encoder 1.8-2.3 x max.
- ResNet-50 at 64 px, its batch-norm values drawn from a seed and each
  ReLU'd conv's bias set so that no ReLU input of the test's forward lies
  near 0 (``_settled_resnet``): features and the gradients of a fixed
  linear function of them with respect to every kernel and all four
  batch-norm parameters (through ``fold_batchnorm``'s rsqrt) against
  ``jax.grad`` of the reference's module, within 1e-4 x max (measured: at
  most 6e-6 x max on ten weight seeds).
- The routes: a trainable CNN (``train_route``) launches neither conv
  kernel's wrapper, a frozen one and the probe's ``make_image_encoder``
  launch them (counted by wrapping the wrappers), so the step trains on the
  library conv and the probe, generate and serve run the kernels.
- ``make_step_fn`` builds ``train_encoder`` steps on ``vg_full``,
  ``resnet50`` and ``v4_32`` as named (``use_pallas`` on); ResNet-50 steps
  with ``grad_accum`` 2 and with the REINFORCE estimator move every encoder
  tensor, the batch-norm statistics included.
- ``refuse_grad``, the conv kernels' guard: it raises under grad mode when
  an operand needs a gradient, and not otherwise (the wrappers call it only
  on CUDA tensors; ``tests/test_torch_kernels_cuda.py`` holds them there).
- ``chip_smoke.py`` phase 29 (c)'s gradient gate (``c4_gate``) at 32 px,
  B 2: the port's float32 CPU step's first critic update lies within the
  gate of its float64 oracle (the port's modules in float64 under
  ``chip_smoke.float64_mode``), and the same gradients with one seeded
  error of 1e-2 x max in one tensor are refused; every fault that
  ``chip_fault_check.py`` seeds still finds its sound text once in the
  source.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgg.models.encoders import make_encoder as jax_make_encoder
from sgg.models.encoders import normalize_for as jax_normalize_for
from sgg_torch.config import get_config
from sgg_torch.convert_flax import (
    critic_flax_to_state_dict,
    critic_state_dict_to_flax,
    encoder_flax_to_state_dict,
    encoder_state_dict_to_flax,
    generator_flax_to_state_dict,
    generator_state_dict_to_flax,
)
from sgg_torch.kernels import conv as conv_route
from sgg_torch.kernels.conv import fold_batchnorm
from sgg_torch.kernels.conv_direct import conv2d_nhwc_f32
from sgg_torch.kernels.matmul import refuse_grad
from sgg_torch.models.encoders import make_encoder, make_image_encoder, train_route
from sgg_torch.train import step as step_mod
from sgg_torch.train.state import create_train_state, global_norm
from sgg_torch.train.step import make_step_fn
from test_torch_train import STEPS, _assert_params_close, _reference_grads, _run
import chip_fault_check
import chip_smoke
from sgg.train.state import make_encoder_optimizer as jax_make_encoder_optimizer
from sgg.train.state import make_optimizers as jax_make_optimizers

torch.set_num_threads(1)

VGG_SETS = {"model.encoder": "vgg19", "model.use_pallas": True, "data.image_size": 32,
            "data.regions": 4, "data.feat_dim": 512, "data.num_synthetic_images": 12,
            "train.batch_size": 2, "train.n_critic": 2, "train.critic_unroll": 1,
            "train.train_encoder": True}
SMALL = {"model.hidden": 16, "model.embed_dim": 8, "model.attn_dim": 8, "model.noise_dim": 4,
         "model.critic_hidden": 16, "model.vocab_size": 30, "model.compute_dtype": "float32"}


@functools.cache
def _vgg_parity():
    """Both packages' two steps, the port's critic_loss aux values in call
    order, and the reference's gradients of step 1: of its first critic
    update from the common initial state, and of its generator update from
    the port's critic and encoder after the step's critic loop (the runs
    part there, see the module's docstring)."""
    seen = []
    critic_loss = step_mod.critic_loss

    def recording(*a, **k):
        loss, aux = critic_loss(*a, **k)
        seen.append({n: float(v.detach()) for n, v in aux.items()})
        return loss, aux

    step_mod.critic_loss = recording
    try:
        rec = _run("smoke", VGG_SETS)
    finally:
        step_mod.critic_loss = critic_loss
    jcfg, mask, st0, st1, batch = rec["first"]
    _, d, e, _ = rec["steps"][0]["port"]
    common = st1.replace(
        d_params=jax.tree.map(jnp.asarray, critic_state_dict_to_flax(d)),
        enc_params=jax.tree.map(jnp.asarray, encoder_state_dict_to_flax(e, "vgg19")))
    return rec, seen, _reference_grads(jcfg, mask, st0, common, batch)


def _assert_grads_close(rec, key, i, want: dict, rel=1e-4):
    """The port's ``i``-th recorded gradient of ``key`` within ``rel`` x
    max|ref| per tensor plus 1e-6 of the largest."""
    got = dict(zip(rec["names"][key], rec["recorded"][key][i]))
    assert set(got) == set(want)
    largest = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=rel * float(w.abs().max()) + 1e-6 * largest,
                                   err_msg=f"{key} {k}")


def test_vgg19_first_critic_iteration_matches_reference():
    rec, seen, ref = _vgg_parity()
    cfg = rec["cfg"]
    assert len(seen) == STEPS * cfg.train.n_critic
    want = {k: float(v) for k, v in ref["d_aux"].items()}
    assert set(want) <= set(seen[0])
    want["enc_gnorm"] = float(jnp.sqrt(sum((x.astype(jnp.float32) ** 2).sum()
                                           for x in jax.tree.leaves(ref["enc"]))))
    got = dict(seen[0], enc_gnorm=float(global_norm(rec["recorded"]["enc"][0])))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_grads_close(rec, "d", 0, critic_flax_to_state_dict(ref["d"], cfg))
    _assert_grads_close(rec, "enc", 0, encoder_flax_to_state_dict(ref["enc"]))


def test_vgg19_generator_gradient_matches_reference_from_the_ports_critic():
    """Within 1e-3 x max: the reference's own gradient moves 3.5e-4 x max when
    its encoder's weights are jittered by 1e-6 relative (measured), the
    port's lies 1.3e-4 x max from it, and a generator update from the
    critic or the encoder before the critic loop lies 1.8-2.3 x max away."""
    rec, _, ref = _vgg_parity()
    assert len(rec["recorded"]["g"]) == STEPS
    _assert_grads_close(rec, "g", 0, generator_flax_to_state_dict(ref["g"], rec["cfg"]),
                        rel=1e-3)


def test_vgg19_encoder_follows_reference_over_two_steps():
    rec, _, _ = _vgg_parity()
    t = rec["cfg"].train
    assert len(rec["recorded"]["enc"]) == STEPS * t.n_critic
    for s in rec["steps"]:
        assert set(s["pm"]) == set(s["jm"]) and "enc_gnorm" in s["pm"]
        assert all(np.isfinite(v) for v in s["pm"].values())
    first = rec["steps"][0]["port"][2]
    _assert_params_close(first, rec["steps"][0]["ref"][2], t.enc_lr, t.n_critic)
    # The encoder moved, every tensor of it.
    init = create_train_state(rec["cfg"], seed=0).encoder.state_dict()
    assert all(not torch.equal(first[k], init[k]) for k in init)


@pytest.mark.parametrize("key", ["g", "d", "enc"])
def test_vgg19_updates_are_the_reference_optimizers_on_the_ports_gradients(key):
    """Both steps' updates of each module: the reference's optimizer (optax,
    with its clip and schedule), fed the port's own recorded gradients from
    the common initial state, gives the port's parameters after step 2."""
    rec, _, _ = _vgg_parity()
    jcfg, st0 = rec["first"][0], rec["first"][2]
    g_tx, d_tx = jax_make_optimizers(jcfg)
    tx, params, to_flax, back, at = {
        "g": (g_tx, st0.g_params, generator_state_dict_to_flax,
              lambda p: generator_flax_to_state_dict(p, rec["cfg"]), 0),
        "d": (d_tx, st0.d_params, critic_state_dict_to_flax,
              lambda p: critic_flax_to_state_dict(p, rec["cfg"]), 1),
        "enc": (jax_make_encoder_optimizer(jcfg), st0.enc_params,
                lambda sd: encoder_state_dict_to_flax(sd, "vgg19"), encoder_flax_to_state_dict, 2),
    }[key]
    grads = rec["recorded"][key]
    assert len(grads) == STEPS * (1 if key == "g" else jcfg.train.n_critic)
    state = tx.init(params)
    for g in grads:
        g = jax.tree.map(jnp.asarray, to_flax(dict(zip(rec["names"][key], g))))
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    want, got = back(params), rec["steps"][-1]["port"][at]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-8,
                                   err_msg=f"{key} {k}")


def _settled_resnet(x: torch.Tensor, size=64):
    """A ResNet-50 whose forward on ``x`` has no ReLU input near 0.

    Batch-norm scale, variance and mean are drawn from a seed. Then, conv by
    conv in one forward pass, each ReLU'd conv's output is scaled to at most
    1 in magnitude (its ``bn_scale``). Its ``bn_bias`` then puts every input
    of the ReLU that follows (conv3's plus the block's residual) on one side
    of 0 per channel, at least a tenth of the channel's spread away: above
    for three channels in four, below (a dead channel) for the rest. An
    input within float32 rounding of 0 flips its ReLU in one package and not
    in the other, and so moves the gradients of every layer before it by up
    to a tenth of their max (measured on eight weight seeds without this
    setting: the port's float32 gradients lay beyond 1e-4 x max of a
    float64 evaluation of the reference on five, the reference's own
    float32 ones on three). Centring each conv on its batch's mean instead
    puts more ReLU inputs near 0, and fails on every seed."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        enc = make_encoder("resnet50", use_pallas=True, trainable=True, image_size=size)
    r = np.random.RandomState(3)

    def draw(p, lo, hi):
        p.copy_(torch.from_numpy(r.uniform(lo, hi, p.shape).astype(np.float32)))

    def settle(conv, args):
        inv, b = fold_batchnorm(conv.bn_scale, torch.zeros_like(conv.bn_bias), conv.bn_mean,
                                conv.bn_var)
        y = conv2d_nhwc_f32(args[0], conv.kernel, conv.stride) * inv + b
        k = 1.0 / y.abs().max()
        conv.bn_scale.mul_(k)
        z = (y * k + conv.residual).reshape(-1, y.shape[-1])
        lo, hi = z.min(0).values, z.max(0).values
        margin = 0.1 * (hi - lo) + 1e-3
        up = torch.from_numpy(r.rand(z.shape[-1]) < 0.75)
        conv.bn_bias.copy_(torch.where(up, margin - lo, -margin - hi))

    def residual(block, args):
        block.conv3.residual = args[0] if block.proj is None else block.proj(args[0])

    hooks = []
    with torch.no_grad():
        for mod in enc.modules():
            if hasattr(mod, "bn_var"):
                draw(mod.bn_scale, 0.5, 1.5)
                draw(mod.bn_var, 0.5, 1.5)
                draw(mod.bn_mean, -0.2, 0.2)
                mod.residual = 0.0
                if mod.relu:
                    hooks.append(mod.register_forward_pre_hook(settle))
            if hasattr(mod, "conv3"):
                hooks.append(mod.register_forward_pre_hook(residual))
                hooks.append(mod.conv3.register_forward_pre_hook(settle))
        enc(x)
    for h in hooks:
        h.remove()
    return enc


def test_resnet50_features_and_batchnorm_gradients_match_jax_grad():
    images = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    x = np.array(jax_normalize_for("resnet50", jnp.asarray(images)))
    enc = _settled_resnet(torch.from_numpy(x))
    w = np.random.RandomState(1).randn(2, 4, 2048).astype(np.float32)
    params = jax.tree.map(jnp.asarray, encoder_state_dict_to_flax(enc.state_dict(), "resnet50"))
    jenc = jax_make_encoder("resnet50", use_pallas=True)

    def scalar(p):
        feats = jenc.apply(p, jnp.asarray(x))
        return (feats * w).sum(), feats

    (_, want_feats), want = jax.jit(jax.value_and_grad(scalar, has_aux=True))(params)
    feats = enc(torch.from_numpy(x))
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(want_feats), rtol=0,
                               atol=1e-4 * float(jnp.abs(want_feats).max()))
    names = [n for n, _ in enc.named_parameters()]
    got = dict(zip(names, torch.autograd.grad((feats * torch.from_numpy(w)).sum(),
                                              list(enc.parameters()))))
    want = encoder_flax_to_state_dict(want)
    assert set(got) == set(want)
    kinds = {n.rsplit(".", 1)[1] for n in want}
    assert kinds == {"kernel", "bn_scale", "bn_bias", "bn_mean", "bn_var"}
    for k, v in want.items():
        assert float(v.abs().max()) > 0, k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * float(v.abs().max()), err_msg=k)


def _counting(monkeypatch):
    counts = {"conv2d_direct": 0, "fused_matmul": 0}
    for name in counts:
        fn = getattr(conv_route, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(conv_route, name, counted)
    return counts


@pytest.mark.parametrize("name,size,want", [("vgg19", 32, (16, 0)), ("resnet50", 64, (13, 36))])
def test_trainable_cnns_take_the_library_conv_and_the_probe_the_kernels(monkeypatch, name,
                                                                        size, want):
    assert train_route(name) is False and train_route(name, False) is False
    assert train_route("vit_b16") is True and train_route("vit_b16", False) is False
    counts = _counting(monkeypatch)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, size, size, 3).astype(np.float32))
    frozen = make_encoder(name, use_pallas=True)
    with torch.no_grad():
        frozen(x)
    assert (counts["conv2d_direct"], counts["fused_matmul"]) == want
    cfg = get_config("vg_full" if name == "vgg19" else "resnet50").override(
        [f"data.image_size={size}", "train.train_encoder=true", "model.compute_dtype=float32",
         *[f"{k}={v}" for k, v in SMALL.items()]])
    state = create_train_state(cfg, seed=0)
    assert cfg.model.use_pallas and state.encoder is not None and state.enc_tx is not None
    assert all(p.requires_grad for p in state.encoder.parameters())
    counts.update(conv2d_direct=0, fused_matmul=0)
    state.encoder(x).sum().backward()  # differentiable on its route
    assert counts == {"conv2d_direct": 0, "fused_matmul": 0}
    probe = make_image_encoder(cfg, state.encoder.state_dict(), torch.device("cpu"))
    feats = probe(torch.from_numpy(np.zeros((1, size, size, 3), np.uint8)))
    assert (counts["conv2d_direct"], counts["fused_matmul"]) == want
    assert not feats.requires_grad


@pytest.mark.parametrize("config", ["vg_full", "resnet50", "v4_32"])
def test_named_kernel_route_configs_build_a_train_encoder_step(config):
    cfg = get_config(config).override(["train.train_encoder=true"])
    assert cfg.model.use_pallas and cfg.model.encoder in ("vgg19", "resnet50")
    assert callable(make_step_fn(cfg))


@pytest.mark.parametrize("sets", [{"train.grad_accum": 2},
                                  {"train.estimator": "reinforce", "train.rl_entropy": 0.01}],
                         ids=["grad_accum2", "reinforce"])
def test_resnet50_train_encoder_step_moves_every_encoder_tensor(sets):
    cfg = get_config("resnet50").override(
        ["data.image_size=64", "data.regions=4", "train.batch_size=2", "train.n_critic=1",
         "train.train_encoder=true", *[f"{k}={v}" for k, v in {**SMALL, **sets}.items()]])
    state = create_train_state(cfg, seed=0)
    before = {k: v.clone() for k, v in state.encoder.state_dict().items()}
    r = np.random.RandomState(0)
    batch = {"images": torch.from_numpy(r.randint(0, 256, (2, 2, 64, 64, 3), dtype=np.uint8)),
             "triples": torch.from_numpy(r.randint(2, 30, (2, 2, 3)))}
    metrics = make_step_fn(cfg)(state, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["enc_gnorm"]) > 0 and state.enc_tx.count == 1
    after = state.encoder.state_dict()
    assert all(not torch.equal(after[k], before[k]) for k in before), \
        sorted(k for k in before if torch.equal(after[k], before[k]))


def test_refuse_grad_raises_only_for_an_operand_that_needs_a_gradient():
    a = torch.ones(2, 2)
    w = torch.ones(2, 2, requires_grad=True)
    refuse_grad("fused_matmul", a, None, a)
    with pytest.raises(NotImplementedError, match="fused_matmul is forward only"):
        refuse_grad("fused_matmul", a, w, None)
    with pytest.raises(NotImplementedError, match="library conv"):
        refuse_grad("conv2d_direct", a, None, w)
    with torch.no_grad():
        refuse_grad("conv2d_direct", a, w)


C4_SMALL = {"model.hidden": 32, "model.embed_dim": 16, "model.attn_dim": 16,
            "model.noise_dim": 8, "model.critic_hidden": 32, "data.regions": 4,
            "data.feat_dim": 512}


def test_c4_gate_passes_the_float32_step_and_refuses_a_seeded_error():
    cfg, data, noise = chip_smoke.cnn_hold_inputs(0, 2, 32, C4_SMALL)
    _, f32, _ = chip_smoke.first_update_grads(cfg, 0, data, noise, "cpu")
    _, f64, _ = chip_smoke.first_update_grads(cfg, 0, data, noise, "cpu", float64=True)
    for key in ("d", "enc"):
        assert len(f32[key]) == len(f64[key]) and all(g.dtype == torch.float64 for g in f64[key])
        far, _ = chip_smoke.oracle_distance(f32[key], f64[key])
        assert 0 < far < 1e-3  # float32's rounding, not another function
        assert chip_smoke.c4_gate(far, far)[0]
        seeded = [g.contiguous() for g in f32[key]]
        seeded[-2] = seeded[-2].clone()
        seeded[-2].view(-1)[0] += 1e-2 * seeded[-2].abs().max()
        bad, _ = chip_smoke.oracle_distance(seeded, f64[key])
        assert not chip_smoke.c4_gate(bad, far)[0]


def _fault_sources():
    f = chip_fault_check
    for name, src in (("CONV_FAULTS", f.CONV_SRC), ("MM_FAULTS", f.MM_SRC),
                      ("DECODE_FAULTS", f.DECODE_SRC), ("GATHER_FAULTS", f.GATHER_SRC),
                      ("GRAPH_FAULTS", f.GATHER_SRC), ("LOADER_FAULTS", f.LOADER_SRC)):
        for label, v in getattr(f, name).items():
            yield label, src, v[0]
    for label, (src, sound, _, _) in dict(f.RECIPE_FAULTS, **f.DEPLOY_FAULTS, **f.DP_FAULTS,
                                          **f.CNN_FAULTS).items():
        yield label, src, sound
    for src, sound, _ in f.ONE_ACCUMULATOR:
        yield "one accumulator", src, sound


@pytest.mark.parametrize("label,src,sound", list(_fault_sources()),
                         ids=lambda x: x if isinstance(x, str) and len(x) < 40 else None)
def test_every_seeded_fault_finds_its_sound_text_once(label, src, sound):
    path = src if src.startswith("sgg_torch/") else os.path.join(chip_fault_check.CSRC, src)
    with open(os.path.join(chip_fault_check.ROOT, path)) as f:
        assert f.read().count(sound) == 1, label
