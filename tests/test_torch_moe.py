"""The port's MoE layer (``sgg_torch.models.moe``) and the MoE ViT against
``sgg.models.moe`` and ``sgg.models.vit`` on the CPU, on shared inputs and
converted weights.

- ``moe_capacity`` equal; ``moe_routing``'s combine and aux within 1e-6 with
  top-1 and top-2, at a capacity that drops tokens and on tied logits (the
  first index wins in both); ``moe_forward`` within 1e-5 in float32;
- a small MoE ViT ((64, 2, 4), 4 experts, 64 px, the port's seeded init
  converted, as ``tests/test_torch_train.py`` does: flax's eager init takes
  seconds): features within 1e-4 x max in float32 and the mean aux within
  1e-6, on both attention routes (against the reference's, from one jitted
  computation beside its gradients); parameter gradients through the flash route against
  ``jax.grad`` within 1e-4 x max per tensor (``tests/test_torch_train.py``'s
  ViT tolerance);
- the converter both ways on the ``moe/{router,wi,wo}`` leaves;
- ``model.moe_top_k`` reaches the encoder through ``make_encoder``,
  ``make_image_encoder``, extraction and the train state (top-1 features
  equal the reference's top-1 apply);
- one and two ``train_encoder`` GAN steps of a small MoE vit_b16 against
  ``sgg``'s jitted step, ``moe_aux`` included, within
  ``tests/test_torch_train.py``'s tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg.kernels.flash_attention import flash_attention as jax_flash_attention
from sgg.models import moe as jmoe
from sgg.models.encoders import make_encoder as jax_make_encoder
from sgg.models.encoders import normalize_for as jax_normalize_for
from sgg_torch.config import get_config
from sgg_torch.convert_flax import encoder_flax_to_state_dict, encoder_state_dict_to_flax
from sgg_torch.data.extract import make_extractor
from sgg_torch.models import moe
from sgg_torch.models.encoders import make_encoder, make_image_encoder
from sgg_torch.train.state import create_train_state

from test_torch_train import VIT_SETS, _assert_params_close, _run

torch.set_num_threads(1)

DIMS = (64, 2, 4)


@pytest.mark.parametrize("E,k,S,cf", [(4, 1, 16, 1.25), (4, 2, 16, 1.25), (8, 2, 196, 1.25),
                                      (8, 1, 7, 0.5), (3, 2, 5, 1.0)])
def test_capacity_matches_reference(E, k, S, cf):
    assert moe.moe_capacity(E, k, S, cf) == jmoe.moe_capacity(E, k, S, cf)


def _logits(case):
    r = np.random.RandomState(0)
    x = r.randn(3, 24, 4).astype(np.float32)
    if case == "tied":  # exact ties between experts, and whole rows of one value
        x[:, ::3, 1] = x[:, ::3, 3]
        x[0, 5] = 0.25
        x[1, :4] = x[1, 4]
    return x


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case,capacity", [("random", 40), ("random", 4), ("tied", 48)])
def test_routing_matches_reference(top_k, case, capacity):
    x = _logits(case)
    want_c, want_a = jmoe.moe_routing(jnp.asarray(x), top_k, capacity)
    got_c, got_a = moe.moe_routing(torch.from_numpy(x), top_k, capacity)
    want_c = np.asarray(want_c)
    assert got_c.dtype == torch.float32 and got_c.shape == want_c.shape
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got_a), float(want_a), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_c.numpy() > 0, want_c > 0)  # the same dispatch
    kept = (want_c > 0).sum()
    if capacity == 4:  # the capacity drops tokens: fewer slots taken than choices
        assert kept < x.shape[0] * x.shape[1] * top_k
    else:
        assert kept == x.shape[0] * x.shape[1] * top_k


@pytest.mark.parametrize("top_k,capacity", [(1, 6), (2, 3), (2, 16)])
def test_forward_matches_reference(top_k, capacity):
    r = np.random.RandomState(1)
    x = r.randn(2, 12, 32).astype(np.float32)
    params = {"router": 0.3 * r.randn(32, 4), "wi": 0.2 * r.randn(4, 32, 128),
              "wo": 0.2 * r.randn(4, 128, 32)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    want_y, want_a = jmoe.moe_forward({k: jnp.asarray(v) for k, v in params.items()},
                                      jnp.asarray(x), top_k, capacity)
    got_y, got_a = moe.moe_forward({k: torch.from_numpy(v) for k, v in params.items()},
                                   torch.from_numpy(x), top_k, capacity)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got_a), float(want_a), rtol=0, atol=1e-6)


@functools.cache
def _vit(top_k=2):
    """(images normalized [2, 64, 64, 3], flax params, port state_dict) of a
    small MoE ViT at the port's seeded init."""
    x = np.array(jax_normalize_for("vit_b16", jnp.asarray(
        np.random.RandomState(2).randint(0, 256, (2, 64, 64, 3), dtype=np.uint8))))
    torch.manual_seed(0)
    sd = make_encoder("vit_b16", image_size=64, vit_dims=DIMS, moe_experts=4,
                      moe_top_k=top_k).state_dict()
    params = jax.tree.map(jnp.asarray, encoder_state_dict_to_flax(sd, "vit_b16"))
    return x, params, encoder_flax_to_state_dict(params, like=sd)


GRAD_W = np.random.RandomState(3).randn(2, 16, 64).astype(np.float32)


@functools.cache
def _reference():
    """The reference MoE ViT in one jitted computation: {route: (features,
    mean aux)} for its plain and its Pallas flash attention, and the
    parameter gradients of sum(features · GRAD_W) + aux on the flash route."""
    x, params, _ = _vit()
    encs = {use_pallas: jax_make_encoder(
        "vit_b16", attn_fn=jax_flash_attention if use_pallas else None, image_size=64,
        vit_dims=DIMS, moe_experts=4) for use_pallas in (False, True)}

    def apply(p, use_pallas):
        f, cols = encs[use_pallas].apply(p, jnp.asarray(x), mutable=["moe"])
        leaves = jax.tree.leaves(cols["moe"])
        assert len(leaves) == 2
        return f, sum(leaves) / len(leaves)

    def jloss(p):
        f, aux = apply(p, True)
        return (f * GRAD_W).sum() + aux, (f, aux)

    def both(p):
        (_, flash), grads = jax.value_and_grad(jloss, has_aux=True)(p)
        return {False: apply(p, False), True: flash}, grads

    outs, grads = jax.jit(both)(params)
    return {k: (np.asarray(f), float(a)) for k, (f, a) in outs.items()}, grads


@pytest.mark.parametrize("use_pallas", [False, True])
def test_moe_vit_features_and_aux_match_reference(use_pallas):
    x, params, sd = _vit()
    want, want_aux = _reference()[0][use_pallas]
    enc = make_encoder("vit_b16", use_pallas=use_pallas, image_size=64, vit_dims=DIMS,
                       moe_experts=4)
    enc.load_state_dict(sd)
    with torch.no_grad():
        got, aux = enc.forward_aux(torch.from_numpy(x))
        plain = enc(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 16, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), want_aux, rtol=0, atol=1e-6)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_moe_vit_gradients_match_reference():
    """Parameter gradients, the aux included, through the flash route (its
    plain backward here) against ``jax.grad`` through the Pallas kernels."""
    x, params, sd = _vit()
    want = _reference()[1]
    enc = make_encoder("vit_b16", use_pallas=True, image_size=64, vit_dims=DIMS,
                       moe_experts=4, trainable=True)
    enc.load_state_dict(sd)
    f, aux = enc.forward_aux(torch.from_numpy(x))
    loss = (f * torch.from_numpy(GRAD_W)).sum() + aux
    got = dict(zip([n for n, _ in enc.named_parameters()],
                   torch.autograd.grad(loss, list(enc.parameters()))))
    want_sd = encoder_flax_to_state_dict(want)
    assert set(got) == set(want_sd) and "block1.moe.router" in got
    for k, v in want_sd.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * float(v.abs().max()), err_msg=k)


def test_moe_converter_round_trip():
    _, params, sd = _vit()
    assert tuple(sd["block0.moe.router"].shape) == (64, 4)
    assert tuple(sd["block0.moe.wi"].shape) == (4, 64, 256)
    assert tuple(sd["block0.moe.wo"].shape) == (4, 256, 64)
    assert not any(k.startswith("block0.mlp") for k in sd)
    back = encoder_state_dict_to_flax(sd, "vit_b16")
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(flat_b[path], v)


def test_top_k_reaches_the_encoder_everywhere():
    """model.moe_top_k = 1 builds top-1 layers through make_encoder,
    make_image_encoder, extraction and the train state; top-1 features
    equal the reference's top-1 apply and differ from top-2's."""
    x, params, sd = _vit(top_k=1)
    images = np.random.RandomState(2).randint(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(jax_make_encoder("vit_b16", image_size=64, vit_dims=DIMS,
                                               moe_experts=4, moe_top_k=1).apply)(
        params, jnp.asarray(x)))
    enc = make_encoder("vit_b16", image_size=64, vit_dims=DIMS, moe_experts=4, moe_top_k=1)
    assert {m.top_k for m in enc.modules() if isinstance(m, moe.MoEMLP)} == {1}
    cfg = get_config("vit_b16").override([
        "data.image_size=64", "model.vit_dim=64", "model.vit_layers=2", "model.vit_heads=4",
        "model.moe_experts=4", "model.moe_top_k=1", "model.compute_dtype=float32"])
    encode = make_image_encoder(cfg, sd, "cpu")
    got = encode(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    apply = make_extractor("vit_b16", sd, image_size=64, vit_dims=DIMS, moe_experts=4,
                           moe_top_k=1, device="cpu")
    np.testing.assert_allclose(apply(images).numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    top2 = make_extractor("vit_b16", sd, image_size=64, vit_dims=DIMS, moe_experts=4,
                          device="cpu")(images).numpy()
    assert np.abs(top2 - want).max() > 1e-2 * np.abs(want).max()
    state = create_train_state(cfg.override(["train.train_encoder=true"]))
    assert {m.top_k for m in state.encoder.modules() if isinstance(m, moe.MoEMLP)} == {1}


@functools.cache
def _gan_parity():
    return _run("vit_b16", {**VIT_SETS, "train.train_encoder": True,
                            "model.moe_experts": 4})


def test_moe_train_encoder_step_matches_reference():
    """Metrics (``moe_aux`` included) and parameters after one and two steps."""
    parity = _gan_parity()
    t = parity["cfg"].train
    for i, s in enumerate(parity["steps"], start=1):
        assert "moe_aux" in s["jm"] and set(s["pm"]) == set(s["jm"])
        for k, v in s["jm"].items():
            np.testing.assert_allclose(s["pm"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        (g, d, e, _), (rg, rd, re, _) = s["port"], s["ref"]
        assert "block0.moe.wi" in e
        _assert_params_close(g, rg, t.g_lr, i)
        _assert_params_close(d, rd, t.d_lr, i * t.n_critic)
        _assert_params_close(e, re, t.enc_lr, i * t.n_critic)
