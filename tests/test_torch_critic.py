"""The port's critic and WGAN-GP losses against the reference's.

``sgg_torch.models.discriminator.TripleCritic`` against flax ``TripleCritic``
on the same weights (``critic_flax_to_state_dict``), and
``sgg_torch.train.losses`` against ``sgg.train.losses`` given the same ε (the
reference draws it from its key; the test draws it there and hands it over).
Inputs are numpy-seeded: region features, one-hot real triples and soft fake
triples on the simplex.

Tolerances: float32 scores, losses and aux values within 1e-5 relative (plus
1e-6 absolute), and the critic's gradients (through the penalty's double
backward) within 1e-4 x max|ref| per parameter: float32 sums in another
order. bfloat16 scores within one bf16 ulp of the reference's (measured:
identical; the slack is for a last-bit tanh or exp of another XLA build), so
a rounding put elsewhere than flax puts it shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg.config import get_config as jax_get_config
from sgg.models import TripleCritic as JaxTripleCritic
from sgg.train import losses as jax_losses
from sgg_torch.config import get_config
from sgg_torch.convert_flax import critic_flax_to_state_dict, critic_state_dict_to_flax
from sgg_torch.models.discriminator import TripleCritic
from sgg_torch.train import losses

torch.set_num_threads(1)

B, V = 6, 40


def _cfg(dtype="float32"):
    cfg = get_config("smoke").override([f"model.compute_dtype={dtype}", f"model.vocab_size={V}"])
    jcfg = jax_get_config("smoke")
    jcfg.model.compute_dtype, jcfg.model.vocab_size = dtype, V
    return cfg, jcfg


def _critics(dtype="float32"):
    """The flax critic and the port's on the same weights: the port's init,
    moved off its init values (so LayerNorm scales and biases matter) and
    converted to the flax tree."""
    cfg, jcfg = _cfg(dtype)
    m = jcfg.model
    jc = JaxTripleCritic(vocab_size=V, embed_dim=m.embed_dim, hidden=m.critic_hidden,
                         attn_dim=m.attn_dim, n_layers=m.critic_layers, dtype=m.dtype)
    feats = np.random.RandomState(0).randn(B, cfg.data.regions, cfg.data.feat_dim)
    feats = feats.astype(np.float32)
    torch.manual_seed(1)
    tc = TripleCritic.from_config(cfg)
    with torch.no_grad():
        for p in tc.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    params = critic_state_dict_to_flax(tc.state_dict())
    assert critic_flax_to_state_dict(params, cfg).keys() == tc.state_dict().keys()
    return cfg, jc, params, tc, feats


def _triples(seed=2):
    r = np.random.RandomState(seed)
    real = np.eye(V, dtype=np.float32)[r.randint(0, V, (B, 3))]
    logits = 3.0 * r.randn(B, 3, V).astype(np.float32)
    fake = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return real, fake.astype(np.float32)


@pytest.fixture(scope="module")
def f32():
    return _critics()


def test_critic_scores_match_float32(f32):
    cfg, jc, params, tc, feats = f32
    real, fake = _triples()
    for tri in (real, fake):
        want = np.asarray(jax.jit(jc.apply)({"params": params}, feats, tri))
        got = tc(torch.from_numpy(feats), torch.from_numpy(tri))
        assert got.dtype == torch.float32 and tuple(got.shape) == (B,)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)


def test_critic_scores_match_bfloat16():
    cfg, jc, params, tc, feats = _critics("bfloat16")
    real, fake = _triples(3)
    for tri in (real, fake):
        want = np.asarray(jax.jit(jc.apply)({"params": params}, feats, tri))
        got = tc(torch.from_numpy(feats), torch.from_numpy(tri)).detach().numpy()
        assert got.dtype == np.float32
        ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
        assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


def test_losses_and_critic_gradients_match(f32):
    cfg, jc, params, tc, feats = f32
    real, fake = _triples(4)
    rng = jax.random.key(5)
    eps = np.array(jax.random.uniform(rng, (B, 1, 1), dtype=jnp.float32))
    jf, jr, jk = map(jnp.asarray, (feats, real, fake))

    def apply(p, f, x):
        return jc.apply({"params": p}, f, x)

    @jax.jit
    def reference(p):
        (loss, aux), grads = jax.value_and_grad(
            lambda d: jax_losses.critic_loss(apply, d, jf, jr, jk, rng, 10.0, 0.5),
            has_aux=True)(p)
        gp = jax_losses.gradient_penalty(apply, p, jf, jr, jk, rng)
        return loss, aux, grads, gp, jax_losses.generator_loss(apply, p, jf, jk)

    want_loss, want_aux, want_g, want_gp, (want_gl, want_ga) = reference(params)
    tf, tr, tk = map(torch.from_numpy, (feats, real, fake))
    loss, aux = losses.critic_loss(tc, tf, tr, tk, torch.from_numpy(eps), 10.0, 0.5)
    assert set(aux) == set(want_aux)
    for k, v in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=1e-6)
    gp = losses.gradient_penalty(tc, tf, tr, tk, torch.from_numpy(eps))
    np.testing.assert_allclose(gp.item(), float(want_gp), rtol=1e-5, atol=1e-6)

    got_g = dict(zip([n for n, _ in tc.named_parameters()],
                     torch.autograd.grad(loss, list(tc.parameters()))))
    want_sd = critic_flax_to_state_dict(want_g, cfg)
    assert set(got_g) == set(want_sd)
    for k, w in want_sd.items():
        np.testing.assert_allclose(got_g[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()) + 1e-8, err_msg=k)

    g_loss, g_aux = losses.generator_loss(tc, tf, tk)
    np.testing.assert_allclose(g_loss.item(), float(want_gl), rtol=1e-5, atol=1e-6)
    for k, v in want_ga.items():
        np.testing.assert_allclose(g_aux[k].item(), float(v), rtol=1e-5, atol=1e-6)


def test_converter_round_trip_and_refusals(f32):
    cfg, _, params, tc, _ = f32
    back = critic_state_dict_to_flax(tc.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))
    missing = {k: v for k, v in params.items() if k != "head"}
    with pytest.raises(ValueError, match="missing"):
        critic_flax_to_state_dict(missing, cfg)
    with pytest.raises(ValueError, match="unknown"):
        critic_flax_to_state_dict({**params, "extra": {"kernel": np.zeros(2)}}, cfg)
    wide = dict(params, head={"kernel": np.zeros((5, 1)), "bias": np.zeros(1)})
    with pytest.raises(ValueError, match="shapes"):
        critic_flax_to_state_dict(wide, cfg)
