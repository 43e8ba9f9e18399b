"""The REINFORCE estimator against the reference.

- ``reinforce_generator_loss`` against ``sgg.train.losses``' on the same
  critic, samples and parameters: the loss, every aux value and the gradient
  within 1e-5 (float32 sums of terms up to about 20 in another order), with
  and without the entropy bonus, at B = 6 and B = 1 (the
  baseline is 0 there); the port's versions of the reference's unit tests
  of the estimator (the analytic softmax gradient of a bandit within 0.06,
  five sigma of its Monte-Carlo spread; a constant reward gives exactly zero
  gradient).
- The train step with ``train.estimator=reinforce``: one and two port steps
  against ``sgg``'s jitted step from the same state, batches and noise
  (``test_torch_train``'s harness and tolerances: metrics within 1e-5
  relative plus 1e-6, parameters as there, the generator update's gradient
  within 1e-4 x max|ref| per tensor plus 1e-6 of the largest), on smoke with
  the entropy bonus, on a small vit_b16 with ``train_encoder``, and on it
  with a frozen encoder and ``grad_accum`` 2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg.models.encoders import make_encoder as jax_make_encoder
from sgg.models.encoders import normalize_for as jax_normalize_for
from sgg.train import losses as jax_losses
from sgg.train.state import make_models as jax_make_models
from sgg.train.step import _accum_vg as jax_accum_vg
from sgg.train.step import tau_schedule as jax_tau_schedule
from sgg_torch.convert_flax import generator_flax_to_state_dict
from sgg_torch.train.losses import reinforce_generator_loss
from sgg_torch.train.step import make_step_fn
from test_torch_train import STEPS, VIT_SETS, _assert_params_close, _configs, _run

torch.set_num_threads(1)


def _bandit(B, V, seed):
    r = np.random.RandomState(seed)
    w = r.randn(B, 3, V).astype(np.float32)
    tokens = r.randint(0, V, (B, 3))
    r_vec = r.randn(3 * V).astype(np.float32)
    feats = r.randn(B, 4).astype(np.float32)
    return w, tokens, r_vec, feats


@pytest.mark.parametrize("B,entropy", [(6, 0.0), (6, 0.05), (1, 0.05)])
def test_reinforce_loss_matches_reference(B, entropy):
    """Critic: a fixed linear score of the one-hot triple and the features;
    log_prob: Σₜ log softmax(w)[token], so the gradient reaches w."""
    V = 7
    w, tokens, r_vec, feats = _bandit(B, V, B)
    fake = np.eye(V, dtype=np.float32)[tokens]

    def jax_loss(w_):
        lp = jnp.take_along_axis(jax.nn.log_softmax(w_, -1), tokens[..., None], -1)[..., 0]
        return jax_losses.reinforce_generator_loss(
            lambda d, f, x: x.reshape(B, -1) @ r_vec + f.sum(-1), None, jnp.asarray(feats),
            jnp.asarray(fake), lp.sum(-1), logits=w_, entropy_coef=entropy)

    (want, want_aux), want_g = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    lp = torch.log_softmax(wt, -1).gather(-1, torch.from_numpy(tokens)[..., None])[..., 0]
    got, aux = reinforce_generator_loss(
        lambda f, x: x.reshape(B, -1) @ torch.from_numpy(r_vec) + f.sum(-1),
        torch.from_numpy(feats), torch.from_numpy(fake), lp.sum(-1), logits=wt,
        entropy_coef=entropy)
    (got_g,) = torch.autograd.grad(got, wt)
    assert set(aux) == set(want_aux) == ({"g_loss", "g_fake_score", "rl_surrogate",
                                          "rl_adv_std", "rl_log_prob"}
                                         | ({"rl_entropy"} if entropy else set()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-5)
    for k, v in want_aux.items():
        np.testing.assert_allclose(float(aux[k].detach()), float(v), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0, atol=1e-5)
    if B == 1:
        assert float(aux["rl_adv_std"]) == 0.0 and float(aux["rl_surrogate"]) != 0.0


def test_reinforce_loss_matches_analytic_softmax_gradient():
    """A 1-slot categorical bandit: π = softmax(w), reward r[token]; the
    surrogate's gradient against ∇w(−E[r]) = −p⊙(r − p·r). N = 8192 draws,
    Monte-Carlo std per component about 0.012; atol 0.06 (5σ)."""
    Vb, N = 6, 8192
    w0 = torch.from_numpy(np.random.RandomState(0).randn(Vb).astype(np.float32))
    r_vec = torch.from_numpy(np.random.RandomState(1).randn(Vb).astype(np.float32))
    w = w0.clone().requires_grad_(True)
    logits = w.expand(N, Vb)
    u = torch.rand(N, Vb, generator=torch.Generator().manual_seed(7)).clamp_min(1e-20)
    idx = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    fake = torch.nn.functional.one_hot(idx, Vb).float()[:, None, :].expand(N, 3, Vb)
    logp = torch.log_softmax(logits, -1).gather(-1, idx[:, None])[:, 0]
    loss, _ = reinforce_generator_loss(lambda f, x: x[:, 0, :] @ r_vec, None, fake, logp)
    (est,) = torch.autograd.grad(loss, w)
    p = torch.softmax(w0, -1).numpy()
    analytic = -(p * (r_vec.numpy() - p @ r_vec.numpy()))
    np.testing.assert_allclose(est.numpy(), analytic, atol=0.06)


def test_reinforce_constant_reward_gives_exactly_zero_grad():
    """The leave-one-out baseline makes the advantage exactly zero under a
    constant reward (4.0 keeps (Σr − rᵢ)/(B−1) exact in float32)."""
    B, V = 8, 5
    fake = torch.nn.functional.one_hot(torch.zeros(B, 3, dtype=torch.long), V).float()
    w = torch.linspace(-1.0, 1.0, B).requires_grad_(True)
    loss, _ = reinforce_generator_loss(lambda f, x: torch.full((x.shape[0],), 4.0), None,
                                       fake, torch.tanh(w))
    (g,) = torch.autograd.grad(loss, w)
    np.testing.assert_array_equal(g.numpy(), np.zeros(B, np.float32))


CASES = {
    "smoke_entropy": ("smoke", {"train.critic_unroll": 1, "train.estimator": "reinforce",
                                "train.rl_entropy": 0.01}),
    "vit_train_encoder": ("vit_b16", {**VIT_SETS, "train.train_encoder": True,
                                      "train.estimator": "reinforce"}),
    "vit_frozen_accum2": ("vit_b16", {**VIT_SETS, "train.train_encoder": False,
                                      "train.grad_accum": 2, "train.estimator": "reinforce",
                                      "train.rl_entropy": 0.01}),
}


@functools.cache
def _run_case(name):
    return _run(*CASES[name])


@pytest.fixture
def parity(request):
    return _run_case(request.param)


@pytest.mark.parametrize("parity", sorted(CASES), indirect=True)
def test_reinforce_step_metrics_match_reference(parity):
    t = parity["cfg"].train
    want_keys = {"rl_surrogate", "rl_adv_std", "rl_log_prob"} | (
        {"rl_entropy"} if t.rl_entropy else set())
    for s in parity["steps"]:
        assert set(s["pm"]) == set(s["jm"]) and want_keys <= set(s["pm"])
        for k, v in s["jm"].items():
            np.testing.assert_allclose(s["pm"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("parity", sorted(CASES), indirect=True)
def test_reinforce_step_parameters_match_reference(parity):
    t = parity["cfg"].train
    for i, s in enumerate(parity["steps"], start=1):
        (g, d, e, _), (rg, rd, re, _) = s["port"], s["ref"]
        _assert_params_close(g, rg, t.g_lr, i)
        _assert_params_close(d, rd, t.d_lr, i * t.n_critic)
        if re is not None:
            _assert_params_close(e, re, t.enc_lr, i * t.n_critic if t.train_encoder else 0)


def _reference_g_grads(cfg, mask, st0, st1, batch, step=0):
    """The reference's gradient of the first step's REINFORCE generator update
    (``sgg.train.step``'s reinforce ``g_loss_fn`` under ``_accum_vg``), from the
    updated critic (and encoder) of ``st1``."""
    gen, critic = jax_make_models(cfg)
    t, m = cfg.train, cfg.model
    A = max(1, int(t.grad_accum))
    tau = jax_tau_schedule(cfg, jnp.asarray(step, jnp.int32))
    encoder = jax_make_encoder(m.encoder, use_pallas=m.use_pallas, dtype=m.dtype,
                               image_size=cfg.data.image_size, vit_dims=m.vit_dims)

    def g_loss(g, d1, feats, rng):
        rz, rg = jax.random.split(rng)
        z = jax.random.normal(rz, (feats.shape[0], m.noise_dim), m.dtype)
        out = gen.apply({"params": g}, feats, z, rg, tau=tau, hard=True,
                        step_mask=jnp.asarray(mask), detach_sample=True)
        return jax_losses.reinforce_generator_loss(
            lambda d, f, x: critic.apply({"params": d}, f, x), d1, feats, out["soft"],
            out["log_prob"], logits=out["logits"], entropy_coef=t.rl_entropy)

    def body(g0, d1, e1, data):
        rng = jax.random.fold_in(jax.random.fold_in(st0.rng, step), 0)
        _, rng_g = jax.random.split(rng)
        feats_g = data[t.n_critic] if encoder is None else encoder.apply(
            e1, jax_normalize_for(m.encoder, data[t.n_critic])).astype(m.dtype)
        _, grads = jax_accum_vg(
            lambda p, mb, k: jax.value_and_grad(g_loss, has_aux=True)(p, d1, mb[0], k),
            g0, (feats_g,), rng_g, A)
        return grads

    data = batch["features" if encoder is None else "images"]
    return jax.jit(body)(st0.g_params, st1.d_params, st1.enc_params, data)


@pytest.mark.parametrize("parity", ["smoke_entropy", "vit_train_encoder"], indirect=True)
def test_reinforce_generator_gradient_matches_reference(parity):
    cfg = parity["cfg"]
    want = generator_flax_to_state_dict(_reference_g_grads(*parity["first"]), cfg)
    assert len(parity["recorded"]["g"]) == STEPS
    got = dict(zip(parity["names"]["g"], parity["recorded"]["g"][0]))
    assert set(got) == set(want)
    largest = max(float(w.abs().max()) for w in want.values())
    assert largest > 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()) + 1e-6 * largest,
                                   err_msg=k)


def test_unknown_estimator_is_refused():
    with pytest.raises(ValueError, match="estimator"):
        make_step_fn(_configs("smoke", {"train.estimator": "ppo"})[1])
