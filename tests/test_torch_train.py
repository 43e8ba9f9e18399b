"""The port's training step and its parts against the reference's.

- ``tau_schedule``, ``lr_schedule_fn`` (constant, cosine and linear, with
  warmup, per update count), the global-norm clip and one Adam update against
  ``sgg.train`` and optax;
- the train step: one and two port steps against ``make_train_step``'s step
  (``sgg.train.step.make_step_fn`` under ``jax.jit``) from the same state
  (``train_state_from_flax``), the same batches (the reference's host
  iterator) and the same noise (drawn with ``jax.random`` along the
  reference's own key sequence, :func:`reference_noise`). Configs: ``smoke``
  (precomputed features, attention-LSTM, float32) with ``grad_accum`` 1, and
  with ``grad_accum`` 2 and EMA; a small ``vit_b16`` (``vit_dims`` (64, 2,
  4), 64 px, small decoder, float32) with ``train_encoder`` on, and off
  (VGG-19 with ``train_encoder``: ``tests/test_torch_train_encoder_cnn.py``);
- the ViT's parameter gradients through ``flash_attention`` against
  ``jax.grad`` of flax ``ViTB16Features(attn_fn=flash_attention)`` (the
  Pallas backward in interpret mode);
- the host iterator's batches against ``sgg``'s, and the refusals;
- ``warm_autograd``, the step's warm-up on a CUDA device (the calling
  thread's autograd sequence number put above the device thread's): it runs
  once per device, touches no tensor of the state, and a step after it equals
  a step without it bit for bit (here on the CPU, where the step itself never
  calls it).

Tolerances (float32 throughout): metrics within 1e-5 relative plus 1e-6
absolute (w_dist is a difference of two close means); the gradients of the
first critic update and of the generator update within 1e-4 x max|ref| per
tensor (float32 sums in another order, through the GP's double backward and
the ViT) plus 1e-6 of the update's largest gradient (a gradient that is zero
in exact arithmetic, as a key bias's before a softmax, is rounding noise in
both). Parameters after each step: an element is within 1e-6 + 1e-5·|p| of
the reference, or, at Adam's sign-sensitive elements, within 2·lr per update
so far, for at most 1 % of the elements. At an update, Adam moves an element
by about ±lr·g/(|g| + 1e-8), so an element whose gradient is rounding noise in
both packages can move the other way and differ by 2·lr (measured: none in
smoke, 0.05 % of the encoder's elements in the ViT case).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgg.cli.common import load_dataset as jax_load_dataset
from sgg.config import get_config as jax_get_config
from sgg.data import synthetic_dataset as jax_synthetic_dataset
from sgg.data.pipeline import TripleDataset as JaxTripleDataset
from sgg.data.pipeline import make_train_iterator as jax_make_train_iterator
from sgg.kernels.flash_attention import flash_attention as jax_flash_attention
from sgg.kernels.fused_decode import decode_gumbel_noise
from sgg.models.encoders import make_encoder as jax_make_encoder
from sgg.models.encoders import normalize_for as jax_normalize_for
from sgg.train import losses as jax_losses
from sgg.train.state import GANTrainState as JaxGANTrainState
from sgg.train.state import lr_schedule_fn as jax_lr_schedule_fn
from sgg.train.state import make_encoder_optimizer as jax_make_encoder_optimizer
from sgg.train.state import make_models as jax_make_models
from sgg.train.state import make_optimizers as jax_make_optimizers
from sgg.train.step import _accum_vg as jax_accum_vg
from sgg.train.step import make_step_fn as jax_make_step_fn
from sgg.train.step import tau_schedule as jax_tau_schedule
from sgg.utils.gumbel import sample_gumbel as jax_sample_gumbel
from sgg_torch.config import get_config
from sgg_torch.convert_flax import (
    critic_flax_to_state_dict,
    critic_state_dict_to_flax,
    encoder_flax_to_state_dict,
    encoder_state_dict_to_flax,
    generator_flax_to_state_dict,
    generator_state_dict_to_flax,
    train_state_from_flax,
)
from sgg_torch.data import TripleDataset
from sgg_torch.data.pipeline import make_device_train_iterator, make_train_iterator
from sgg_torch.models.encoders import make_encoder
from sgg_torch.train import state as tstate
from sgg_torch.train import step as step_mod
from sgg_torch.train.step import make_step_fn, noise_shapes, tau_schedule
from sgg_torch.train.step import warm_autograd as step_warm

torch.set_num_threads(1)

STEPS = 2
VIT_SETS = {
    "data.image_size": 64, "data.regions": 16, "data.feat_dim": 64,
    "data.num_synthetic_images": 12, "model.vit_dim": 64, "model.vit_layers": 2,
    "model.vit_heads": 4, "model.hidden": 32, "model.num_heads": 4, "model.num_layers": 2,
    "model.noise_dim": 8, "model.embed_dim": 16, "model.attn_dim": 16,
    "model.critic_hidden": 32, "model.compute_dtype": "float32", "train.batch_size": 4,
    "train.n_critic": 2, "train.critic_unroll": 1,
}


def _configs(name, sets):
    """(reference config, port config) with the same overrides."""
    jcfg = jax_get_config(name)
    for k, v in sets.items():
        section, field = k.split(".")
        setattr(getattr(jcfg, section), field, v)
    return jcfg, get_config(name).override([f"{k}={v}" for k, v in sets.items()])


def reference_noise(cfg, B):
    """(state_rng, step, shard=0) → one reference step's noise in the port's
    layout (``noise_shapes``), along the reference's key sequence:
    fold_in(rng, step), fold_in(·, shard) (the data shard's index: 0 off a
    mesh),
    split into rng_d and rng_g; split(rng_d) into the critic keys and the
    batched fakes' key, split(·, n_critic); per branch split(key) into key_f
    and key_gp; split(·, accum) per microbatch when accum > 1; and per fake
    split into z and the generator's own Gumbel sequence."""
    t, m = cfg.train, cfg.model
    nc, A = t.n_critic, max(1, int(t.grad_accum))
    Bm, Z, V, dt = B // A, m.noise_dim, m.vocab_size, m.dtype

    def fake(rng, n):
        rz, rg = jax.random.split(rng)
        z = jax.random.normal(rz, (n, Z), dt).astype(jnp.float32)
        g = (decode_gumbel_noise(rg, n, V) if m.decoder == "lstm"
             else jax_sample_gumbel(rg, (n, 3, V), jnp.float32))
        return z, g

    def micro(key):
        return [key] if A == 1 else list(jax.random.split(key, A))

    def eps(key, n):
        return jax.random.uniform(key, (n, 1, 1), dtype=dt).astype(jnp.float32)

    @jax.jit
    def draw(state_rng, step, shard):
        rng = jax.random.fold_in(jax.random.fold_in(state_rng, step), shard)
        rng_d, rng_g = jax.random.split(rng)
        rng_dkeys, rng_fakes = jax.random.split(rng_d)
        d_keys = jax.random.split(rng_dkeys, nc)
        fz, fg, ge = [], [], []
        if m.encoder == "precomputed":
            z, g = fake(rng_fakes, nc * B)
            fz, fg = z.reshape(nc, 1, B, Z), g.reshape(nc, 1, B, 3, V)
            ge = [[eps(k, Bm) for k in micro(d_keys[i])] for i in range(nc)]
        elif t.train_encoder:
            for i in range(nc):
                zs, gs, es = [], [], []
                for k in micro(d_keys[i]):
                    key_f, key_gp = jax.random.split(k)
                    z, g = fake(key_f, Bm)
                    zs.append(z), gs.append(g), es.append(eps(key_gp, Bm))
                fz.append(zs), fg.append(gs), ge.append(es)
        else:
            for i in range(nc):
                key_f, key_gp = jax.random.split(d_keys[i])
                z, g = fake(key_f, B)
                fz.append([z]), fg.append([g]), ge.append([eps(k, Bm) for k in micro(key_gp)])
        gz, gg = zip(*[fake(k, Bm) for k in micro(rng_g)])
        return {"fake_z": jnp.asarray(fz), "fake_gumbel": jnp.asarray(fg),
                "gp_eps": jnp.asarray(ge), "gen_z": jnp.stack(gz), "gen_gumbel": jnp.stack(gg)}

    def noise(state_rng, step, shard=0):
        return {k: torch.from_numpy(np.array(v)) for k, v in draw(state_rng, step,
                                                                   shard).items()}

    return noise


def _reference_grads(cfg, mask, st0, st1, batch, step=0):
    """The reference's gradients of the first critic update of ``step`` (and
    the encoder's, with train_encoder; its aux values as ``d_aux``) and of
    the generator update, from its own modules, losses and ``_accum_vg``,
    along ``make_step_fn``'s branches; compiled as one program."""
    gen, critic = jax_make_models(cfg)
    t, m = cfg.train, cfg.model
    nc, A, V = t.n_critic, max(1, int(t.grad_accum)), m.vocab_size
    tau = jax_tau_schedule(cfg, jnp.asarray(step, jnp.int32))
    encoder = jax_make_encoder(m.encoder, use_pallas=m.use_pallas, dtype=m.dtype,
                               image_size=cfg.data.image_size, vit_dims=m.vit_dims)

    def critic_apply(d, f, x):
        return critic.apply({"params": d}, f, x)

    def sample_fake(g, feats, rng):
        rz, rg = jax.random.split(rng)
        z = jax.random.normal(rz, (feats.shape[0], m.noise_dim), m.dtype)
        return jax.lax.stop_gradient(gen.apply(
            {"params": g}, feats, z, rg, tau=tau, hard=t.hard,
            step_mask=jnp.asarray(mask))["soft"])

    def d_loss(d, feats, real_ids, fake, rng):
        real = jax.nn.one_hot(real_ids, V, dtype=fake.dtype)
        return jax_losses.critic_loss(critic_apply, d, feats, real, fake, rng,
                                      gp_lambda=t.gp_lambda, drift=t.drift)

    def d_vg(p, mb, k):
        return jax.value_and_grad(d_loss, has_aux=True)(p, *mb, k)

    def enc_feats(e, raw):
        return encoder.apply(e, jax_normalize_for(m.encoder, raw)).astype(m.dtype)

    def body(g0, d0, e0, d1, e1, data, triples):
        rng = jax.random.fold_in(jax.random.fold_in(st0.rng, step), 0)
        rng_d, rng_g = jax.random.split(rng)
        rng_dkeys, rng_fakes = jax.random.split(rng_d)
        key = jax.random.split(rng_dkeys, nc)[0]
        out = {}
        if encoder is None:
            flat = data[:nc].reshape(nc * data.shape[1], *data.shape[2:])
            fake = sample_fake(g0, flat, rng_fakes).reshape(nc, data.shape[1], 3, V)[0]
            (_, out["d_aux"]), out["d"] = jax_accum_vg(d_vg, d0, (data[0], triples[0], fake),
                                                      key, A)
            feats_g = data[nc]
        elif t.train_encoder:
            def joint(p, mb, k):
                key_f, key_gp = jax.random.split(k)

                def loss(d, e):
                    feats = enc_feats(e, mb[0])
                    fake = sample_fake(g0, jax.lax.stop_gradient(feats), key_f)
                    return d_loss(d, feats, mb[1], fake, key_gp)

                return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(*p)

            (_, out["d_aux"]), (out["d"], out["enc"]) = jax_accum_vg(
                joint, (d0, e0), (data[0], triples[0]), key, A)
            feats_g = enc_feats(e1, data[nc])
        else:
            key_f, key_gp = jax.random.split(key)
            feats = enc_feats(e0, data[0])
            fake = sample_fake(g0, feats, key_f)
            (_, out["d_aux"]), out["d"] = jax_accum_vg(d_vg, d0, (feats, triples[0], fake),
                                                      key_gp, A)
            feats_g = enc_feats(e0, data[nc])

        def g_vg(p, mb, k):
            return jax.value_and_grad(
                lambda g: jax_losses.generator_loss(critic_apply, d1, mb[0],
                                                    sample_fake_g(g, mb[0], k)),
                has_aux=True)(p)

        _, out["g"] = jax_accum_vg(g_vg, g0, (feats_g,), rng_g, A)
        return out

    def sample_fake_g(g, feats, rng):  # the generator update's fake carries its gradient
        rz, rg = jax.random.split(rng)
        z = jax.random.normal(rz, (feats.shape[0], m.noise_dim), m.dtype)
        return gen.apply({"params": g}, feats, z, rg, tau=tau, hard=t.hard,
                         step_mask=jnp.asarray(mask))["soft"]

    data = batch["features" if encoder is None else "images"]
    return jax.jit(body)(st0.g_params, st0.d_params, st0.enc_params, st1.d_params,
                         st1.enc_params, data, batch["triples"])


def _reference_state(jcfg, pcfg):
    """A reference ``GANTrainState`` at the weights of a fresh port state
    (flax's own init would compile for seconds), with optax's fresh optimizer
    states, as ``sgg.train.state.create_train_state`` assembles it."""
    init = tstate.create_train_state(pcfg, seed=0)
    g = jax.tree.map(jnp.asarray, generator_state_dict_to_flax(init.generator.state_dict()))
    d = jax.tree.map(jnp.asarray, critic_state_dict_to_flax(init.critic.state_dict()))
    e = None if init.encoder is None else jax.tree.map(
        jnp.asarray, encoder_state_dict_to_flax(init.encoder.state_dict(), jcfg.model.encoder))
    g_tx, d_tx = jax_make_optimizers(jcfg)
    return JaxGANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g, d_params=d, g_opt_state=g_tx.init(g),
        d_opt_state=d_tx.init(d), rng=jax.random.key(0), enc_params=e,
        g_ema=jax.tree.map(jnp.copy, g) if jcfg.train.ema_decay > 0 else None,
        enc_opt_state=(jax_make_encoder_optimizer(jcfg).init(e)
                       if jcfg.train.train_encoder else None))


def _run(name, sets):
    """Both packages' steps from one state, batches and noise → record."""
    jcfg, pcfg = _configs(name, sets)
    if jcfg.model.encoder == "precomputed":
        data = jax_synthetic_dataset(num_images=jcfg.data.num_synthetic_images,
                                     regions=jcfg.data.regions, feat_dim=jcfg.data.feat_dim,
                                     seed=0)
        ds = JaxTripleDataset(features=data["features"], triples=data["triples"])
        vocab = data["vocab"]
    else:
        ds, vocab = jax_load_dataset(jcfg)
    jcfg.model.vocab_size = pcfg.model.vocab_size = len(vocab)
    mask = vocab.step_mask()
    it = jax_make_train_iterator(ds, jcfg.train.batch_size, jcfg.train.n_critic, seed=0,
                                 process_index=0, process_count=1, device_put=False, prefetch=0)
    st = _reference_state(jcfg, pcfg)
    port = train_state_from_flax(pcfg, st)
    recorded = {"d": [], "enc": [], "g": []}
    for key, tx in (("d", port.d_tx), ("enc", port.enc_tx), ("g", port.g_tx)):
        if tx is not None:
            orig = tx.update
            tx.update = lambda grads, _o=orig, _k=key: (
                recorded[_k].append([g.clone() for g in grads]), _o(grads))[1]
    jstep, pstep = jax.jit(jax_make_step_fn(jcfg, mask)), make_step_fn(pcfg, mask)
    noise_fn = reference_noise(jcfg, jcfg.train.batch_size)
    steps = []
    for s in range(STEPS):
        batch = next(it)
        noise = noise_fn(st.rng, s)
        st0 = st
        st, jm = jstep(st, batch)
        pm = pstep(port, {k: torch.from_numpy(v) for k, v in batch.items()}, noise)
        steps.append({"jm": {k: float(v) for k, v in jm.items()},
                      "pm": {k: float(v) for k, v in pm.items()},
                      "ref": (generator_flax_to_state_dict(st.g_params, pcfg),
                              critic_flax_to_state_dict(st.d_params, pcfg),
                              None if st.enc_params is None
                              else encoder_flax_to_state_dict(st.enc_params),
                              None if st.g_ema is None
                              else generator_flax_to_state_dict(st.g_ema, pcfg)),
                      "port": ({k: v.clone() for k, v in port.generator.state_dict().items()},
                               {k: v.clone() for k, v in port.critic.state_dict().items()},
                               None if port.encoder is None
                               else {k: v.clone() for k, v in port.encoder.state_dict().items()},
                               None if port.g_ema is None
                               else {k: v.clone() for k, v in port.g_ema.items()})})
        if s == 0:
            first = (jcfg, mask, st0, st, batch)
    names = {"d": [n for n, _ in port.critic.named_parameters()],
             "g": [n for n, _ in port.generator.named_parameters()],
             "enc": (None if port.encoder is None
                     else [n for n, _ in port.encoder.named_parameters()])}
    return {"cfg": pcfg, "steps": steps, "recorded": recorded, "first": first,
            "names": names, "port": port}


# critic_unroll only sets how far XLA unrolls the reference's critic scan; 1
# compiles fastest and leaves the result as it is.
CASES = {
    "smoke": ("smoke", {"train.critic_unroll": 1}),
    "smoke_accum2_ema": ("smoke", {"train.critic_unroll": 1, "train.grad_accum": 2,
                                   "train.ema_decay": 0.99}),
    "vit_train_encoder": ("vit_b16", {**VIT_SETS, "train.train_encoder": True}),
    "vit_frozen_encoder": ("vit_b16", {**VIT_SETS, "train.train_encoder": False}),
}


@functools.cache
def _run_case(name):
    return _run(*CASES[name])


@pytest.fixture
def parity(request):
    """One case's record, computed once per process (its tests come in any
    order)."""
    return _run_case(request.param)


def _assert_params_close(got: dict, want: dict, lr: float, updates: int):
    loose = total = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        far = d > 1e-6 + 1e-5 * w.abs()
        assert (d[far] <= 2 * lr * updates + 1e-6).all(), (k, d.max().item())
        loose += int(far.sum())
        total += w.numel()
    assert loose <= 1e-2 * total, (loose, total)


@pytest.mark.parametrize("parity", sorted(CASES), indirect=True)
def test_step_metrics_match_reference(parity):
    for s in parity["steps"]:
        assert set(s["pm"]) == set(s["jm"])
        for k, v in s["jm"].items():
            np.testing.assert_allclose(s["pm"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("parity", sorted(CASES), indirect=True)
def test_step_parameters_match_reference(parity):
    t = parity["cfg"].train
    for i, s in enumerate(parity["steps"], start=1):
        (g, d, e, ema), (rg, rd, re, rema) = s["port"], s["ref"]
        _assert_params_close(g, rg, t.g_lr, i)
        _assert_params_close(d, rd, t.d_lr, i * t.n_critic)
        if re is not None:
            _assert_params_close(e, re, t.enc_lr, i * t.n_critic if t.train_encoder else 0)
        if rema is not None:
            _assert_params_close(ema, rema, t.g_lr, i)


@pytest.mark.parametrize("parity", ["smoke", "vit_train_encoder"], indirect=True)
def test_update_gradients_match_reference(parity):
    """The first critic update (critic, and the encoder with train_encoder)
    and the generator update of the first step, on the precomputed and the
    train_encoder branches (the frozen branch's and grad_accum's updates are
    held through their parameters)."""
    cfg = parity["cfg"]
    ref = _reference_grads(*parity["first"])
    want = {"d": critic_flax_to_state_dict(ref["d"], cfg),
            "g": generator_flax_to_state_dict(ref["g"], cfg)}
    if "enc" in ref:
        want["enc"] = encoder_flax_to_state_dict(ref["enc"])
    nc = cfg.train.n_critic
    assert len(parity["recorded"]["d"]) == STEPS * nc
    assert len(parity["recorded"]["g"]) == STEPS
    assert len(parity["recorded"]["enc"]) == (STEPS * nc if cfg.train.train_encoder else 0)
    for key, sd in want.items():
        got = dict(zip(parity["names"][key], parity["recorded"][key][0]))
        assert set(got) == set(sd)
        largest = max(float(w.abs().max()) for w in sd.values())
        for k, w in sd.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-4 * float(w.abs().max()) + 1e-6 * largest,
                                       err_msg=f"{key} {k}")


def test_tau_schedule_matches_reference():
    jcfg, pcfg = _configs("smoke", {"train.tau_anneal": 1e-3, "train.tau0": 2.0,
                                    "train.tau_min": 0.3})
    for step in (0, 1, 17, 500, 5000):
        want = float(jax_tau_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(tau_schedule(pcfg, step), want, rtol=1e-6)


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
def test_lr_schedule_matches_reference(kind):
    sets = {"train.lr_schedule": kind, "train.warmup_steps": 3, "train.total_steps": 20,
            "train.lr_final_frac": 0.1}
    jcfg, pcfg = _configs("smoke", sets)
    for per_step in (1, 5):
        want_fn = jax_lr_schedule_fn(jcfg, 2e-4, per_step)
        got_fn = tstate.lr_schedule_fn(pcfg, 2e-4, per_step)
        for count in range(0, 20 * per_step + 3):
            np.testing.assert_allclose(got_fn(count), float(want_fn(count)), rtol=1e-6)
    jcfg, pcfg = _configs("smoke", {})
    assert tstate.lr_schedule_fn(pcfg, 1e-4, 5) is None
    assert jax_lr_schedule_fn(jcfg, 1e-4, 5) is None
    with pytest.raises(ValueError, match="lr_schedule"):
        tstate.lr_schedule_fn(_configs("smoke", {"train.lr_schedule": "step"})[1], 1e-4, 1)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_matches_optax_on_both_sides(max_norm):
    r = np.random.RandomState(0)
    grads = [r.randn(3, 4).astype(np.float32), r.randn(5).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = tstate.clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
    norm = np.sqrt(sum((g ** 2).sum() for g in grads))
    assert (norm > max_norm) == (max_norm == 0.5)  # one case each side
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_adam_update_matches_optax():
    cfg = get_config("smoke").override(["train.grad_clip=1.0"])
    mod = torch.nn.Linear(4, 3)
    params = [p.detach().numpy().copy() for p in mod.parameters()]
    tx = tstate.Adam(mod, 1e-3, cfg, 1)
    otx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3, b1=0.5, b2=0.9))
    ostate = otx.init([jnp.asarray(p) for p in params])
    r = np.random.RandomState(1)
    for _ in range(3):
        grads = [r.randn(*p.shape).astype(np.float32) for p in params]
        upd, ostate = otx.update([jnp.asarray(g) for g in grads], ostate)
        params = [p + np.asarray(u) for p, u in zip(params, upd)]
        tx.update([torch.from_numpy(g) for g in grads])
        for p, w in zip(mod.parameters(), params):
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6, atol=1e-8)
    assert tx.count == 3


def test_vit_gradients_through_flash_match_reference():
    """Parameter gradients of the ViT on the port's flash route (the
    autograd Function, its plain backward on the CPU) against ``jax.grad`` of
    the flax ViT with ``attn_fn=flash_attention`` (the Pallas forward and
    backward in interpret mode), under a fixed linear loss."""
    dims = (64, 1, 4)
    images = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    x = np.asarray(jax_normalize_for("vit_b16", jnp.asarray(images)))
    w = np.random.RandomState(1).randn(2, 16, 64).astype(np.float32)
    enc = make_encoder("vit_b16", use_pallas=True, image_size=64, vit_dims=dims, trainable=True)
    params = jax.tree.map(jnp.asarray, encoder_state_dict_to_flax(enc.state_dict(), "vit_b16"))
    jenc = jax_make_encoder("vit_b16", attn_fn=jax_flash_attention, image_size=64, vit_dims=dims)
    want = jax.jit(jax.grad(lambda p: (jenc.apply(p, jnp.asarray(x)) * w).sum()))(params)
    loss = (enc(torch.from_numpy(np.array(x))) * torch.from_numpy(w)).sum()
    got = dict(zip([n for n, _ in enc.named_parameters()],
                   torch.autograd.grad(loss, list(enc.parameters()))))
    for k, v in encoder_flax_to_state_dict(want).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * float(v.abs().max()), err_msg=k)


def test_host_iterator_matches_reference():
    data = jax_synthetic_dataset(num_images=20, regions=4, feat_dim=8, seed=3)
    jds = JaxTripleDataset(features=data["features"], triples=data["triples"])
    tds = TripleDataset(features=data["features"], triples=data["triples"])
    want = jax_make_train_iterator(jds, 5, 2, seed=7, process_index=0, process_count=1,
                                   device_put=False, prefetch=0)
    for prefetch in (0, 2):
        it = make_train_iterator(tds, 5, 2, seed=7, prefetch=prefetch)
        for _ in range(3):
            b, w = next(it), next(want)
            assert b.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(b[k], w[k])
        it.close()
        want = jax_make_train_iterator(jds, 5, 2, seed=7, process_index=0, process_count=1,
                                       device_put=False, prefetch=0)


def test_device_iterator_draws_real_pairs():
    data = jax_synthetic_dataset(num_images=20, regions=4, feat_dim=8, seed=3)
    tds = TripleDataset(features=data["features"], triples=data["triples"])
    it = make_device_train_iterator(tds, 6, 3, seed=1, device="cpu")
    a = next(it)
    assert a["features"].shape == (4, 6, 4, 8) and a["triples"].shape == (4, 6, 3)
    feats = torch.from_numpy(data["features"])
    for sub in range(4):
        for row in range(6):
            img = int(torch.nonzero((feats == a["features"][sub, row]).all(-1).all(-1))[0])
            assert any((t == a["triples"][sub, row].numpy()).all() for t in tds.triples[img])
    again = next(make_device_train_iterator(tds, 6, 3, seed=1, device="cpu"))
    assert all(torch.equal(a[k], again[k]) for k in a)


def test_noise_layout_and_refusals():
    _, pcfg = _configs("vit_b16", {**VIT_SETS, "train.train_encoder": True,
                                   "train.grad_accum": 2})
    shapes = noise_shapes(pcfg, 4)
    assert shapes["fake_z"] == (2, 2, 2, 8) and shapes["gp_eps"] == (2, 2, 2, 1, 1)
    # REINFORCE, refused before it was ported, builds a step
    # (tests/test_torch_reinforce.py holds it against the reference).
    assert callable(make_step_fn(_configs("smoke", {"train.estimator": "reinforce"})[1]))
    # So does MoE on one device (tests/test_torch_moe.py). Without a mesh an
    # 'expert' axis and pp_microbatches build a plain step too, as the
    # reference's step has no sp_mesh (tests/test_torch_ep.py and
    # tests/test_torch_pp.py hold the gspmd step with EP and with PP).
    assert callable(make_step_fn(_configs("smoke", {"model.moe_experts": 4})[1]))
    assert callable(make_step_fn(_configs("smoke", {"model.moe_experts": 4,
                                                    "mesh.expert": 2})[1]))
    assert callable(make_step_fn(_configs("vit_b16", {"model.pp_microbatches": 2})[1]))
    # FSDP and TP, refused before they were ported, build a step too
    # (tests/test_torch_tp_fsdp.py holds the gspmd step against the reference).
    assert callable(make_step_fn(_configs("smoke", {"mesh.fsdp": True, "mesh.model": 2})[1]))
    # A 'seq' axis and sp_mode (A8c) build a step too; without a mesh the
    # step ignores sp_mode, as the reference's step has no sp_mesh
    # (tests/test_torch_sp.py holds the gspmd step with SP).
    assert callable(make_step_fn(_configs("smoke", {"mesh.seq": 2})[1]))
    r = np.random.RandomState(0)
    batch = {"images": torch.from_numpy(r.randint(0, 256, (3, 4, 64, 64, 3), dtype=np.uint8)),
             "triples": torch.from_numpy(r.randint(2, 26, (3, 4, 3)))}
    metrics = []
    for sp in ("", "ring"):
        cfg = _configs("vit_b16", {**VIT_SETS, "train.train_encoder": True,
                                   "model.vocab_size": 26, "model.sp_mode": sp})[1]
        metrics.append(make_step_fn(cfg)(tstate.create_train_state(cfg, 0), batch))
    assert metrics[0] == metrics[1]
    for sets, err, match in (
            ({"train.estimator": "ppo"}, ValueError, "estimator"),
            ({"train.train_encoder": True}, ValueError, "end-to-end")):
        with pytest.raises(err, match=match):
            make_step_fn(_configs("smoke", sets)[1])
    # A CNN encoder trains on the kernel-route config too (its convs on the
    # library conv; tests/test_torch_train_encoder_cnn.py).
    assert callable(make_step_fn(_configs("resnet50", {"train.train_encoder": True})[1]))
    # Triple weights, which the iterators refused before predicate balance
    # was ported, are now drawn from (tests/test_torch_data_balance.py).
    data = jax_synthetic_dataset(num_images=8, regions=2, feat_dim=4, seed=0)
    tds = TripleDataset(features=data["features"], triples=data["triples"],
                        triple_weights=[np.ones(len(t)) / len(t) for t in data["triples"]])
    assert next(make_train_iterator(tds, 2, 1, prefetch=0))["triples"].shape == (2, 2, 3)
    assert next(make_device_train_iterator(tds, 2, 1, device="cpu"))["triples"].shape == (2, 2, 3)


def test_warm_autograd_runs_once_per_device_and_touches_no_state(monkeypatch):
    _, pcfg = _configs("smoke", {})
    monkeypatch.setattr(step_mod, "_warmed", set())
    calls = []
    monkeypatch.setattr(step_mod, "warm_autograd", calls.append)
    r = np.random.RandomState(0)
    B, nc, V = pcfg.train.batch_size, pcfg.train.n_critic, pcfg.model.vocab_size
    batch = {"features": torch.from_numpy(r.standard_normal(
                 (nc + 1, B, pcfg.data.regions, pcfg.data.feat_dim)).astype(np.float32)),
             "triples": torch.from_numpy(r.randint(2, V, (nc + 1, B, 3)))}
    states = []
    for warm in (False, True):
        state = tstate.create_train_state(pcfg, 0)
        if warm:
            before = [t.clone() for t in state.tensors()]
            seq = (torch.zeros((), requires_grad=True) * 1).grad_fn._sequence_nr()
            assert step_warm(torch.device("cpu")) > 0
            assert (torch.zeros((), requires_grad=True) * 1).grad_fn._sequence_nr() >= (
                seq + step_mod.SEQUENCE_MARGIN)
            assert step_warm("cpu") == 0 and step_warm(torch.device("cpu")) == 0
            assert all(torch.equal(a, b) for a, b in zip(before, state.tensors(), strict=True))
        make_step_fn(pcfg)(state, batch)
        states.append(state.tensors())
    assert calls == []  # a CPU step never calls it
    assert all(torch.equal(a, b) for a, b in zip(*states, strict=True))
