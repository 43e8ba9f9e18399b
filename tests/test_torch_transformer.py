"""The port's transformer triple decoder against the reference's flax module,
with the reference's own parameters converted and the same ``jax.random``
noise, at the ``smoke`` widths with ``model.decoder = "transformer"``
(hidden 32, 8 heads, 4 layers, V = 40, F = 16, R = 9); and the
generator-forward sampler ``make_sampler``/``make_indexed_sampler`` on it.

Tolerances: float32 logits and the cross-attention map within 1e-4 x
max|ref| (float32 sums in another order); hard tokens identical given the
same z and Gumbel noise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.config import get_config as jax_get_config
from sgg.eval.sampler import make_indexed_sampler as jax_make_indexed_sampler
from sgg.eval.sampler import make_sampler as jax_make_sampler
from sgg.train.state import make_models
from sgg.utils.gumbel import sample_gumbel as jax_sample_gumbel
from sgg_torch.config import Config as PortConfig
from sgg_torch.convert_flax import generator_flax_to_state_dict, generator_state_dict_to_flax
from sgg_torch.eval.sampler import make_fused_sampler, make_indexed_sampler, make_sampler
from sgg_torch.models.transformer import TransformerTripleGenerator
from sgg_torch.train.state import make_generator

torch.set_num_threads(1)

V, B, K = 40, 6, 3


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_config("smoke")
    cfg.model.decoder = "transformer"
    cfg.model.vocab_size = V
    gen, _ = make_models(cfg)
    r = np.random.RandomState(0)
    feats = r.randn(B, cfg.data.regions, cfg.data.feat_dim).astype(np.float32)
    z = r.randn(B, cfg.model.noise_dim).astype(np.float32)
    params = gen.init(jax.random.key(0), jnp.asarray(feats), jnp.asarray(z),
                      jax.random.key(1))["params"]
    # Non-trivial LayerNorm and bias leaves, so every conversion is tested.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            (1.0 + 0.1 * r.randn(*v.shape)) if path[-1].key == "scale"
            else (0.1 * r.randn(*v.shape)) if path[-1].key == "bias" else v, np.float32),
        params)
    port_cfg = PortConfig.from_json(cfg.to_json())
    sd = generator_flax_to_state_dict(params, port_cfg)
    mask = np.zeros((3, V), bool)
    mask[0, :20] = mask[2, :20] = True
    mask[1, 20:] = True
    return cfg, port_cfg, gen, params, sd, feats, z, mask


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_reference(setup, masked):
    cfg, port_cfg, gen, params, sd, feats, z, mask = setup
    rng = jax.random.key(3)
    step_mask = mask if masked else None
    want = gen.apply({"params": params}, jnp.asarray(feats), jnp.asarray(z), rng,
                     hard=True, step_mask=None if step_mask is None else jnp.asarray(step_mask))
    g = np.array(jax_sample_gumbel(rng, (B, 3, V), jnp.float32))
    port = make_generator(port_cfg)
    assert isinstance(port, TransformerTripleGenerator)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(z), torch.from_numpy(g), hard=True,
                   step_mask=None if step_mask is None else torch.from_numpy(step_mask))
    logits = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), logits, rtol=0,
                               atol=1e-4 * np.abs(logits).max())
    attn = np.asarray(want["attention"])
    assert tuple(got["attention"].shape) == attn.shape == (B, 3, cfg.data.regions)
    np.testing.assert_allclose(got["attention"].numpy(), attn, rtol=0, atol=1e-4 * attn.max())
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["soft"].numpy(), np.asarray(want["soft"]))


def test_forward_refuses_unported_sampling_options(setup):
    """Forced slots (the PredCls scorer's, refused before they were ported)
    replace the slot's one-hot and token and leave the other slots as they
    were; the sampling options give the straight-through path's tokens."""
    _, port_cfg, _, _, sd, feats, z, _ = setup
    port = make_generator(port_cfg)
    port.load_state_dict(sd)
    args = (torch.from_numpy(feats), torch.from_numpy(z), torch.zeros(B, 3, V))
    forced = torch.full((B, 3), 3, dtype=torch.long)
    with torch.no_grad():
        free = port(*args, hard=True)
        clamped = port(*args, hard=True, forced_steps=(1,), forced_tokens=forced)
    assert torch.equal(clamped["tokens"][:, 1], forced[:, 1])
    assert torch.equal(clamped["tokens"][:, ::2], free["tokens"][:, ::2])
    assert torch.equal(clamped["logits"], free["logits"])
    with torch.no_grad():
        for kw in (dict(sample_temp=0.5), dict(sample_top_k=5), dict(sample_top_p=0.9)):
            detached = port(*args, hard=True, detach_sample=True, **kw)
            assert torch.equal(detached["tokens"], port(*args, hard=True, **kw)["tokens"])


def _reference_noise(cfg, rng, n):
    """make_sampler's draws for the slot decoder: split(rng, K), then per
    draw split(key) into z and one [B, 3, V] Gumbel draw."""
    zs, gs = [], []
    for key in jax.random.split(rng, K):
        kz, kg = jax.random.split(key)
        zs.append(np.array(jax.random.normal(kz, (n, cfg.model.noise_dim), cfg.model.dtype)))
        gs.append(np.array(jax_sample_gumbel(kg, (n, 3, V), jnp.float32)))
    return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(gs))


def test_sampler_matches_reference(setup):
    cfg, port_cfg, _, params, sd, feats, _, mask = setup
    rng = jax.random.key(7)
    want = jax_make_sampler(cfg, step_mask=mask, num_samples=K)(params, jnp.asarray(feats), rng)
    got = make_sampler(port_cfg, step_mask=mask, num_samples=K)(
        sd, torch.from_numpy(feats), noise=_reference_noise(cfg, rng, B))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, K, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_indexed_sampler_matches_reference(setup):
    cfg, port_cfg, _, params, sd, feats, _, mask = setup
    rng = jax.random.key(11)
    idx = np.array([4, 1, 5, 0], np.int32)
    want = jax_make_indexed_sampler(cfg, step_mask=mask, num_samples=K)(
        params, jnp.asarray(feats), jnp.asarray(idx), rng)
    got = make_indexed_sampler(port_cfg, step_mask=mask, num_samples=K)(
        sd, torch.from_numpy(feats), idx, noise=_reference_noise(cfg, rng, len(idx)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampler_own_noise_and_refusals(setup):
    _, port_cfg, _, _, sd, feats, _, mask = setup
    sampler = make_sampler(port_cfg, step_mask=mask, num_samples=5)
    a = sampler(sd, torch.from_numpy(feats), torch.Generator().manual_seed(3))
    b = sampler(sd, torch.from_numpy(feats), torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (B, 5, 3)
    toks = a.reshape(-1, 3).numpy()
    assert (toks[:, 0] < 20).all() and (toks[:, 1] >= 20).all() and (toks[:, 2] < 20).all()
    for kw in (dict(tau=0.5), dict(with_logp=True), dict(top_k=3), dict(top_p=0.9)):
        out = make_sampler(port_cfg, step_mask=mask, num_samples=5, **kw)(
            sd, torch.from_numpy(feats), torch.Generator().manual_seed(3))
        toks = out[0] if kw.get("with_logp") else out
        assert toks.shape == (B, 5, 3) and (toks[..., 1] >= 20).all()
        if kw.get("with_logp"):
            assert torch.equal(toks, a) and bool((out[1] <= 0).all())
    with pytest.raises(ValueError, match="attention-LSTM"):
        make_fused_sampler(port_cfg)


def test_converter_round_trip_and_refusals(setup):
    _, port_cfg, _, params, sd, _, _, _ = setup
    back = generator_state_dict_to_flax(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(flat_b[path], v)
    extra = dict(params, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unknown"):
        generator_flax_to_state_dict(extra, port_cfg)
    missing = {k: v for k, v in params.items() if k != "ln_out"}
    with pytest.raises(ValueError, match="missing"):
        generator_flax_to_state_dict(missing, port_cfg)
