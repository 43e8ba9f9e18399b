"""Port generator modules against the flax ones: ``TF1LSTMCell``,
``AdditiveAttention`` and ``AttentionLSTMGenerator`` with the same weights
(moved across by ``convert_flax``) and the same ``jax.random`` noise.

Tolerance 1e-5 on float32 soft samples, logits and states (float32 sums in
another order); hard tokens identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.kernels.fused_decode import decode_gumbel_noise
from sgg.models.attention import AdditiveAttention as JaxAttention
from sgg.models.generator import AttentionLSTMGenerator as JaxGenerator
from sgg.models.lstm import TF1LSTMCell as JaxCell
from sgg_torch.convert_flax import flax_to_state_dict
from sgg_torch.kernels import fused_decode as tfd
from sgg_torch.models import AdditiveAttention, AttentionLSTMGenerator, TF1LSTMCell

torch.set_num_threads(1)

V, F, H, E, A, Z, B, R = 32, 16, 16, 8, 8, 4, 6, 9
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.array(x, np.float32)


@pytest.fixture(scope="module")
def setup():
    gen = JaxGenerator(vocab_size=V, hidden=H, embed_dim=E, attn_dim=A, noise_dim=Z)
    r = np.random.RandomState(0)
    feats = r.randn(B, R, F).astype(np.float32)
    z = r.randn(B, Z).astype(np.float32)
    gvars = gen.init(jax.random.key(0), jnp.asarray(feats), jnp.asarray(z), jax.random.key(1))
    port = AttentionLSTMGenerator(vocab_size=V, feat_dim=F, hidden=H, embed_dim=E,
                                  attn_dim=A, noise_dim=Z)
    port.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, gvars["params"])))
    mask = np.zeros((3, V), bool)
    mask[0, 2:20] = mask[2, 2:20] = True
    mask[1, 20:] = True
    return gen, gvars, port, feats, z, mask


def test_lstm_cell_matches_flax():
    r = np.random.RandomState(1)
    x = r.randn(5, 7).astype(np.float32)
    c = r.randn(5, H).astype(np.float32)
    h = r.randn(5, H).astype(np.float32)
    cell = JaxCell(H)
    v = cell.init(jax.random.key(2), (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(x))
    (jc, jh), _ = cell.apply(v, (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(x))
    port = TF1LSTMCell(7, H)
    port.load_state_dict({"kernel": torch.from_numpy(_np(v["params"]["kernel"])),
                          "bias": torch.from_numpy(_np(v["params"]["bias"]) + 0.1)})
    (tc, th), _ = port((torch.from_numpy(c), torch.from_numpy(h)), torch.from_numpy(x))
    # The flax cell with the same shifted bias: the forget bias is added, not stored.
    v2 = {"params": {"kernel": v["params"]["kernel"], "bias": v["params"]["bias"] + 0.1}}
    (jc, jh), _ = cell.apply(v2, (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(x))
    np.testing.assert_allclose(tc.detach().numpy(), _np(jc), **TOL)
    np.testing.assert_allclose(th.detach().numpy(), _np(jh), **TOL)


def test_attention_matches_flax():
    r = np.random.RandomState(3)
    feats = r.randn(B, R, F).astype(np.float32)
    h = r.randn(B, H).astype(np.float32)
    att = JaxAttention(A)
    v = att.init(jax.random.key(4), jnp.asarray(feats), jnp.asarray(h))
    jctx, jalpha = att.apply(v, jnp.asarray(feats), jnp.asarray(h))
    port = AdditiveAttention(F, H, A)
    p = v["params"]
    port.load_state_dict({
        "feat_proj.weight": torch.from_numpy(_np(p["feat_proj"]["kernel"]).T.copy()),
        "state_proj.weight": torch.from_numpy(_np(p["state_proj"]["kernel"]).T.copy()),
        "state_proj.bias": torch.from_numpy(_np(p["state_proj"]["bias"])),
        "score.weight": torch.from_numpy(_np(p["score"]["kernel"]).T.copy()),
    })
    ctx, alpha = port(torch.from_numpy(feats), torch.from_numpy(h))
    np.testing.assert_allclose(ctx.detach().numpy(), _np(jctx), **TOL)
    np.testing.assert_allclose(alpha.detach().numpy(), _np(jalpha), **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hard", [False, True])
def test_generator_matches_flax(setup, hard, masked):
    gen, gvars, port, feats, z, mask = setup
    rng = jax.random.key(42)
    step_mask = jnp.asarray(mask) if masked else None
    out = gen.apply(gvars, jnp.asarray(feats), jnp.asarray(z), rng, tau=0.7,
                    hard=hard, step_mask=step_mask)
    g = torch.from_numpy(np.array(decode_gumbel_noise(rng, B, V)))
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(z), g, tau=0.7, hard=hard,
                   step_mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got["soft"].numpy(), _np(out["soft"]), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(), _np(out["logits"]), **TOL)
    np.testing.assert_allclose(got["attention"].numpy(), _np(out["attention"]), **TOL)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(out["tokens"]))


def test_generator_matches_plain_decode(setup):
    """The generator and the kernel's plain version give the same hard tokens
    for the same noise (the kernel's masked logits use an additive -1e9)."""
    gen, gvars, port, feats, z, mask = setup
    g = torch.from_numpy(np.array(decode_gumbel_noise(jax.random.key(8), B, V)))
    tf, tz = torch.from_numpy(feats), torch.from_numpy(z)
    with torch.no_grad():
        out = port(tf, tz, g, hard=True, step_mask=torch.from_numpy(mask))
        params = tfd.decode_params_from_generator(port.state_dict())
        y = tfd.decode_plain(params, tf, tz, g, mask_bias=tfd.step_mask_bias(mask))
    np.testing.assert_array_equal(y.argmax(-1).numpy(), out["tokens"].numpy())


def test_generator_from_config_rejects_transformer():
    from sgg_torch.config import get_config

    cfg = get_config("smoke")
    cfg.model.decoder = "transformer"
    with pytest.raises(NotImplementedError):
        AttentionLSTMGenerator.from_config(cfg)
