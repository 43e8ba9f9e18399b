"""Port fused decode: ``decode_plain`` (the CUDA kernel's plain version) against
the JAX Pallas kernel (interpret mode on the CPU) and its jnp reference.

Same numpy-seeded weights and features and the same ``jax.random`` Gumbel
noise go into both packages. Tolerances: f32 soft samples within 2e-5, the
JAX suite's own kernel-vs-reference tolerance (float32 sums in another
order); hard samples must give identical tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.kernels import fused_decode as jfd
from sgg.models.generator import AttentionLSTMGenerator as JaxGenerator
from sgg_torch.kernels import build
from sgg_torch.kernels import fused_decode as tfd

torch.set_num_threads(1)

V, F, H, E, A, Z, B, R = 32, 16, 16, 8, 8, 4, 6, 9


@pytest.fixture(scope="module")
def setup():
    gen = JaxGenerator(vocab_size=V, hidden=H, embed_dim=E, attn_dim=A, noise_dim=Z)
    r = np.random.RandomState(0)
    feats = r.randn(B, R, F).astype(np.float32)
    z = r.randn(B, Z).astype(np.float32)
    gvars = gen.init(jax.random.key(0), jnp.asarray(feats), jnp.asarray(z), jax.random.key(1))
    jparams = jfd.decode_params_from_generator(gvars["params"])
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    mask = np.zeros((3, V), bool)
    mask[0, 2:20] = mask[2, 2:20] = True
    mask[1, 20:] = True
    return np_params, feats, z, mask


def _torch_inputs(np_params, feats, z, g, dtype=torch.float32):
    params = tfd.cast_params(np_params, dtype)
    return (params, torch.from_numpy(feats).to(dtype), torch.from_numpy(z).to(dtype),
            torch.from_numpy(np.array(g)))


def _assert_same(got, ref, hard):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    if hard:
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        np.testing.assert_array_equal(got, ref)  # one-hots
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hard", [False, True])
def test_plain_matches_pallas_kernel(setup, hard, masked):
    np_params, feats, z, mask = setup
    g = jfd.decode_gumbel_noise(jax.random.key(3), B, V)
    mb = jfd.step_mask_bias(mask) if masked else None
    ref = jfd.fused_decode(np_params, jnp.asarray(feats), jnp.asarray(z), g,
                           tau=1.0, mask_bias=mb, hard=hard, block_b=4)
    params, tf, tz, tg = _torch_inputs(np_params, feats, z, g)
    tmb = tfd.step_mask_bias(mask) if masked else None
    got = tfd.decode_plain(params, tf, tz, tg, tau=1.0, mask_bias=tmb, hard=hard)
    _assert_same(got, ref, hard)
    if masked:
        toks = got.argmax(-1).numpy()
        assert (toks[:, 0] < 20).all() and (toks[:, 1] >= 20).all()


@pytest.mark.parametrize("hard", [False, True])
def test_plain_matches_reference(setup, hard):
    np_params, feats, z, mask = setup
    g = jfd.decode_gumbel_noise(jax.random.key(5), B, V)
    ref = jfd.decode_reference(np_params, jnp.asarray(feats), jnp.asarray(z), g,
                               tau=0.7, mask_bias=jfd.step_mask_bias(mask), hard=hard)
    params, tf, tz, tg = _torch_inputs(np_params, feats, z, g)
    got = tfd.decode_plain(params, tf, tz, tg, tau=0.7,
                           mask_bias=tfd.step_mask_bias(mask), hard=hard)
    _assert_same(got, ref, hard)


def test_plain_bf16_matches_pallas_kernel(setup):
    """bf16 cast points: soft samples within 2e-2 of the Pallas kernel
    (bf16 keeps about 3 significant digits; tanh and exp differ by an ulp)."""
    np_params, feats, z, _ = setup
    g = jfd.decode_gumbel_noise(jax.random.key(7), B, V)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    ref = jfd.fused_decode(jp, jnp.asarray(feats, jnp.bfloat16), jnp.asarray(z, jnp.bfloat16),
                           g, tau=1.0, hard=False, block_b=8)
    params, tf, tz, tg = _torch_inputs(np_params, feats, z, g, torch.bfloat16)
    got = tfd.decode_plain(params, tf, tz, tg, tau=1.0, hard=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


def test_ragged_batch_rows_independent(setup):
    """A ragged batch (the JAX kernel pads B=5 to its 4-row tiles) gives the
    same rows as the full batch."""
    np_params, feats, z, _ = setup
    g = np.asarray(jfd.decode_gumbel_noise(jax.random.key(11), B, V))
    ref = jfd.fused_decode(np_params, jnp.asarray(feats[:5]), jnp.asarray(z[:5]),
                           jnp.asarray(g[:5]), hard=False, block_b=4)
    params, tf, tz, tg = _torch_inputs(np_params, feats, z, g)
    full = tfd.decode_plain(params, tf, tz, tg, hard=False)
    part = tfd.decode_plain(params, tf[:5], tz[:5], tg[:5].contiguous(), hard=False)
    np.testing.assert_allclose(part.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(part.numpy(), full[:5].numpy(), rtol=1e-6, atol=1e-6)


def test_wrapper_takes_plain_version_on_cpu(setup):
    np_params, feats, z, mask = setup
    g = jfd.decode_gumbel_noise(jax.random.key(13), B, V)
    params, tf, tz, tg = _torch_inputs(np_params, feats, z, g)
    before = tfd.launches
    got = tfd.fused_decode(params, tf, tz, tg, mask_bias=tfd.step_mask_bias(mask))
    want = tfd.decode_plain(params, tf, tz, tg, mask_bias=tfd.step_mask_bias(mask))
    assert torch.equal(got, want)
    assert tfd.launches == before  # only a kernel launch counts


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_input_check_rejects(setup, bad):
    np_params, feats, z, _ = setup
    params, tf, tz, _ = _torch_inputs(np_params, feats, z, np.zeros((B, 3, V), np.float32))
    g = torch.zeros(B, 3, V)
    mb = torch.zeros(3, V)
    if bad == "dtype":
        params["k"] = params["k"].to(torch.bfloat16)
    elif bad == "shape":
        g = torch.zeros(B, 3, V + 1)
    else:
        params["wf"] = params["wf"].t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        tfd._check(params, tf, tz, g, mb)


def test_build_is_plain_nvcc_for_sm90a():
    """One .cu source per kernel, each with a plain C entry, no PyTorch
    headers anywhere; nvcc targets sm_90a and the build happens at first
    launch, not at import."""
    srcs = build.sources()
    assert [p.name for p in srcs] == ["conv_direct.cu", "flash_attention.cu",
                                       "flash_attention_bwd.cu", "fused_decode.cu",
                                       "fused_matmul.cu"]
    for src in srcs:
        text = src.read_text()
        assert "torch/extension.h" not in text and 'extern "C"' in text, src.name
    for header in build.headers():
        assert "torch" not in header.read_text(), header.name
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_tie_takes_the_first_index(setup, dtype):
    """wv's and bv's column 21 a copy of column 3, the Gumbel noise copied
    and both columns far above the rest: y ties exactly at 3 and 21 in every
    row and step, and the plain version, like the Pallas kernel (interpret
    mode), takes the first, 3; the CUDA kernel is held to the same on the
    card."""
    np_params, feats, z, _ = setup
    n1, n2 = 3, 21
    tied = {k: v.copy() for k, v in np_params.items()}
    tied["wv"][:, n2] = tied["wv"][:, n1]
    tied["bv"][[n1, n2]] = 100.0
    g = np.array(jfd.decode_gumbel_noise(jax.random.key(17), B, V))
    g[:, :, n2] = g[:, :, n1]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jfd.fused_decode({k: jnp.asarray(v) for k, v in tied.items()},
                           jnp.asarray(feats, jdt), jnp.asarray(z, jdt), jnp.asarray(g),
                           hard=True, block_b=4)
    params, tf, tz, tg = _torch_inputs(tied, feats, z, g, dtype)
    got = tfd.decode_plain(params, tf, tz, tg, hard=True)
    assert (np.asarray(ref, np.float32).argmax(-1) == n1).all()
    assert (got.float().argmax(-1) == n1).all()
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_hot_feedback_is_the_chosen_row_bit_for_bit(dtype):
    """rnd(y @ emb) for a one-hot y is emb[first] exactly (each sum holds one
    product by 1.0 and zeros), so the batched CUDA instance reads that row
    in hard mode instead of the product."""
    r = np.random.RandomState(3)
    Vq, Eq, Bq = 300, 64, 16
    emb = torch.from_numpy(r.randn(Vq, Eq).astype(np.float32) * 10.0 ** r.randint(
        -20, 20, size=(Vq, Eq))).to(dtype)
    first = torch.from_numpy(r.randint(0, Vq, size=Bq))
    y = torch.zeros(Bq, Vq, dtype=dtype)
    y[torch.arange(Bq), first] = 1.0
    product = (y.to(torch.float32) @ emb.to(torch.float32)).to(dtype)  # decode_plain's feedback
    assert torch.equal(product, emb[first])
