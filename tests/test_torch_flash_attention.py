"""The port's flash-attention forward against the reference's.

``flash_attention_plain`` (what the CUDA kernel computes, and what the
wrappers run on a CPU tensor) against ``sgg.kernels.flash_attention`` in
interpret mode: once with the default 1024 blocks (the Pallas kernel's
single-key-block path) and once with blocks of 64 (its multi-block online
recurrence). Inputs are numpy-seeded.

Tolerances: float32 outputs within 1e-4 x max|ref| (float32 sums in another
order; the online rescale moves the last bits); lse within 1e-5 relative.
bfloat16 at D = 64 (the scale 1/8 is exact in bf16): every output within one
bf16 ulp of the reference's plus the float32 bound (both round a float32
value once; near zero the float32 sums' own error exceeds an ulp), and at
most 1 % of the outputs differ at all (measured: 0.02 %).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgg.kernels.flash_attention import attention_reference as jax_attention_reference
from sgg.kernels.flash_attention import flash_attention as jax_flash_attention
from sgg.kernels.flash_attention import flash_attention_with_lse as jax_flash_with_lse
from sgg_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)

SHAPES = [(1, 2, 64, 32), (2, 4, 196, 64), (1, 1, 100, 32)]


def _qkv(shape, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(*shape).astype(np.float32) for _ in range(3)]


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp of each value (0 where the value is 0)."""
    e = np.frexp(np.abs(x))[1]
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("block", [1024, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference_float32(shape, block):
    q, k, v = _qkv(shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jax_flash_attention(jq, jk, jv, None, block, block))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())

    want_o, want_lse = jax_flash_with_lse(jq, jk, jv, None, block, block)
    got_o, got_lse = tfa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)))
    assert got_lse.dtype == torch.float32 and tuple(got_lse.shape) == shape[:3]
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=0)


@pytest.mark.parametrize("block", [1024, 64])
def test_plain_matches_reference_bfloat16(block):
    q, k, v = _qkv((2, 4, 196, 64), seed=1)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jax_flash_attention(*jb, None, block, block)).astype(np.float32)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = tfa.flash_attention(*tb)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= bf16_ulp(want) + 1e-4 * np.abs(want).max()).all(), diff.max()
    assert (diff > 0).mean() <= 1e-2  # a sum-order flip moves a rare output
    _, want_lse = jax_flash_with_lse(*jb, None, block, block)
    _, got_lse = tfa.flash_attention_with_lse(*tb)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=0)


@pytest.mark.parametrize("scale", [None, 0.3])
def test_reference_route_matches(scale):
    q, k, v = _qkv((2, 2, 50, 16), seed=2)
    want = np.asarray(jax_attention_reference(*map(jnp.asarray, (q, k, v)), scale))
    for impl in ("xla", "auto", "flash"):
        got = tfa.attention(*map(torch.from_numpy, (q, k, v)), scale, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    direct = tfa.attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(direct.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cpu_routes_launch_nothing_and_bad_inputs_raise():
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 20, 16), seed=3))
    before = tfa.launches
    torch.testing.assert_close(tfa.attention(q, k, v, impl="flash"),
                               tfa.flash_attention_plain(q, k, v))
    assert tfa.launches == before
    with pytest.raises(ValueError, match="impl"):
        tfa.attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError):
        tfa._check(q[0], k[0], v[0])
    with pytest.raises(ValueError):
        tfa._check(q, k[:, :, :10], v)
    with pytest.raises(TypeError):
        tfa._check(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError):
        tfa._check(q.double(), k.double(), v.double())
