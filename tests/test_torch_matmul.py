"""The port's fused matmul (plain version, as the CPU runs it) against the
reference's Pallas ``fused_matmul`` in interpret mode.

Tolerances: float32 within 1e-4 (float32 sums in another order); bfloat16
within 3e-3 x max|ref| (one bf16 rounding of the output may land on the
other side), as the reference's own kernel tests hold them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgg.kernels.matmul import fused_matmul as jax_fused_matmul
from sgg_torch.kernels import matmul as tmm

torch.set_num_threads(1)


def _inputs(M, K, N, seed=0):
    r = np.random.RandomState(seed)
    a = r.randn(M, K).astype(np.float32)
    b = (r.randn(K, N) / np.sqrt(K)).astype(np.float32)
    bias = r.randn(N).astype(np.float32)
    scale = (1.0 + 0.1 * r.randn(N)).astype(np.float32)
    return a, b, bias, scale


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(64, 96, 80), (200, 256, 130), (37, 27, 64)])
def test_fused_matmul_matches_reference(M, K, N, dtype, fused):
    a, b, bias, scale = _inputs(M, K, N)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    extra = dict(bias=bias, scale=scale) if fused else {}
    want = jax_fused_matmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt), relu=fused,
                            **{k: jnp.asarray(v) for k, v in extra.items()})
    got = tmm.fused_matmul(
        torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt), relu=fused,
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    want = np.asarray(want, np.float32)
    tol = 1e-4 if dtype == "float32" else 3e-3 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    if fused:
        assert (got.float().numpy() >= 0).all()


def test_fused_matmul_out_dtype_and_cpu_wrapper():
    """bf16 operands with a float32 output skip the final bf16 rounding, as
    the reference's ``out_dtype``; on the CPU the wrapper is the plain
    version and counts no launch."""
    a, b, bias, scale = _inputs(48, 64, 40, seed=3)
    ab, bb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = jax_fused_matmul(ab, bb, bias=jnp.asarray(bias), scale=jnp.asarray(scale),
                            relu=True, out_dtype=jnp.float32)
    before = tmm.launches
    got = tmm.fused_matmul(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
                           torch.from_numpy(bias), torch.from_numpy(scale), relu=True,
                           out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tmm.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_fused_matmul_rejects_bad_operands():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        tmm.fused_matmul(a, torch.zeros(7, 3))
    with pytest.raises(TypeError):
        tmm.fused_matmul(a, torch.zeros(8, 3, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        tmm.fused_matmul(a.long(), torch.zeros(8, 3).long())
