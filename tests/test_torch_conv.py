"""The port's convolutions (plain versions, as the CPU runs them) against the
reference: ``conv2d_direct`` against the Pallas kernel in interpret mode,
``conv2d_fused`` route by route against the reference's same route,
``fold_batchnorm``, im2col's patch order and the SAME max pool.

Tolerance: float32 within 1e-4 (float32 sums in another order), as the
reference's kernel tests hold its float32 convolutions; bfloat16 within
3e-3 x max|ref|.
"""

import flax.linen as nn
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgg.kernels.conv import _im2col as jax_im2col
from sgg.kernels.conv import conv2d_fused as jax_conv2d_fused
from sgg.kernels.conv import fold_batchnorm as jax_fold_batchnorm
from sgg.kernels.conv_direct import conv2d_direct as jax_conv2d_direct
from sgg_torch.kernels import conv_direct as tcd
from sgg_torch.kernels.conv import (
    IMPLS,
    _im2col,
    conv2d_fused,
    fold_batchnorm,
    max_pool_nhwc,
)

torch.set_num_threads(1)


def _conv_inputs(shape, cout, k, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 0.5).astype(np.float32)
    w = (r.randn(k, k, shape[-1], cout) * 0.05).astype(np.float32)
    bias = r.randn(cout).astype(np.float32)
    scale = (1.0 + 0.1 * r.randn(cout)).astype(np.float32)
    return x, w, bias, scale


@pytest.mark.parametrize(
    "shape,cout,k",
    [((3, 8, 8, 64), 128, 3), ((5, 13, 9, 40), 70, 3), ((2, 7, 7, 96), 64, 5)],
)
def test_conv2d_direct_matches_pallas_kernel(shape, cout, k):
    x, w, bias, scale = _conv_inputs(shape, cout, k)
    want = jax_conv2d_direct(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(bias),
                             scale=jnp.asarray(scale), relu=True)
    before = tcd.launches
    got = tcd.conv2d_direct(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(bias), torch.from_numpy(scale), relu=True)
    assert tcd.launches == before  # CPU tensors take the plain version
    assert tuple(got.shape) == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_conv2d_direct_bf16_and_odd_kernel_check():
    x, w, bias, scale = _conv_inputs((2, 14, 14, 32), 48, 3, seed=1)
    want = np.asarray(jax_conv2d_direct(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        bias=jnp.asarray(bias), scale=jnp.asarray(scale), relu=True), np.float32)
    got = tcd.conv2d_direct_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                                  torch.from_numpy(bias), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-3 * np.abs(want).max())
    with pytest.raises(ValueError):
        tcd.conv2d_direct(torch.from_numpy(x), torch.zeros(2, 2, 32, 8))


# (input shape, Cout, kernel, stride): 3x3 stride 1; 3x3 stride 2 on even
# and odd sizes (asymmetric SAME); the 7x7 stride-2 stem on an even size;
# 1x1 stride 1 and stride 2 on even and odd sizes.
_ROUTE_CASES = [
    ((2, 10, 10, 16), 24, 3, 1),
    ((2, 14, 14, 16), 24, 3, 2),
    ((2, 13, 13, 16), 24, 3, 2),
    ((2, 16, 16, 3), 64, 7, 2),
    ((2, 9, 9, 32), 48, 1, 1),
    ((2, 14, 14, 32), 48, 1, 2),
    ((2, 13, 11, 32), 48, 1, 2),
]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape,cout,k,stride", _ROUTE_CASES)
def test_conv2d_fused_routes_match_reference(shape, cout, k, stride, impl):
    x, w, bias, scale = _conv_inputs(shape, cout, k, seed=2)
    want = jax_conv2d_fused(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(bias),
                            scale=jnp.asarray(scale), stride=stride, impl=impl)
    got = conv2d_fused(torch.from_numpy(x), torch.from_numpy(w), bias=torch.from_numpy(bias),
                       scale=torch.from_numpy(scale), stride=stride, impl=impl)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_conv2d_fused_use_pallas_default_and_refusals():
    x, w, bias, _ = _conv_inputs((1, 6, 6, 8), 8, 3, seed=4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = np.asarray(jax_conv2d_fused(jnp.asarray(x), jnp.asarray(w), use_pallas=False))
    for use_pallas in (False, True):
        got = conv2d_fused(xt, wt, use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # 'int8' is the reference's PTQ route (tests/test_torch_quant.py holds it).
    want8 = np.asarray(jax_conv2d_fused(jnp.asarray(x), jnp.asarray(w), impl="int8"))
    np.testing.assert_array_equal(conv2d_fused(xt, wt, impl="int8").numpy(), want8)
    with pytest.raises(ValueError):
        conv2d_fused(xt, wt, impl="winograd")


@pytest.mark.parametrize("k,stride,padding", [(3, 1, "SAME"), (3, 2, "SAME"), (2, 1, "VALID")])
def test_im2col_patch_order_matches_reference(k, stride, padding):
    x = np.random.RandomState(5).randn(2, 7, 6, 3).astype(np.float32)
    want, want_dims = jax_im2col(jnp.asarray(x), k, k, stride, padding)
    got, dims = _im2col(torch.from_numpy(x), k, k, stride, padding)
    assert dims == want_dims
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_same_pads_are_tensorflow_s():
    assert tcd.same_pads(224, 7, 2) == (2, 3)
    assert tcd.same_pads(56, 3, 2) == (0, 1)
    assert tcd.same_pads(112, 3, 2) == (0, 1)
    assert tcd.same_pads(13, 3, 2) == (1, 1)
    assert tcd.same_pads(14, 3, 1) == (1, 1)


@pytest.mark.parametrize("with_conv_bias", [False, True])
def test_fold_batchnorm_matches_reference(with_conv_bias):
    r = np.random.RandomState(6)
    gamma, beta, mean = (r.randn(32).astype(np.float32) for _ in range(3))
    var = (0.1 + r.rand(32)).astype(np.float32)
    cb = r.randn(32).astype(np.float32) if with_conv_bias else None
    want = jax_fold_batchnorm(*(jnp.asarray(a) for a in (gamma, beta, mean, var)),
                              conv_bias=None if cb is None else jnp.asarray(cb))
    got = fold_batchnorm(*(torch.from_numpy(a) for a in (gamma, beta, mean, var)),
                         conv_bias=None if cb is None else torch.from_numpy(cb))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [8, 7, 112])
@pytest.mark.parametrize("window,stride,padding", [(3, 2, "SAME"), (2, 2, "VALID")])
def test_max_pool_matches_flax(size, window, stride, padding):
    x = np.random.RandomState(size).randn(2, size, size, 4).astype(np.float32)
    want = nn.max_pool(jnp.asarray(x), (window, window), strides=(stride, stride),
                       padding=padding)
    got = max_pool_nhwc(torch.from_numpy(x), window, stride, padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
