"""The port's flash-attention backward against the reference's.

``flash_attention_bwd_plain`` (what the CUDA dq and dk/dv kernels compute, and
what the wrapper runs on a CPU tensor) against ``sgg``'s Pallas
``flash_attention_bwd`` in interpret mode, with its default 512 blocks (one
block at these S) and with blocks of 64 (its multi-block accumulation), and
against ``jax.vjp`` of ``attention_reference``. Inputs are numpy-seeded; o and
lse come from the port's plain forward (held against the reference's forward
in ``test_torch_flash_attention.py``), and both backwards get the same arrays.

Tolerances: float32 gradients within 1e-4 x max|ref| (float32 sums in another
order; dq and dk sum terms of both signs). bfloat16 at D = 64 (the scale 1/8
is exact in bf16): every gradient within one bf16 ulp of the reference's plus
the float32 bound (both round a float32 sum once), and at most 1 % of them
differing at all (measured: at most 0.05 %; p or ds rounded to bf16 moves
about 41 % on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg.kernels.flash_attention import attention_reference as jax_attention_reference
from sgg.kernels.flash_attention_bwd import flash_attention_bwd

from sgg_torch.kernels import flash_attention as tfa
from sgg_torch.kernels import flash_attention_bwd as tfb

torch.set_num_threads(1)

SHAPES = [(1, 2, 64, 32), (1, 2, 100, 32), (2, 4, 196, 64)]
# The Pallas backward compiled once per shape (its interpret mode, run eagerly,
# compiles each of its operations on its own).
jax_flash_bwd = jax.jit(flash_attention_bwd, static_argnums=(6, 7, 8))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp of each value (0 where the value is 0)."""
    e = np.frexp(np.abs(x))[1]
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _inputs(shape, dtype=jnp.float32, seed=0):
    """(q, k, v, do, o, lse) as jax arrays; o and lse from the port's plain
    forward."""
    r = np.random.RandomState(seed)
    q, k, v, do = (jnp.asarray(r.randn(*shape).astype(np.float32), dtype) for _ in range(4))
    o, lse = tfa.flash_attention_plain(*_torch(q, k, v), return_lse=True)
    return q, k, v, do, jnp.asarray(o.float().numpy(), dtype), jnp.asarray(lse.numpy())


def _torch(*arrays):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.array(a, np.float32))
        out.append(t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t)
    return out


def _assert_f32_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("block", [512, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_float32(shape, block):
    q, k, v, do, o, lse = _inputs(shape)
    scale = shape[-1] ** -0.5
    want = jax_flash_bwd(q, k, v, o, lse, do, scale, block, block)
    got = tfb.flash_attention_bwd(*_torch(q, k, v, o, lse, do), scale)
    _assert_f32_close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_vjp_of_reference_attention(shape):
    q, k, v, do, o, lse = _inputs(shape, seed=1)
    _, vjp = jax.vjp(jax_attention_reference, q, k, v)
    got = tfb.flash_attention_bwd(*_torch(q, k, v, o, lse, do), None)
    _assert_f32_close(got, vjp(do))


def test_plain_matches_pallas_bfloat16():
    q, k, v, do, o, lse = _inputs((2, 4, 196, 64), jnp.bfloat16, seed=2)
    want = jax_flash_bwd(q, k, v, o, lse, do, 0.125, 512, 512)
    got = tfb.flash_attention_bwd(*_torch(q, k, v, o, lse, do), 0.125)
    for g, w in zip(got, want):
        w = np.asarray(w).astype(np.float32)
        assert g.dtype == torch.bfloat16
        diff = np.abs(g.float().numpy() - w)
        assert (diff <= bf16_ulp(w) + 1e-4 * np.abs(w).max()).all(), diff.max()
        assert (diff > 0).mean() <= 1e-2  # a sum-order flip moves a rare gradient


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_equals_plain_backward(dtype):
    r = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(r.randn(2, 3, 37, 16).astype(np.float32)).to(dtype)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = tfa.flash_attention(*leaves)
    assert isinstance(o.grad_fn, tfa.FlashAttention._backward_cls)
    got = torch.autograd.grad(o, leaves, do)
    o_plain, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    assert torch.equal(o.detach(), o_plain)
    for g, w in zip(got, tfb.flash_attention_bwd_plain(q, k, v, o_plain, lse, do)):
        assert torch.equal(g, w)


def test_no_grad_path_saves_nothing_and_double_backward_raises():
    r = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(r.randn(1, 2, 8, 16).astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).grad_fn is None
    assert tfa.flash_attention(q.detach(), k.detach(), v.detach()).grad_fn is None
    w = torch.randn(1, 2, 8, 16, requires_grad=True)
    (gq,) = torch.autograd.grad(tfa.flash_attention(q, k, v), q, w, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        gq.sum().backward()


def test_wrapper_checks_and_launch_counts():
    q, k, v, do = (torch.randn(1, 2, 10, 16) for _ in range(4))
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    before = (tfb.dq_launches, tfb.dkv_launches)
    tfb.flash_attention_bwd(q, k, v, o, lse, do)
    assert (tfb.dq_launches, tfb.dkv_launches) == before  # the CPU takes the plain version
    with pytest.raises(ValueError, match="lse"):
        tfb.flash_attention_bwd(q, k, v, o, lse[..., :5], do)
    with pytest.raises(TypeError):
        tfb.flash_attention_bwd(q, k, v.double(), o, lse, do)
    with pytest.raises(ValueError, match="cuda"):
        tfb.launch_dq(q, k, v, do, lse, tfb.dstat(o, do))
