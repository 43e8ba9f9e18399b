"""The exact three-way bf16 split that puts p and ds on the tensor cores.

The bf16 flash kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
write each float32 p or ds as hi + mid + lo, three bf16 values (``split3`` in
``csrc/flash_tile.cuh``, mirrored in plain PyTorch by
``flash_attention.split3``), and run P·V, ds·k, dsᵀ·q_s and pᵀ·do as three
bf16 products. These tests hold the plain split to what that design needs:
  - hi + mid + lo == x bit for bit, for p in (0, 1], signed ds over many
    decades, ±0 and magnitudes down to 2^-100; below about 2^-110 lo falls
    among bf16's subnormals and the split misses x by at most 2^-134;
  - each bf16 × bf16 product is exact, so hi·v + mid·v + lo·v == p·v in
    float64, term by term and summed in the same order;
  - a split cut to hi + mid (about 17 bits of p) moves the float32 result by
    more than the card's float32-result gate allows (a relative L2 distance
    of ``flash_attention.F32_RESULT_TOL``), so that gate can tell the cut
    from the sound kernel;
  - that distance is steady over seeds where the largest difference over the
    largest output is not, which is why the gate reads it;
  - the plain versions' ``cast=False`` results are what they cast.
"""

import numpy as np
import pytest
import torch

from sgg_torch.kernels import flash_attention as tfa
from sgg_torch.kernels import flash_attention_bwd as tfb

torch.set_num_threads(1)


def _values(n=1_000_000, seed=0):
    """n seeded float32 values: p in (0, 1], signed ds over 12 decades, ±0,
    and signed magnitudes spread over the binades from 2^-100 to 2^10."""
    r = np.random.RandomState(seed)
    k = n // 4
    p = np.exp(-r.exponential(4.0, k)).astype(np.float32)  # (0, 1], 1 included
    ds = (np.sign(r.randn(k)) * 10.0 ** r.uniform(-9, 3, k)).astype(np.float32)
    wide = (np.sign(r.randn(k)) * np.exp2(r.uniform(-100, 10, k))).astype(np.float32)
    rest = r.randn(n - 3 * k - 2).astype(np.float32)
    x = np.concatenate([p, ds, wide, rest, np.array([0.0, -0.0], np.float32)])
    return torch.from_numpy(x)


def _cut(x, n):
    """x's split cut to its first n terms, as float32."""
    return sum(t.float() for t in tfa.split3(x)[:n])


def test_split3_is_exact():
    x = _values()
    assert x.numel() == 1_000_000 and (x.abs() >= 2.0 ** -100).sum() == x.numel() - 2
    hi, mid, lo = tfa.split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # In the kernels' float32 too, and each term at most half an ulp of the last.
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    assert bool((mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all())
    assert bool((lo.float().abs() <= mid.float().abs() * 2.0 ** -8).all())
    # ±0 split into zeros of the same sign.
    assert torch.equal(torch.signbit(hi[-2:]), torch.tensor([False, True]))
    assert not bool((mid[-2:].float() != 0).any() or (lo[-2:].float() != 0).any())


def test_split3_below_2_pow_minus_100():
    """Exact down to 2^-110; below, lo falls among bf16's subnormals (spacing
    2^-133) and the split misses x by at most half of that."""
    r = np.random.RandomState(1)
    e = r.randint(-149, -99, 200_000)
    x = torch.from_numpy((r.uniform(1, 2, e.size) * np.exp2(e.astype(np.float64))
                          * np.sign(r.randn(e.size))).astype(np.float32))
    x = x[x != 0]
    hi, mid, lo = tfa.split3(x)
    err = (hi.double() + mid.double() + lo.double() - x.double()).abs()
    assert err.max().item() <= 2.0 ** -134
    assert err[x.abs() >= 2.0 ** -110].max().item() == 0.0
    assert err.max().item() > 0  # the bound is reached, not vacuous


def test_split_products_are_exact():
    """hi·v + mid·v + lo·v in float64 equals p·v in float64, term by term and
    summed in the same order: each bf16 × bf16 product is exact in float32."""
    r = np.random.RandomState(2)
    s = torch.from_numpy(r.randn(64, 196).astype(np.float32))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    v = torch.from_numpy(r.randn(196, 64).astype(np.float32)).bfloat16()
    hi, mid, lo = tfa.split3(p)
    v64 = v.double()
    for t in (hi, mid, lo):  # bf16 x bf16 in float32 == in float64
        assert torch.equal((t.float()[:, :, None] * v.float()[None]).double(),
                           t.double()[:, :, None] * v64[None])
    terms = (hi.double()[:, :, None] * v64[None] + mid.double()[:, :, None] * v64[None]
             + lo.double()[:, :, None] * v64[None])
    exact = p.double()[:, :, None] * v64[None]
    assert torch.equal(terms, exact)
    assert torch.equal(terms.sum(dim=1), exact.sum(dim=1))


def _inputs(shape, seed):
    r = np.random.RandomState(seed)
    return [torch.from_numpy(r.randn(*shape).astype(np.float32)).bfloat16() for _ in range(4)]


@pytest.mark.parametrize("shape", [(2, 12, 196, 64), (2, 12, 100, 64)])
def test_two_term_split_misses_the_forward_gate(shape):
    q, k, v, _ = _inputs(shape, 3)
    qs = (q * torch.tensor(shape[-1] ** -0.5, dtype=torch.bfloat16)).float()
    s = qs @ k.float().transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = tfa.flash_attention_plain(q, k, v, cast=False)
    l = p.sum(-1, keepdim=True)
    errs = [tfa.f32_result_error((_cut(p, n) @ v.float()) / l, want) for n in (3, 2, 1)]
    assert errs[0] == 0.0  # the whole split is p itself
    assert errs[1] > 1.5 * tfa.F32_RESULT_TOL  # hi + mid: another function, with a margin
    assert errs[2] > 100 * tfa.F32_RESULT_TOL  # hi only: p rounded to bf16


@pytest.mark.parametrize("shape", [(2, 12, 196, 64), (2, 12, 100, 64)])
def test_two_term_split_misses_the_backward_gate(shape):
    q, k, v, do = _inputs(shape, 4)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    D = tfb.dstat(o, do)
    scale = shape[-1] ** -0.5
    qs = (q * torch.tensor(scale, dtype=torch.bfloat16)).float()
    p = torch.exp(qs @ k.float().transpose(-1, -2) - lse[..., None])
    ds = p * (do.float() @ v.float().transpose(-1, -2) - D[..., None])
    want = (tfb.dq_plain(q, k, v, do, lse, D, cast=False),
            *tfb.dkv_plain(q, k, v, do, lse, D, cast=False))
    for n, check in ((3, lambda e: e == 0.0),
                     (2, lambda e: e > 1.5 * tfa.F32_RESULT_TOL),
                     (1, lambda e: e > 100 * tfa.F32_RESULT_TOL)):
        pc, dc = _cut(p, n), _cut(ds, n)
        got = ((dc @ k.float()) * scale, dc.transpose(-1, -2) @ qs,
               pc.transpose(-1, -2) @ do.float())
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert check(tfa.f32_result_error(g, w)), (n, name, tfa.f32_result_error(g, w))


def test_cut_split_distance_is_steady_in_l2_not_in_max():
    """Why the card's gate reads a relative L2 distance: over seeds, the hi +
    mid cut moves o by a steady relative L2 amount, while its largest
    difference over the largest |o| (a ratio of two extremes) wanders."""
    l2, mx = [], []
    for seed in (3, 4, 5):
        q, k, v, _ = _inputs((2, 12, 100, 64), seed)
        qs = (q * torch.tensor(0.125, dtype=torch.bfloat16)).float()
        s = qs @ k.float().transpose(-1, -2)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        want = tfa.flash_attention_plain(q, k, v, cast=False)
        got = (_cut(p, 2) @ v.float()) / p.sum(-1, keepdim=True)
        l2.append(tfa.f32_result_error(got, want))
        mx.append(((got - want).abs().max() / want.abs().max()).item())
    assert max(l2) / min(l2) < 1.1 and min(l2) > 1.5 * tfa.F32_RESULT_TOL
    assert max(mx) / min(mx) > 1.25


def test_plain_results_before_the_cast():
    q, k, v, do = _inputs((2, 3, 70, 64), 5)
    o32, lse32 = tfa.flash_attention_plain(q, k, v, return_lse=True, cast=False)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    assert o32.dtype == torch.float32 and torch.equal(o32.to(torch.bfloat16), o)
    assert torch.equal(lse32, lse)
    D = tfb.dstat(o, do)
    dq32 = tfb.dq_plain(q, k, v, do, lse, D, cast=False)
    dk32, dv32 = tfb.dkv_plain(q, k, v, do, lse, D, cast=False)
    dq, (dk, dv) = tfb.dq_plain(q, k, v, do, lse, D), tfb.dkv_plain(q, k, v, do, lse, D)
    for a, b in ((dq32, dq), (dk32, dk), (dv32, dv)):
        assert a.dtype == torch.float32 and torch.equal(a.to(torch.bfloat16), b)


def test_f32_result_entries_refuse_what_they_cannot_run():
    q, k, v, do = (t.float() for t in _inputs((1, 2, 10, 16), 6))
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        tfa.launch_f32_result(q.bfloat16(), k.bfloat16(), v.bfloat16())  # a CPU tensor
    lse = torch.zeros(1, 2, 10)
    with pytest.raises(ValueError, match="bfloat16"):
        tfb.launch_dq_f32_result(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match="bfloat16"):
        tfb.launch_dkv_f32_result(q, k, v, do, lse, lse)
