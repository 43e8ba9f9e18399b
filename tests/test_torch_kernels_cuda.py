"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.
The file imports neither JAX nor ``sgg``, so it also runs where only the
port is installed:

  python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: fused_decode's float32 soft samples within 1e-4 (float32 sums
in another order); bf16 soft samples within 2e-2 (bf16 keeps about 3
significant digits); hard samples must pick the same token in at least
99.9 % (f32) and 99 % (bf16) of (row, step) pairs, since a near-tie can flip
with the sum order; at the resnet50 widths (V = 8192) the soft bounds are
1e-4 and 1e-2 of each (row, step)'s largest value. fused_matmul and
conv2d_direct: float32 within 1e-4 x max|plain| (float32 products on the
CUDA cores, sums in another order), bf16 within 3e-3 x max|plain| (one
bf16 rounding of the output). fused_decode's 16-row template instance at
vg1k widths in bf16: at most 0.5 % of y differ from plain at all (a
rounding the kernel skips moves 1.5-2.3 %). flash_attention: float32 within
1e-4 x max|plain|; bf16 within one bf16 ulp of plain plus that, and at most
1 % of the outputs differ at all; lse within 1e-5 relative. conv2d_direct at
shapes with an image boundary and the halo inside one tile, fused_matmul at
ragged shapes (M, K = 16 and 80, N = 8 and 72), and the tests of which
instance each wrapper launches: chip_smoke.py's phase-4 gate (float32
within 1e-4 x max|plain|, bf16 within one bf16 ulp of plain plus that). The flash
backward (dq and dk/dv kernels): the same bounds on dq, dk and dv (sound runs
differ from plain at 0.020-0.038 % of bf16 outputs; p or ds rounded to bf16
moves about 41 %). The bf16 flash kernels' float32 results before the cast
(their check-only entries) within a relative L2 distance of
``flash_attention.F32_RESULT_TOL`` of the plain versions in float32 (p or ds
split cut to hi + mid moves them by 2.0e-6 to 2.5e-6). The float32 PredCls
scorer and one REINFORCE generator gradient, card against CPU, at
``chip_smoke.py`` phase 19's tolerances (``predcls_hold``,
``reinforce_grad_hold``). conv2d_direct and fused_matmul refuse operands
that need a gradient (they have no backward). The fused stepper's CUDA-graph replays against the
eager steps, bit for bit, as ``chip_smoke.py`` phase 20 holds them
(``fused_hold``).
"""

import json
import os

import numpy as np
import pytest
import torch

from sgg_torch.data import Vocab
from sgg_torch.kernels import conv_direct as tcd
from sgg_torch.kernels import flash_attention as tfa
from sgg_torch.kernels import flash_attention_bwd as tfb
from sgg_torch.kernels import fused_decode as tfd
from sgg_torch.kernels import matmul as tmm

V, F, H, E, A, Z, R = 40, 24, 32, 16, 16, 8, 9  # the batched instance takes them in bf16


def _inputs(B, dtype, seed=0):
    r = np.random.RandomState(seed)
    shapes = {
        "wf": (F, A), "wh": (H, A), "bh": (A,), "v": (A,), "wc": (F, H),
        "bc": (H,), "wi": (F, H), "bi": (H,), "k": (F + E + Z + H, 4 * H),
        "bk": (4 * H,), "wd": (H + F, E), "bd": (E,), "wv": (E, V), "bv": (V,),
        "emb": (V, E),
    }
    params = {n: (r.randn(*s) / np.sqrt(s[0])).astype(np.float32) for n, s in shapes.items()}
    dev = torch.device("cuda")
    params = tfd.cast_params(params, dtype, dev)
    feats = torch.from_numpy(r.randn(B, R, F).astype(np.float32)).to(dev, dtype)
    z = torch.from_numpy(r.randn(B, Z).astype(np.float32)).to(dev, dtype)
    u = r.uniform(1e-20, 1.0, size=(B, 3, V)).astype(np.float32)
    g = torch.from_numpy(-np.log(-np.log(u))).to(dev)
    mask = np.zeros((3, V), bool)
    mask[0, 2:30] = mask[2, 2:30] = True
    mask[1, 30:] = True
    return params, feats, z, g, tfd.step_mask_bias(mask, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 37])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_decode_matches_plain(dtype, hard, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, feats, z, g, mb = _inputs(B, dtype)
    before = tfd.launches
    got = tfd.fused_decode(params, feats, z, g, mask_bias=mb, hard=hard)
    torch.cuda.synchronize()
    assert tfd.launches == before + 1
    want = tfd.decode_plain(params, feats, z, g, mask_bias=mb, hard=hard)
    assert got.dtype == dtype and got.shape == (B, 3, V)
    if hard:
        same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        assert same >= (0.999 if dtype == torch.float32 else 0.99)
    else:
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_fused_decode_ragged_rows_match_full_batch():
    """B = 37 gives the rows 0..36 of the B = 64 call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, feats, z, g, mb = _inputs(64, torch.float32)
    full = tfd.fused_decode(params, feats, z, g, mask_bias=mb, hard=False)
    part = tfd.fused_decode(params, feats[:37], z[:37], g[:37].contiguous(),
                            mask_bias=mb, hard=False)
    torch.cuda.synchronize()
    assert torch.equal(part, full[:37])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_decode_at_resnet50_widths(dtype):
    """F = 2048 needs 16-row feature tiles to fit a block's shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = np.random.RandomState(1)
    Bq, Rq, Fq, Aq, Hq, Eq, Zq, Vq = 4, 49, 2048, 256, 512, 256, 128, 8192
    shapes = {
        "wf": (Fq, Aq), "wh": (Hq, Aq), "bh": (Aq,), "v": (Aq,), "wc": (Fq, Hq),
        "bc": (Hq,), "wi": (Fq, Hq), "bi": (Hq,), "k": (Fq + Eq + Zq + Hq, 4 * Hq),
        "bk": (4 * Hq,), "wd": (Hq + Fq, Eq), "bd": (Eq,), "wv": (Eq, Vq), "bv": (Vq,),
        "emb": (Vq, Eq),
    }
    dev = torch.device("cuda")
    params = tfd.cast_params(
        {n: (r.randn(*s) / np.sqrt(s[0])).astype(np.float32) for n, s in shapes.items()},
        dtype, dev)
    feats = torch.from_numpy(r.randn(Bq, Rq, Fq).astype(np.float32)).to(dev, dtype)
    z = torch.from_numpy(r.randn(Bq, Zq).astype(np.float32)).to(dev, dtype)
    u = r.uniform(1e-20, 1.0, size=(Bq, 3, Vq)).astype(np.float32)
    g = torch.from_numpy(-np.log(-np.log(u))).to(dev)
    got = tfd.fused_decode(params, feats, z, g, hard=False)
    torch.cuda.synchronize()
    want = tfd.decode_plain(params, feats, z, g, hard=False).float()
    # At V = 8192 a typical y is ~1e-4: hold each (row, step) to its own
    # largest value instead of an absolute bound.
    rel = (got.float() - want).abs().amax(-1) / want.abs().amax(-1)
    assert rel.max().item() <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_fused_decode_batched_exact_tie_picks_the_first_index():
    """wv's and bv's column n2 a copy of n1 < n2 (items on different
    blocks), the Gumbel noise copied, both far above the rest: every row and
    step picks n1, as decode_plain does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, feats, z, g, _ = _inputs(64, torch.bfloat16, seed=4)
    n1, n2 = 3, 35
    p = tfd.plan(64, R, F, A, H, E, Z, V, torch.bfloat16, tmm.sm_count(0))
    blocks = {n: next(b for b, cols in p.items("logits") if n in cols) for n in (n1, n2)}
    assert p.instance == "batched" and blocks[n1] != blocks[n2]
    params["wv"][:, n2] = params["wv"][:, n1]
    params["bv"][[n1, n2]] = 100.0
    g[:, :, n2] = g[:, :, n1]
    got = tfd.fused_decode(params, feats, z, g, hard=True)
    torch.cuda.synchronize()
    want = tfd.decode_plain(params, feats, z, g, hard=True)
    assert (got.argmax(-1) == n1).all() and (want.argmax(-1) == n1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hard", [False, True])
def test_fused_decode_batched_is_deterministic_and_rows_independent(hard):
    """Two launches give the same bits; bf16 B = 37 gives rows 0-36 of the
    B = 64 call bit for bit (no atomics; every sum's order is fixed by the
    widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, feats, z, g, mb = _inputs(64, torch.bfloat16, seed=5)
    a = tfd.fused_decode(params, feats, z, g, mask_bias=mb, hard=hard)
    b = tfd.fused_decode(params, feats, z, g, mask_bias=mb, hard=hard)
    part = tfd.fused_decode(params, feats[:37].contiguous(), z[:37].contiguous(),
                            g[:37].contiguous(), mask_bias=mb, hard=hard)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(part, a[:37])


@pytest.mark.cuda
@pytest.mark.parametrize("B,dtype,row_tile,entry", [
    (64, torch.bfloat16, None, "sgg_fused_decode_batched"),
    (20, torch.bfloat16, None, "sgg_fused_decode_batched"),
    (64, torch.bfloat16, 16, "sgg_fused_decode"),
    (64, torch.float32, None, "sgg_fused_decode"),
])
def test_fused_decode_launches_the_planned_instance(B, dtype, row_tile, entry, monkeypatch):
    """The wrapper calls the C entry of the instance plan() names, once,
    with the plan's row tiles, grid, threads, ring, shared memory and
    scratch (or the generic instance's row tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sgg_torch.kernels import build

    lib, calls = build.load_library(), []

    class Recording:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args))
                return getattr(lib, name)(*args)
            return call

    monkeypatch.setattr(build, "load_library", lambda: Recording())
    params, feats, z, g, mb = _inputs(B, dtype, seed=6)
    got = tfd.fused_decode(params, feats, z, g, mask_bias=mb, hard=False, row_tile=row_tile)
    torch.cuda.synchronize()
    assert [name for name, _ in calls] == [entry]
    p = tfd.plan(B, R, F, A, H, E, Z, V, dtype, tmm.sm_count(0), row_tile)
    args = calls[0][1]
    if entry == "sgg_fused_decode_batched":
        assert args[:9] == (0, B, R, F, A, H, E, Z, V)
        assert args[-7:-1] == (p.row_tiles, p.grid, p.threads, p.stages, p.smem, p.scratch)
    else:
        assert p.instance == "generic" and args[:4] == (int(dtype == torch.bfloat16), 0,
                                                         p.row_tile, B)
    want = tfd.decode_plain(params, feats, z, g, mask_bias=mb, hard=False)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


def _check_close(got, want, dtype):
    ref = want.float().abs().max().item()
    tol = (1e-4 if dtype == torch.float32 else 3e-3) * max(ref, 1e-6)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,relu", [
    (200, 256, 130, True), (37, 27, 64, False), (1000, 64, 256, True), (130, 2048, 72, True),
])
def test_fused_matmul_matches_plain(M, K, N, relu, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    a = torch.randn(M, K, device="cuda", generator=g).to(dtype)
    b = (torch.randn(K, N, device="cuda", generator=g) / K ** 0.5).to(dtype)
    bias = torch.randn(N, device="cuda", generator=g)
    scale = 1.0 + 0.1 * torch.randn(N, device="cuda", generator=g)
    before = tmm.launches
    got = tmm.fused_matmul(a, b, bias, scale, relu=relu)
    torch.cuda.synchronize()
    assert tmm.launches == before + 1
    _check_close(got, tmm.fused_matmul_plain(a, b, bias, scale, relu=relu), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,k", [
    ((2, 14, 14, 64), 64, 3), ((1, 9, 13, 3), 64, 3), ((2, 7, 7, 40), 70, 5),
    ((2, 28, 28, 128), 128, 3),
])
def test_conv2d_direct_matches_plain(shape, cout, k, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(cout + k)
    x = torch.randn(*shape, device="cuda", generator=g).to(dtype)
    w = (0.1 * torch.randn(k, k, shape[-1], cout, device="cuda", generator=g)).to(dtype)
    bias = torch.randn(cout, device="cuda", generator=g)
    scale = 1.0 + 0.1 * torch.randn(cout, device="cuda", generator=g)
    before = tcd.launches
    got = tcd.conv2d_direct(x, w, bias, scale, relu=True)
    torch.cuda.synchronize()
    assert tcd.launches == before + 1
    _check_close(got, tcd.conv2d_direct_plain(x, w, bias, scale, relu=True), dtype)


def _check_within_ulp(got, want, dtype):
    """chip_smoke.py's phase-4 gate: float32 within 1e-4 x max|plain|; bf16
    within one bf16 ulp of plain plus that (float32 sums in another order
    can move a rounding by one ulp, which at the largest values is more
    than 3e-3 x max)."""
    w = want.float()
    tol = 1e-4 * max(w.abs().max().item(), 1e-6)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    diff = (got.float() - w).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= tol
    else:
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs())[1] - 8)
        assert bool((diff <= torch.where(w == 0, torch.zeros_like(ulp), ulp) + tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,k", [
    ((3, 7, 7, 512), 512, 3), ((2, 9, 13, 64), 72, 3), ((1, 5, 5, 32), 16, 3),
    ((2, 14, 14, 64), 64, 5),
])
def test_conv2d_direct_halo_shapes_match_plain(shape, cout, k, dtype):
    """An image boundary and the SAME halo inside one tile, ragged M and Cout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(cout + k + 1)
    x = torch.randn(*shape, device="cuda", generator=g).to(dtype)
    w = (torch.randn(k, k, shape[-1], cout, device="cuda", generator=g)
         / (k * k * shape[-1]) ** 0.5).to(dtype)
    bias = 0.1 * torch.randn(cout, device="cuda", generator=g)
    scale = 1.0 + 0.1 * torch.randn(cout, device="cuda", generator=g)
    before = tcd.launches
    got = tcd.conv2d_direct(x, w, bias, scale, relu=True)
    torch.cuda.synchronize()
    assert tcd.launches == before + 1
    _check_within_ulp(got, tcd.conv2d_direct_plain(x, w, bias, scale, relu=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,dtype,entry", [
    ((2, 14, 14, 64), 64, torch.bfloat16, "sgg_conv_direct_tiled"),
    ((2, 7, 7, 512), 512, torch.bfloat16, "sgg_conv_direct_tiled"),
    ((1, 9, 13, 3), 64, torch.bfloat16, "sgg_conv_direct"),
    ((2, 14, 14, 64), 64, torch.float32, "sgg_conv_direct"),
])
def test_conv2d_direct_launches_the_planned_instance(shape, cout, dtype, entry, monkeypatch):
    """The wrapper calls the C entry of the instance plan() names, once,
    with the plan's tile, ring, threads, shared memory and grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sgg_torch.kernels import build

    lib, calls = build.load_library(), []

    class Recording:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args))
                return getattr(lib, name)(*args)
            return call

    monkeypatch.setattr(build, "load_library", lambda: Recording())
    x = torch.randn(*shape, device="cuda").to(dtype)
    w = (torch.randn(3, 3, shape[-1], cout, device="cuda") / (9 * shape[-1]) ** 0.5).to(dtype)
    got = tcd.conv2d_direct(x, w, relu=True)
    torch.cuda.synchronize()
    assert [name for name, _ in calls] == [entry]
    p = tcd.plan(*shape, cout, 3, 3, dtype, True, True, tcd.sm_count(x.device.index))
    assert p.instance == ("tiled" if entry == "sgg_conv_direct_tiled" else "generic")
    if p.instance == "tiled":
        assert calls[0][1][13:21] == (p.bm, p.bn, p.bk, p.stages, p.threads, p.smem, *p.grid)
    _check_within_ulp(got, tcd.conv2d_direct_plain(x, w, relu=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,relu", [
    (1568, 2048, 512, True), (1000, 16, 72, True), (300, 80, 8, False), (777, 80, 72, True),
    (129, 48, 264, False), (65, 2064, 136, True),
])
def test_fused_matmul_ragged_shapes_match_plain(M, K, N, relu, dtype):
    """The tiled instance (bf16) at ragged M, K = 16 and 80, N = 8 and 72,
    under chip_smoke.py's phase-4 gate; float32 takes the generic one. a
    lies inside a buffer with seeded rows before and after it, so a row past
    M that the kernel read would be data, not zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(M + K + N + 2)
    a_all = torch.randn(M + 256, K, device="cuda", generator=g).to(dtype)
    a = a_all[128:128 + M]
    b = (torch.randn(K, N, device="cuda", generator=g) / K ** 0.5).to(dtype)
    bias = 0.1 * torch.randn(N, device="cuda", generator=g)
    scale = 1.0 + 0.1 * torch.randn(N, device="cuda", generator=g)
    p = tmm.plan(M, K, N, dtype, dtype, tmm.aligned(a), tmm.aligned(b),
                 tmm.sm_count(a.device.index))
    assert p.instance == ("tiled" if dtype == torch.bfloat16 else "generic")
    before = tmm.launches
    got = tmm.fused_matmul(a, b, bias, scale, relu=relu)
    torch.cuda.synchronize()
    assert tmm.launches == before + 1
    _check_within_ulp(got, tmm.fused_matmul_plain(a, b, bias, scale, relu=relu), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,dtype,out_dtype,entry", [
    (6272, 256, 1024, torch.bfloat16, torch.bfloat16, "sgg_fused_matmul_tiled"),
    (1568, 2048, 512, torch.bfloat16, torch.bfloat16, "sgg_fused_matmul_tiled"),
    (300, 80, 72, torch.bfloat16, torch.bfloat16, "sgg_fused_matmul_tiled"),
    (300, 27, 64, torch.bfloat16, torch.bfloat16, "sgg_fused_matmul"),
    (300, 64, 64, torch.bfloat16, torch.float32, "sgg_fused_matmul"),
    (300, 64, 64, torch.float32, torch.float32, "sgg_fused_matmul"),
])
def test_fused_matmul_launches_the_planned_instance(M, K, N, dtype, out_dtype, entry,
                                                     monkeypatch):
    """The wrapper calls the C entry of the instance plan() names, once,
    with the plan's tile, ring, threads, shared memory and grid (or the
    generic instance's load flags)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sgg_torch.kernels import build

    lib, calls = build.load_library(), []

    class Recording:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args))
                return getattr(lib, name)(*args)
            return call

    monkeypatch.setattr(build, "load_library", lambda: Recording())
    a = torch.randn(M, K, device="cuda").to(dtype)
    b = (torch.randn(K, N, device="cuda") / K ** 0.5).to(dtype)
    got = tmm.fused_matmul(a, b, relu=True, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert [name for name, _ in calls] == [entry]
    p = tmm.plan(M, K, N, dtype, out_dtype, True, True, tmm.sm_count(a.device.index))
    assert p.instance == ("tiled" if entry == "sgg_fused_matmul_tiled" else "generic")
    if p.instance == "tiled":
        assert calls[0][1][:4] == (1, M, N, K)
        assert calls[0][1][9:17] == (p.bm, p.bn, p.bk, p.stages, p.threads, p.smem, *p.grid)
    else:
        assert calls[0][1][11:13] == (int(p.a_vec), int(p.b_vec))
    _check_within_ulp(got, tmm.fused_matmul_plain(a, b, relu=True, out_dtype=out_dtype),
                      dtype if out_dtype == dtype else torch.float32)


TRAINED_RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "results", "run_v3_bal0.7_ckpt")


@pytest.mark.cuda
def test_fused_decode_16_row_instance_at_vg1k_widths():
    """The 16-row template instance (the one resnet50 widths run) at vg1k
    widths, where the share of y that differs tells a skipped rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sgg_torch.config import Config
    from sgg_torch.models.generator import AttentionLSTMGenerator

    with open(os.path.join(TRAINED_RUN, "config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    vocab = Vocab.load(os.path.join(TRAINED_RUN, "vocab.json"))
    cfg.model.vocab_size = len(vocab)
    torch.manual_seed(0)
    sd = AttentionLSTMGenerator.from_config(cfg).state_dict()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, R, F, Zq, Vq = 64, cfg.data.regions, cfg.data.feat_dim, cfg.model.noise_dim, len(vocab)
    params = tfd.decode_params_from_generator(sd, torch.bfloat16, dev)
    mb = tfd.step_mask_bias(vocab.step_mask(), dev)
    feats = torch.randn(B, R, F, generator=g, device=dev).to(torch.bfloat16)
    z = torch.randn(B, Zq, generator=g, device=dev).to(torch.bfloat16)
    gum = -torch.log(-torch.log(torch.rand(B, 3, Vq, generator=g, device=dev).clamp_min(1e-20)))
    got = tfd.fused_decode(params, feats, z, gum, mask_bias=mb, hard=False, row_tile=16)
    torch.cuda.synchronize()
    want = tfd.decode_plain(params, feats, z, gum, mask_bias=mb, hard=False).float()
    diff = (got.float() - want).abs()
    assert (diff.amax(-1) / want.abs().amax(-1)).max().item() <= 1e-2
    assert (diff > 0).float().mean().item() <= 5e-3
    with pytest.raises(ValueError, match="row_tile"):
        tfd.fused_decode(params, feats, z, gum, mask_bias=mb, row_tile=8)


def _ulp(want):
    w = want.float()
    u = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs())[1] - 8)
    return torch.where(w == 0, torch.zeros_like(u), u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 12, 196, 64), (3, 2, 100, 64)])
def test_flash_attention_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(shape[2])
    q, k, v = (torch.randn(*shape, device="cuda", generator=g).to(dtype) for _ in range(3))
    before = tfa.launches
    o, lse = tfa.flash_attention_with_lse(q, k, v)
    o2 = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.launches == before + 2
    want, want_lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    assert o.dtype == dtype and o.shape == q.shape and torch.equal(o, o2)
    diff = (o.float() - want.float()).abs()
    tol = 1e-4 * want.float().abs().max().item()
    if dtype == torch.float32:
        assert diff.max().item() <= tol
    else:
        assert bool((diff <= _ulp(want) + tol).all())
        assert (diff > 0).float().mean().item() <= 1e-2
    assert ((lse - want_lse).abs() / want_lse.abs()).max().item() <= 1e-5


@pytest.mark.cuda
def test_conv_kernels_refuse_operands_that_need_a_gradient():
    """conv2d_direct and fused_matmul write their outputs outside autograd:
    under grad mode an operand that needs a gradient raises (nothing is
    launched), and under torch.no_grad the same call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(2, 8, 8, 16, device="cuda")
    w = torch.randn(3, 3, 16, 16, device="cuda", requires_grad=True)
    a = torch.randn(64, 16, device="cuda")
    b = torch.randn(16, 16, device="cuda", requires_grad=True)
    bias = torch.zeros(16, device="cuda", requires_grad=True)
    before = (tcd.launches, tmm.launches)
    for call in (lambda: tcd.conv2d_direct(x, w), lambda: tcd.conv2d_direct(x, w.detach(),
                                                                              bias=bias),
                 lambda: tcd.conv2d_direct(x.requires_grad_(), w.detach())):
        with pytest.raises(NotImplementedError, match="forward only"):
            call()
        x = x.detach()
    for call in (lambda: tmm.fused_matmul(a, b), lambda: tmm.fused_matmul(a, b.detach(),
                                                                           scale=bias)):
        with pytest.raises(NotImplementedError, match="forward only"):
            call()
    assert (tcd.launches, tmm.launches) == before
    with torch.no_grad():
        tcd.conv2d_direct(x, w, bias=bias)
        tmm.fused_matmul(a, b, bias=bias)
    assert (tcd.launches, tmm.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_cannot_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.randn(1, 2, 10, 64, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        tfa.flash_attention_with_lse(q, q.detach(), q.detach())
    for D in (24, 144):
        x = torch.randn(1, 2, 10, D, device="cuda")
        with pytest.raises(ValueError, match="multiple of 16"):
            tfa.flash_attention(x, x, x)
    x = torch.randn(1, 2, 10, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(x.transpose(2, 3).contiguous().transpose(2, 3), x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 12, 196, 64), (3, 2, 100, 64), (2, 3, 70, 128)])
def test_flash_attention_bwd_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(shape[2] + 1)
    q, k, v, do = (torch.randn(*shape, device="cuda", generator=g).to(dtype) for _ in range(4))
    o, lse = tfa.flash_attention_with_lse(q, k, v)
    before = (tfb.dq_launches, tfb.dkv_launches)
    got = tfb.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (tfb.dq_launches, tfb.dkv_launches) == (before[0] + 1, before[1] + 1)
    for a, w in zip(got, tfb.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        assert a.dtype == dtype and a.shape == q.shape
        diff = (a.float() - w.float()).abs()
        tol = 1e-4 * w.float().abs().max().item()
        if dtype == torch.float32:
            assert diff.max().item() <= tol
        else:
            assert bool((diff <= _ulp(w) + tol).all())
            assert (diff > 0).float().mean().item() <= 1e-2


@pytest.mark.cuda
def test_flash_attention_autograd_runs_the_backward_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(4, 3, 150, 64, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (tfa.launches, tfb.dq_launches, tfb.dkv_launches)
    got = torch.autograd.grad(tfa.flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert (tfa.launches, tfb.dq_launches, tfb.dkv_launches) == tuple(b + 1 for b in before)
    o, lse = tfa.flash_attention_with_lse(q, k, v)
    for a, w in zip(got, tfb.flash_attention_bwd(q, k, v, o, lse, do)):
        assert torch.equal(a, w)
    with torch.no_grad():
        assert tfa.flash_attention(*leaves).grad_fn is None


@pytest.mark.cuda
def test_flash_attention_bwd_refuses_what_it_cannot_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for D in (24, 144):
        x = torch.randn(1, 2, 10, D, device="cuda")
        lse = torch.zeros(1, 2, 10, device="cuda")
        with pytest.raises(ValueError, match="multiple of 16"):
            tfb.flash_attention_bwd(x, x, x, x, lse, x)
    x = torch.randn(1, 2, 10, 64, device="cuda")
    lse = torch.zeros(1, 2, 10, device="cuda")
    strided = x.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.flash_attention_bwd(strided, x, x, x, lse, x)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.flash_attention_bwd(x, x, x, x, lse, strided)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 12, 196, 64), (32, 12, 100, 64)])
def test_flash_attention_f32_result_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(shape[2] + 2)
    q, k, v = (torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    before = tfa.launches
    o32 = tfa.launch_f32_result(q, k, v)
    torch.cuda.synchronize()
    assert tfa.launches == before  # check-only: not a launch of the main path
    want = tfa.flash_attention_plain(q, k, v, cast=False)
    assert o32.dtype == torch.float32 and o32.shape == q.shape
    assert tfa.f32_result_error(o32, want) <= tfa.F32_RESULT_TOL
    assert torch.equal(o32.to(torch.bfloat16), tfa.flash_attention(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 12, 196, 64), (32, 12, 100, 64)])
def test_flash_attention_bwd_f32_result_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(shape[2] + 3)
    q, k, v, do = (torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = tfa.flash_attention_with_lse(q, k, v)
    D = tfb.dstat(o, do).contiguous()
    before = (tfb.dq_launches, tfb.dkv_launches)
    got = (tfb.launch_dq_f32_result(q, k, v, do, lse, D),
           *tfb.launch_dkv_f32_result(q, k, v, do, lse, D))
    torch.cuda.synchronize()
    assert (tfb.dq_launches, tfb.dkv_launches) == before
    want = (tfb.dq_plain(q, k, v, do, lse, D, cast=False),
            *tfb.dkv_plain(q, k, v, do, lse, D, cast=False))
    cast = (tfb.launch_dq(q, k, v, do, lse, D), *tfb.launch_dkv(q, k, v, do, lse, D))
    for a, w, c in zip(got, want, cast):
        assert a.dtype == torch.float32 and a.shape == q.shape
        assert tfa.f32_result_error(a, w) <= tfa.F32_RESULT_TOL
        assert torch.equal(a.to(torch.bfloat16), c)


def _trained_cfg_vocab():
    from sgg_torch.config import Config

    with open(os.path.join(TRAINED_RUN, "config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    vocab = Vocab.load(os.path.join(TRAINED_RUN, "vocab.json"))
    cfg.model.vocab_size = len(vocab)
    return cfg, vocab


@pytest.mark.cuda
def test_predcls_scorer_card_matches_cpu():
    """chip_smoke.py phase 19 (a)'s hold at vg1k widths: the float32 PredCls
    scorer on the card against the CPU's, seeded weights, features and z,
    within 1e-4 x max|score| over the legal predicates, the same GT rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import predcls_hold
    from sgg_torch.models.generator import AttentionLSTMGenerator

    cfg, vocab = _trained_cfg_vocab()
    torch.manual_seed(0)
    sd = AttentionLSTMGenerator.from_config(cfg).state_dict()
    r = np.random.RandomState(0)
    objs, preds = np.flatnonzero(vocab.is_object), np.flatnonzero(vocab.is_predicate)
    rows = np.stack([np.arange(16), r.choice(objs, 16), r.choice(preds, 16),
                     r.choice(objs, 16)], axis=1)
    feats = torch.from_numpy(r.randn(16, cfg.data.regions, cfg.data.feat_dim).astype(np.float16))
    err, scale, masked, same_rank = predcls_hold(torch.device("cuda"), cfg, sd, vocab, feats,
                                                 rows, 16, 1)
    assert err <= 1e-4 * scale and masked and same_rank


@pytest.mark.cuda
def test_reinforce_update_card_matches_cpu():
    """chip_smoke.py phase 19 (b)'s hold at vg1k widths: one REINFORCE
    generator update's surrogate gradient in float32 on the card against the
    CPU's (same tokens; each tensor within 1e-4 x its max|CPU| plus 1e-6 x
    the largest gradient)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import reinforce_grad_hold

    cfg, vocab = _trained_cfg_vocab()
    feats = torch.from_numpy(np.random.RandomState(1).randn(
        32, cfg.data.regions, cfg.data.feat_dim).astype(np.float32))
    same_tok, worst, largest = reinforce_grad_hold(torch.device("cuda"), cfg, vocab, feats, 2,
                                                   0.01)
    assert same_tok and worst <= 1.0 and largest > 0


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["smoke", "pipeline_v4"])
def test_fused_graph_matches_eager_steps(widths):
    """chip_smoke.py phase 20 (c)'s hold: 4 train steps eagerly against 2
    dispatches of 2 through the fused stepper (warm-up, CUDA-graph capture,
    replays) from the same seeded state, draws and noise: every parameter,
    the EMA, the optimizers' counts and moments and the last step's metrics
    bit for bit; at smoke widths on the synthetic store, and at
    pipeline_v4's on a seeded int8 corpus of 512 images with predicate
    balance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import fused_hold, v4_corpus
    from sgg_torch.config import get_config
    from sgg_torch.data import TripleDataset, synthetic_dataset

    dev = torch.device("cuda")
    if widths == "smoke":
        cfg = get_config("smoke").override(["train.ema_decay=0.9", "train.tau_anneal=0.05",
                                            "train.lr_schedule=cosine"])
        data = synthetic_dataset(num_images=64, regions=cfg.data.regions,
                                 feat_dim=cfg.data.feat_dim, seed=0)
        vocab = data["vocab"]
        ds = TripleDataset(data["features"], data["triples"])
    else:
        cfg = get_config("pipeline_v4")
        vocab = Vocab.load(os.path.join(TRAINED_RUN, "vocab.json"))
        feats, triples = v4_corpus(vocab, 512, 0, dev)
        ds = TripleDataset(feats, triples)
    ds.set_predicate_balance(0.7)
    cfg.model.vocab_size = len(vocab)
    h = fused_hold(dev, cfg, ds, vocab, 4, 2, int8=widths != "smoke")
    assert h["graph"] and h["equal"] and h["metrics_equal"], (h["differ"], h["metrics_differ"])
