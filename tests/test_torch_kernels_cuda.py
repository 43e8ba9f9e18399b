"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.
The file imports neither JAX nor ``sgg``, so it also runs where only the
port is installed:

  python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 soft samples within 1e-4 (float32 sums in another
order); bf16 soft samples within 2e-2 (bf16 keeps about 3 significant
digits); hard samples must pick the same token in at least 99.9 % (f32) and
99 % (bf16) of (row, step) pairs, since a near-tie can flip with the sum
order.
"""

import numpy as np
import pytest
import torch

from sgg_torch.kernels import fused_decode as tfd

V, F, H, E, A, Z, R = 40, 24, 32, 16, 16, 8, 9


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
