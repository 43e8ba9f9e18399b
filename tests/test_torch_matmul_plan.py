"""The launch plan of ``fused_matmul`` (``sgg_torch.kernels.matmul.plan``),
checked on the CPU before any card runs it: which instance each shape gets,
the tiles of the ResNet-50 1x1 convs, shared memory within the card's limit,
blocks that follow the card's SM count, a grid that covers every output
exactly once, and only instances that ``csrc/fused_matmul.cu`` compiles.
"""

import re

import numpy as np
import pytest
import torch

from sgg_torch.kernels import matmul as tmm

torch.set_num_threads(1)

# ResNet-50's 1x1 convs at B = 32, 224 px, as (M, K, N): chip_smoke.py's
# RESNET_1X1, stage by stage.
RESNET_1X1 = [
    (100352, 64, 64), (100352, 256, 64), (100352, 64, 256), (100352, 256, 128),
    (25088, 512, 128), (25088, 128, 512), (25088, 256, 512), (25088, 512, 256),
    (6272, 1024, 256), (6272, 256, 1024), (6272, 512, 1024), (6272, 1024, 512),
    (1568, 2048, 512), (1568, 512, 2048), (1568, 1024, 2048),
]
RESNET_SHAPES = RESNET_1X1 + [(M // 4, K, N) for M, K, N in RESNET_1X1]  # B = 32 and 8
# VGG-19's im2col convs at 224 px after conv1_1 (K = 9 * Cin), as (H = W,
# K, N), at B = 8 and 32.
VGG_IM2COL = [(224, 576, 64), (112, 576, 128), (112, 1152, 128), (56, 1152, 256),
              (56, 2304, 256), (28, 2304, 512), (28, 4608, 512), (14, 4608, 512)]
VGG_SHAPES = [(B * hw * hw, K, N) for B in (8, 32) for hw, K, N in VGG_IM2COL]
# Ragged M, K = 16 and 80, N = 8 and 72.
RAGGED = [(1000, 16, 72), (300, 80, 8), (777, 80, 72), (1568, 16, 8), (1, 16, 8),
          (129, 48, 264), (65, 2064, 136)]
SOURCE = tmm.build.CSRC / "fused_matmul.cu"
SMEM_PER_BLOCK = 232_448  # the most one block may take (227 KB)
BF16 = torch.bfloat16


def _plan(M, K, N, dtype=BF16, out_dtype=BF16, a_aligned=True, b_aligned=True,
          sms=tmm.SMS):
    return tmm.plan(M, K, N, dtype, out_dtype, a_aligned, b_aligned, sms)


def _blocks(p):
    return p.grid[0] * p.grid[1]


@pytest.mark.parametrize("M,K,N", RESNET_SHAPES + VGG_SHAPES)
def test_resnet50_1x1_and_vgg19_im2col_shapes_run_tiled(M, K, N):
    p = _plan(M, K, N)
    assert p.instance == "tiled"
    assert p.smem <= SMEM_PER_BLOCK and p.smem == tmm.tiled_smem(p.bm, p.bn, p.bk, p.stages)
    assert p.stages == tmm.STAGES and (p.bk == 32 or K % p.bk == 0)
    assert p.bn <= -(-N // 64) * 64  # no tile wider than N needs
    tile = next(t for t in tmm.TILES
                if (t[0], t[1], t[2], 32 * (t[0] // t[3]) * (t[1] // t[4]))
                == (p.bm, p.bn, p.bk, p.threads))
    assert tmm.tile_fits(tile, K, N)


@pytest.mark.parametrize("M,K,N,dtype,out_dtype,a_aligned,b_aligned", [
    (100352, 64, 256, torch.float32, torch.float32, True, True),  # float32
    (1568, 2048, 512, torch.float32, torch.float32, True, True),
    (401408, 27, 64, BF16, BF16, True, True),                     # VGG-19 conv1_1, K = 27
    (1000, 40, 64, BF16, BF16, True, True),                       # K % 16 != 0
    (1000, 64, 70, BF16, BF16, True, True),                       # N % 8 != 0
    (1000, 64, 4, BF16, BF16, True, True),
    (25088, 128, 512, BF16, BF16, False, True),                   # a not 16-byte aligned
    (25088, 128, 512, BF16, BF16, True, False),                   # b not 16-byte aligned
    (6272, 256, 1024, BF16, torch.float32, True, True),           # bf16 -> float32
])
def test_everything_else_runs_generic(M, K, N, dtype, out_dtype, a_aligned, b_aligned):
    p = _plan(M, K, N, dtype, out_dtype, a_aligned, b_aligned)
    assert p.instance == "generic"
    assert (p.bm, p.bn, p.bk) == tmm.GENERIC_TILE and p.smem == 0
    assert p.threads == tmm.GENERIC_THREADS
    assert p.a_vec == (K % 16 == 0 and a_aligned)
    assert p.b_vec == (N % 8 == 0 and b_aligned)


def _fitting_blocks(M, K, N):
    """(tile, blocks) of every tile the plan may take for the shape, in the
    plan's order."""
    return [(t, -(-M // t[0]) * -(-N // t[1])) for t in tmm.TILES if tmm.tile_fits(t, K, N)]


def _is(p, tile):
    bm, bn, bk, wm, wn = tile
    return (p.bm, p.bn, p.bk, p.threads) == (bm, bn, bk, 32 * (bm // wm) * (bn // wn))


# (M, K, N) -> (tile, blocks) on a 132-SM H100, as timing chose them.
RESNET_TILES = {
    (100352, 64, 64): ((128, 64, 64, 64, 32), 784),
    (100352, 256, 64): ((128, 64, 64, 64, 32), 784),
    (100352, 64, 256): ((128, 128, 32, 64, 32), 1568),
    (100352, 256, 128): ((128, 128, 32, 64, 32), 784),
    (25088, 512, 128): ((128, 128, 32, 64, 32), 196),
    (25088, 128, 512): ((128, 128, 32, 64, 32), 784),
    (25088, 256, 512): ((128, 128, 32, 64, 32), 784),
    (25088, 512, 256): ((128, 128, 32, 64, 32), 392),
    (6272, 1024, 256): ((128, 64, 64, 64, 32), 196),
    (6272, 256, 1024): ((128, 128, 32, 64, 32), 392),
    (6272, 512, 1024): ((128, 128, 32, 64, 32), 392),
    (6272, 1024, 512): ((128, 128, 32, 64, 64), 196),
    (1568, 2048, 512): ((128, 64, 64, 64, 32), 104),
    (1568, 512, 2048): ((128, 128, 32, 64, 32), 208),
    (1568, 1024, 2048): ((128, 128, 32, 64, 64), 208),
}


@pytest.mark.parametrize("M,K,N", RESNET_1X1)
def test_resnet50_tiles_fill_the_sms(M, K, N):
    """A block for every SM wherever a tile the plan may take gives one; at
    [1568, 2048] @ [2048, 512] none does (at most 104 blocks), and the plan
    takes the tile with the most."""
    p = _plan(M, K, N)
    tile, blocks = RESNET_TILES[(M, K, N)]
    assert _is(p, tile) and _blocks(p) == blocks
    most = max(n for _, n in _fitting_blocks(M, K, N))
    assert _blocks(p) >= min(tmm.SMS, most)
    assert _blocks(p) >= tmm.SMS or _blocks(p) == most


@pytest.mark.parametrize("sms", [78, 114, tmm.SMS])
def test_tiles_follow_the_cards_sm_count(sms):
    for M, K, N in RESNET_1X1:
        p = _plan(M, K, N, sms=sms)
        fitting = _fitting_blocks(M, K, N)
        most = max(n for _, n in fitting)
        assert _blocks(p) >= sms or _blocks(p) == most, (M, K, N)
        # No tile the plan prefers would also have given every SM a block.
        for tile, n in fitting:
            if _is(p, tile):
                break
            assert n < sms, (M, K, N, tile)


def test_fewer_sms_take_larger_tiles():
    """[6272, 1024] @ [1024, 256]: 98 blocks of 128 x 128 fill a 78-SM card,
    not a 132-SM one, which takes 196 blocks of 128 x 64."""
    big = _plan(6272, 1024, 256, sms=78)
    small = _plan(6272, 1024, 256, sms=tmm.SMS)
    assert (big.bm, big.bn, _blocks(big)) == (128, 128, 98)
    assert (small.bm, small.bn, _blocks(small)) == (128, 64, 196)


@pytest.mark.parametrize("K,N,fits", [
    (64, 64, [(128, 64, 64, 64, 32), (128, 64, 32, 64, 32)]),
    (80, 72, [(128, 128, 32, 64, 32), (128, 64, 32, 64, 32)]),
    (1024, 256, list(tmm.TILES)),
    (1040, 8, [(128, 64, 32, 64, 32)]),
])
def test_tile_fits_the_shape(K, N, fits):
    """No tile wider than N rounded up to 64, 64-deep slices only where
    K % 64 == 0, 64 x 64 warps only where K >= LONG_K."""
    assert [t for t in tmm.TILES if tmm.tile_fits(t, K, N)] == fits


@pytest.mark.parametrize("M,K,N", RAGGED + RESNET_1X1[-3:] + [(25088 // 4, 128, 512)])
def test_grid_covers_every_output_once(M, K, N):
    p = _plan(M, K, N)
    assert p.instance == "tiled"
    hits = np.zeros((M, N), np.int32)
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            # A block stores rows [bx*bm, +bm) and columns [by*bn, +bn) below M, N.
            hits[bx * p.bm:(bx + 1) * p.bm, by * p.bn:(by + 1) * p.bn] += 1
    assert (hits == 1).all()
    assert (p.grid[0] - 1) * p.bm < M and (p.grid[1] - 1) * p.bn < N  # no idle block


def _compiled_instances():
    """(bm, bn, bk, stages, threads) of every SGG_MM_TILE line of the source."""
    rows = re.findall(r"^\s*SGG_MM_TILE\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)",
                      SOURCE.read_text(), re.M)
    return {(bm, bn, bk, st, 32 * (bm // wm) * (bn // wn))
            for bm, bn, bk, st, wm, wn in (tuple(map(int, r)) for r in rows)}


def test_every_plan_names_a_compiled_instance():
    compiled = _compiled_instances()
    assert compiled == {(bm, bn, bk, tmm.STAGES, 32 * (bm // wm) * (bn // wn))
                        for bm, bn, bk, wm, wn in tmm.TILES}
    seen = set()
    for M in (1, 100, 1568, 6272, 25088, 100352):
        for K in (16, 48, 64, 80, 256, 1024, 2048):
            for N in (8, 64, 72, 128, 256, 512, 1024, 2048):
                p = _plan(M, K, N)
                key = (p.bm, p.bn, p.bk, p.stages, p.threads)
                assert key in compiled, (M, K, N, key)
                seen.add(key)
    assert seen == compiled  # and every compiled instance is reachable


def test_tiled_shared_memory_stays_within_the_card():
    for bm, bn, bk, _, _ in tmm.TILES:
        smem = tmm.tiled_smem(bm, bn, bk, tmm.STAGES)
        assert smem <= SMEM_PER_BLOCK
        # The staged bf16 output tile fits in the ring it reuses.
        assert 2 * bm * (bn + 8) <= smem


def test_plan_is_memoised():
    assert _plan(6272, 256, 1024) is _plan(6272, 256, 1024)
