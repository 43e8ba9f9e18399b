"""The launch plan of ``conv2d_direct`` (``sgg_torch.kernels.conv_direct.plan``),
checked on the CPU before any card runs it: which instance each shape gets,
the tiles of the ResNet-50 3x3 convs, shared memory within the card's limit,
a grid that covers every output exactly once, and only instances that
``csrc/conv_direct.cu`` compiles.
"""

import re

import numpy as np
import pytest
import torch

from sgg_torch.kernels import conv_direct as tcd

# ResNet-50's 3x3 stride-1 convs at 224 px: (H = W, C = Cout).
RESNET_3X3 = [(56, 64), (28, 128), (14, 256), (7, 512)]
# VGG-19's stride-1 convs at 224 px: (H = W, C, Cout); conv1_1 (C = 3) apart.
VGG_CONVS = [(224, 64, 64), (112, 64, 128), (112, 128, 128), (56, 128, 256),
             (56, 256, 256), (28, 256, 512), (28, 512, 512), (14, 512, 512)]
STRIDE1_SHAPES = ([(B, hw, hw, c, c) for B in (32, 8) for hw, c in RESNET_3X3]
                  + [(B, hw, hw, c, n) for B in (32, 8) for hw, c, n in VGG_CONVS])
# Ragged M and N, halos inside one tile, 5x5, C = 32 and C = 48.
RAGGED = [(3, 7, 7, 512, 512, 3), (2, 9, 13, 64, 72, 3), (1, 5, 5, 32, 16, 3),
          (2, 14, 14, 64, 64, 5), (5, 13, 9, 48, 24, 3), (1, 3, 3, 16, 8, 1)]
SOURCE = tcd.build.CSRC / "conv_direct.cu"
SMEM_PER_SM = 233_472     # an H100 SM's shared memory (228 KB)
SMEM_PER_BLOCK = 232_448  # the most one block may take (227 KB)
SMEM_RESERVED = 1_024     # the runtime's own share of each block


def _plan(B, H, W, C, N, k=3, dtype=torch.bfloat16, x_aligned=True, w_aligned=True):
    return tcd.plan(B, H, W, C, N, k, k, dtype, x_aligned, w_aligned)


@pytest.mark.parametrize("B,H,W,C,N", STRIDE1_SHAPES)
def test_resnet50_and_vgg19_stride1_convs_run_tiled(B, H, W, C, N):
    p = _plan(B, H, W, C, N)
    assert p.instance == "tiled"
    assert p.smem <= SMEM_PER_BLOCK
    assert 2 * (p.smem + SMEM_RESERVED) <= SMEM_PER_SM  # two blocks per SM
    assert p.bk in (32, 64) and C % p.bk == 0 and p.stages == tcd.STAGES


@pytest.mark.parametrize("B,H,W,C,N,k,dtype,x_aligned,w_aligned", [
    (8, 224, 224, 3, 64, 3, torch.bfloat16, True, True),    # VGG-19 conv1_1
    (5, 13, 9, 40, 70, 3, torch.bfloat16, True, True),      # C % 16 != 0
    (2, 7, 7, 96, 70, 5, torch.bfloat16, True, True),       # Cout % 8 != 0
    (32, 56, 56, 64, 64, 3, torch.float32, True, True),     # float32
    (32, 7, 7, 512, 512, 3, torch.float32, True, True),
    (32, 28, 28, 128, 128, 3, torch.bfloat16, False, True),  # x not 16-byte aligned
    (32, 28, 28, 128, 128, 3, torch.bfloat16, True, False),  # w not 16-byte aligned
])
def test_everything_else_runs_generic(B, H, W, C, N, k, dtype, x_aligned, w_aligned):
    p = _plan(B, H, W, C, N, k, dtype, x_aligned, w_aligned)
    assert p.instance == "generic"
    assert (p.bm, p.bn, p.bk) == tcd.GENERIC_TILE and p.smem == 0
    assert p.a_vec == (C % 16 == 0 and x_aligned)
    assert p.b_vec == (N % 8 == 0 and w_aligned)


@pytest.mark.parametrize("hw,c,tile,blocks", [
    (56, 64, (128, 64, 32), 784), (28, 128, (128, 64, 32), 392),
    (14, 256, (64, 64, 64), 392), (7, 512, (64, 64, 64), 200),
])
def test_resnet50_tiles_fill_the_sms(hw, c, tile, blocks):
    p = _plan(32, hw, hw, c, c)
    assert (p.bm, p.bn, p.bk) == tile and p.stages == tcd.STAGES
    assert p.grid[0] * p.grid[1] == blocks >= tcd.SMS


@pytest.mark.parametrize("C", [16, 32, 48])
def test_64_channel_slices_only_where_c_is_a_multiple_of_64(C):
    for B, hw, N in ((1, 7, 64), (2, 14, 72), (32, 7, 16)):
        p = _plan(B, hw, hw, C, N)
        assert p.instance == "tiled" and p.bk == 32 and (p.bm, p.bn) == (128, 64)


@pytest.mark.parametrize("sms", [78, 114, tcd.SMS])
def test_tiles_follow_the_cards_sm_count(sms):
    for hw, c in RESNET_3X3:
        p = tcd.plan(32, hw, hw, c, c, 3, 3, torch.bfloat16, True, True, sms)
        assert p.grid[0] * p.grid[1] >= sms
    # 128 x 64 gives the 14 x 14 stage 196 blocks: two per SM only below 99 SMs.
    p = tcd.plan(32, 14, 14, 256, 256, 3, 3, torch.bfloat16, True, True, sms)
    assert (p.bm, p.bn, p.bk) == ((128, 64, 32) if 2 * sms <= 196 else (64, 64, 64))


@pytest.mark.parametrize("B,H,W,C,N,k", RAGGED + [(B, H, W, C, N, 3)
                                                  for B, H, W, C, N in STRIDE1_SHAPES[:4]])
def test_grid_covers_every_output_once(B, H, W, C, N, k):
    p = _plan(B, H, W, C, N, k)
    M = B * H * W
    hits = np.zeros((M, N), np.int32)
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            # A block stores rows [bx*bm, +bm) and columns [by*bn, +bn) below M, N.
            hits[bx * p.bm:(bx + 1) * p.bm, by * p.bn:(by + 1) * p.bn] += 1
    assert (hits == 1).all()
    assert (p.grid[0] - 1) * p.bm < M and (p.grid[1] - 1) * p.bn < N  # no idle block


def _compiled_instances():
    """(bm, bn, bk, stages, threads) of every SGG_CONV_TILE line of the source."""
    rows = re.findall(r"^\s*SGG_CONV_TILE\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)",
                      SOURCE.read_text(), re.M)
    return {(bm, bn, bk, st, 32 * (bm // wm) * (bn // wn))
            for bm, bn, bk, st, wm, wn in (tuple(map(int, r)) for r in rows)}


def test_every_plan_names_a_compiled_instance():
    compiled = _compiled_instances()
    assert compiled == {(bm, bn, bk, tcd.STAGES, 32 * (bm // wm) * (bn // wn))
                        for bm, bn, bk, wm, wn in tcd.TILES}
    seen = set()
    for B in (1, 2, 8, 32):
        for hw in (3, 7, 14, 28, 56, 112, 224):
            for C in (16, 32, 48, 64, 128, 256, 512):
                for N in (8, 16, 64, 72, 128, 256, 512):
                    p = _plan(B, hw, hw, C, N)
                    key = (p.bm, p.bn, p.bk, p.stages, p.threads)
                    assert key in compiled, (B, hw, C, N, key)
                    assert p.smem == tcd.tiled_smem(p.bm, p.bn, p.bk, p.stages)
                    seen.add(key)
    assert seen == compiled  # and every compiled instance is reachable


def test_tiled_shared_memory_stays_within_the_card():
    for bm, bn, bk, _, _ in tcd.TILES:
        smem = tcd.tiled_smem(bm, bn, bk, tcd.STAGES)
        assert smem <= SMEM_PER_BLOCK and 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
        # The staged bf16 output tile fits in the ring it reuses.
        assert 2 * bm * (bn + 8) <= smem
