"""The launch plan of ``fused_decode`` (``sgg_torch.kernels.fused_decode.plan``),
checked on the CPU before any card runs it: which instance each width gets,
shared memory within the card's limit, a grid of one block per SM that
follows the card's SM count, work items that cover every output column of
each weight product exactly once (the four gate columns of a hidden unit in
one item), scratch sized as the source lays it out, and only instances that
``csrc/fused_decode.cu`` compiles.
"""

import re

import numpy as np
import pytest
import torch

from sgg_torch.kernels import fused_decode as tfd
from sgg_torch.kernels import matmul as tmm

torch.set_num_threads(1)

SOURCE = tfd.build.CSRC / "fused_decode.cu"
SMEM_PER_BLOCK = 232_448  # the most one block may take (227 KB)
BF16 = torch.bfloat16
# (R, F, A, H, E, Z, V): the trained vg1k run, resnet50, and the widths of
# the card tests (tests/test_torch_kernels_cuda.py).
VG1K = (196, 512, 256, 512, 256, 128, 210)
RESNET50 = (49, 2048, 256, 512, 256, 128, 8192)
CARD_TESTS = (9, 24, 16, 32, 16, 8, 40)
BATCHED = [(64, VG1K), (37, VG1K), (32, RESNET50), (8, RESNET50), (64, CARD_TESTS),
           (37, CARD_TESTS), (4, RESNET50)]


def _plan(B, widths, dtype=BF16, sms=tmm.SMS, row_tile=None):
    return tfd.plan(B, *widths, dtype, sms, row_tile)


@pytest.mark.parametrize("B,widths", BATCHED)
def test_main_path_and_card_test_widths_run_batched(B, widths):
    p = _plan(B, widths)
    assert p.instance == "batched" and p.threads == tfd.THREADS
    assert p.row_tiles == (2 if B <= 32 else 4) and B <= 16 * p.row_tiles
    assert p.stages == tfd.STAGES and p.grid == tmm.SMS
    assert p.smem == tfd.batched_smem(p.row_tiles) <= SMEM_PER_BLOCK
    assert p.scratch == tfd.scratch_bytes(B, *widths)
    assert p.widths == (B, *widths)


@pytest.mark.parametrize("B,widths,dtype", [
    (64, VG1K, torch.float32),                            # float32
    (32, RESNET50, torch.float32),
    (65, VG1K, BF16),                                     # more than 64 rows
    (64, (196, 20, 256, 512, 256, 128, 210), BF16),       # F % 8 != 0
    (64, (196, 512, 12, 512, 256, 128, 210), BF16),       # A % 8 != 0
    (64, (196, 512, 256, 36, 256, 128, 210), BF16),       # H % 8 != 0
    (64, (196, 512, 256, 512, 4, 128, 210), BF16),        # E < 8
    (64, (196, 512, 256, 512, 256, 3, 210), BF16),        # Z % 8 != 0
    (6, (9, 16, 8, 16, 8, 4, 32), BF16),                  # the CPU tests' widths
    (64, (30000, 64, 64, 64, 64, 64, 100), BF16),         # R's weights outgrow the ring
])
def test_everything_else_runs_generic(B, widths, dtype):
    p = _plan(B, widths, dtype)
    assert p.instance == "generic" and p.grid == B and p.threads == tfd.THREADS
    assert p.row_tile in tfd.ROW_TILES and p.smem <= SMEM_PER_BLOCK
    assert p.smem == tfd.generic_smem(*widths, p.row_tile)
    assert p.scratch == B * widths[0] * widths[2] * (4 if dtype == torch.float32 else 2)


def test_generic_row_tile_is_the_largest_that_fits():
    """32 feature rows at vg1k widths; 16 at resnet50's, where 32 would need
    328 KB; a named row_tile runs generic with that tile, and one larger than
    fits, or not compiled, is refused."""
    assert _plan(64, VG1K, torch.float32).row_tile == 32
    assert _plan(32, RESNET50, torch.float32).row_tile == 16
    assert tfd.generic_smem(*RESNET50, 32) > SMEM_PER_BLOCK
    p = _plan(64, VG1K, row_tile=16)
    assert p.instance == "generic" and p.row_tile == 16
    for bad in ((RESNET50, 32), (VG1K, 8)):
        with pytest.raises(ValueError, match="row_tile"):
            _plan(32, bad[0], row_tile=bad[1])


def test_nothing_fits_is_refused():
    with pytest.raises(ValueError, match="shared memory"):
        _plan(4, (196, 8192, 256, 8192, 256, 128, 210), torch.float32)


@pytest.mark.parametrize("sms", [78, 114, tmm.SMS])
def test_grid_follows_the_cards_sm_count(sms):
    for B, widths in BATCHED:
        p = _plan(B, widths, sms=sms)
        assert p.grid == sms
        for phase in ("init", "gates", "dec_hp", "logits", "soft_feedback"):
            assert all(0 <= block < sms for block, _ in p.items(phase))


@pytest.mark.parametrize("B,widths", BATCHED)
def test_items_cover_every_output_column_once(B, widths):
    p = _plan(B, widths)
    R, F, A, H, E, Z, V = widths
    outputs = {"init": 2 * H, "hp": A, "gates": 4 * H, "dec_hp": E + A, "logits": V,
               "soft_feedback": E}
    counts = dict((name, n) for name, n, _ in p.phases)
    for phase, n in outputs.items():
        items = p.items(phase)
        hits = np.zeros(n, np.int32)
        for _, cols in items:
            assert 0 < len(cols) <= tfd.ITEM_COLS
            hits[list(cols)] += 1
        assert (hits == 1).all(), phase
        if phase != "hp":
            assert len(items) == counts[phase], phase
    # proj's 64 x 64 tiles over [B * R, A], and the context phase's slices
    # of F per row.
    bm, bn = tfd.PROJ_TILE
    assert counts["proj"] == -(-B * R // bm) * -(-A // bn)
    assert counts["ctx"] == B * -(-F // tfd.CTX_COLS)
    assert counts["scores"] == B * R and counts["feedback"] == B


@pytest.mark.parametrize("B,widths", BATCHED)
def test_a_hidden_units_four_gate_columns_land_in_one_block(B, widths):
    """The TF1 cell of unit j reads gate columns j, H + j, 2H + j and 3H + j:
    one item holds all four, so the cell runs in that item's epilogue."""
    H = widths[3]
    where = {}
    for item, (block, cols) in enumerate(_plan(B, widths).items("gates")):
        assert len(cols) == 4 * tfd.GATE_UNITS
        for c in cols:
            where[c] = (item, block)
    for j in range(H):
        assert len({where[g * H + j] for g in range(4)}) == 1, j


def test_items_go_to_the_blocks_in_turn():
    p = _plan(32, RESNET50)
    blocks = [b for b, _ in p.items("logits")]
    assert len(blocks) == 256 and blocks == [i % p.grid for i in range(256)]


def _source():
    return SOURCE.read_text()


def test_constants_match_the_source():
    """The plan's item widths, ring depth, threads and engines are the
    source's."""
    src = _source()
    for name, value in (("kStages", tfd.STAGES), ("kCols", tfd.ITEM_COLS),
                        ("kUnits", tfd.GATE_UNITS), ("kThreads", tfd.THREADS),
                        ("kMarks", tfd.MAX_MARKS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(r"constexpr int kCtxCols = kThreads;", src)
    assert tfd.CTX_COLS == tfd.THREADS
    # WEng<MT> = Eng<MT, 4, 1, 1, 8, 128, 16>, PEng = Eng<2, 2, 2, 4, 1, 32,
    # kProjSum>: the engines batched_smem() sizes.
    for mt in tfd.ROW_TILE_COUNTS:
        assert tfd.WEIGHT_ENGINE[mt] == (mt, 4, 1, 1, 8, 128)
    assert "template <int MT> using WEng = Eng<MT, 4, 1, 1, kWarps, 128, 16>;" in src
    assert "using PEng = Eng<2, 2, 2, 4, 1, 32, kProjSum>;" in src
    assert tfd.PROJ_ENGINE == (2, 2, 2, 4, 1, 32)
    mt, ntw, wm, wn, _, _ = tfd.PROJ_ENGINE
    assert (16 * mt * wm, 8 * ntw * wn) == tfd.PROJ_TILE
    assert tfd.ITEM_COLS == 8 * tfd.WEIGHT_ENGINE[2][1]


def test_every_plan_names_a_compiled_instance():
    """The entry launches row-tile counts 2 and 4 at their own shared
    memory, and the generic instance's 32- and 16-row tiles; every one is
    reachable from plan()."""
    src = _source()
    compiled = {int(mt) for mt in re.findall(
        r"if \(mt == (\d+) && smem == smem_bytes<\1>\(\)\)", src)}
    assert compiled == set(tfd.ROW_TILE_COUNTS)
    generic = {int(rt) for rt in re.findall(r"case (\d+): return launch_tile<T, \1>", src)}
    assert generic == set(tfd.ROW_TILES)
    seen, seen_rt = set(), set()
    for B in (1, 8, 16, 17, 32, 33, 37, 64, 65):
        for widths in (VG1K, RESNET50, CARD_TESTS):
            for dtype in (BF16, torch.float32):
                p = _plan(B, widths, dtype)
                if p.instance == "batched":
                    assert p.row_tiles in compiled and p.smem == tfd.batched_smem(p.row_tiles)
                    seen.add(p.row_tiles)
                else:
                    assert p.row_tile in generic
                    seen_rt.add(p.row_tile)
    assert seen == compiled and seen_rt == generic


@pytest.mark.parametrize("B,widths", BATCHED + [(1, VG1K), (17, (9, 24, 16, 32, 16, 8, 41)),
                                             (5, (9, 24, 16, 32, 16, 8, 48))])
def test_scratch_is_the_sources_layout(B, widths):
    """scratch_bytes() adds up the arrays that layout() in the source takes,
    in its order, each 256-byte aligned."""
    R, F, A, H, E, Z, V = widths
    takes = re.findall(r"L\.\w+ = take\((.*)\);", _source())
    assert len(takes) == 11
    env = dict(B=B, R=R, F=F, A=A, H=H, E=E, Z=Z, V=V)
    total = 0
    for expr in takes:
        # C to Python: 2L -> 2, integer division, cond ? a : b -> a if cond else b.
        expr = re.sub(r"(\d+)L\b", r"\1", expr).replace("/", "//")
        expr = re.sub(r"^(.*) \? (.*) : (.*)$", r"(\2) if (\1) else (\3)", expr)
        n = eval(expr, {}, env)
        total += -(-n // 256) * 256
    assert tfd.scratch_bytes(B, *widths) == total


def test_batched_shared_memory_stays_within_the_card():
    for mt in tfd.ROW_TILE_COUNTS:
        smem = tfd.batched_smem(mt)
        assert smem <= SMEM_PER_BLOCK
        # The weight products' warp sums (8 groups of [16 * mt, 32] float32)
        # fit in the ring they reuse.
        assert 4 * 8 * 16 * mt * tfd.ITEM_COLS <= smem
    assert tfd.batched_smem(2) == 75_776 and tfd.batched_smem(4) == 110_592


def test_plan_is_memoised():
    assert _plan(64, VG1K) is _plan(64, VG1K)
    assert _plan(64, VG1K) is not _plan(64, VG1K, row_tile=16)
