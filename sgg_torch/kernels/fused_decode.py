"""Fused 3-step triple decode: the CUDA kernel and its plain PyTorch version.

Port of ``sgg/kernels/fused_decode.py``. ``fused_decode`` runs the whole
decode forward of the attention-LSTM generator (LSTM init from the mean
feature, hoisted feature projection, then per step additive attention, TF1
LSTM gates, deep output, masked vocab logits, ``softmax((logits + g) / tau)``
and, when ``hard``, the one-hot of its first maximum, fed back through the
embedding) in one launch of ``csrc/fused_decode.cu``. The Gumbel noise is an
input, so the result is comparable with the generator given the same noise.

:func:`plan` chooses the kernel's instance and launch: the "batched" Hopper
instance (bf16, B <= 64, F, A, H, E and Z multiples of 8) as one cooperative
launch of one block per SM, or the "generic" one (one block per batch row)
for everything else. The C entry takes the plan as it is.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs :func:`decode_plain`, a line-by-line PyTorch rendering of the Pallas
kernel with the same cast points (float32 accumulation; c, h, proj, hp, ctx,
dec, prev and y rounded to the compute dtype; float32 biases and mask).

Weights are the flat dict of :func:`decode_params_from_generator`: matrices
``[in, out]`` in the compute dtype, biases float32, all contiguous.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch

from sgg_torch.kernels import build, matmul

TRIPLE_LEN = 3
WEIGHT_NAMES = (
    "wf", "wh", "bh", "v", "wc", "bc", "wi", "bi", "k", "bk",
    "wd", "bd", "wv", "bv", "emb",
)
BIAS_NAMES = frozenset({"bh", "bc", "bi", "bk", "bd", "bv"})
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
ROW_TILES = (32, 16)  # the generic instance's feature row tiles, by preference
THREADS = 256
# The batched instance, as csrc/fused_decode.cu compiles it: the batch in
# 16-row tiles (2 or 4 of them, so B <= 64), a 4-deep cp.async ring, 32
# output columns per item of a weight product, 8 hidden units (their 4 gate
# columns) per item of the gates product, 256 features per item of the
# context phase; each product engine as (16-row tiles per warp, 8-column
# tiles per warp, warps along rows, along columns, along depth, slice
# depth): the weight products' by row-tile count, and proj's, 64 x 64
# tiles.
ROW_TILE_COUNTS = (2, 4)
STAGES = 4
ITEM_COLS = 32
GATE_UNITS = 8
CTX_COLS = 256
WEIGHT_ENGINE = {2: (2, 4, 1, 1, 8, 128), 4: (4, 4, 1, 1, 8, 128)}
PROJ_ENGINE = (2, 2, 2, 4, 1, 32)
PROJ_TILE = (64, 64)
# Timestamps the timed check-only entry records: the start, every grid
# barrier and the end of block 0.
MAX_MARKS = 32

# Kernel launches in this process; the wrapper adds one per launch.
launches = 0


def decode_params_from_generator(
    sd: dict, dtype: torch.dtype = torch.float32, device=None
) -> dict[str, torch.Tensor]:
    """Port generator state_dict → the kernel's flat weights, ``[in, out]``
    matrices in ``dtype`` and float32 biases, contiguous on ``device``."""
    raw = {
        "wf": sd["attention.feat_proj.weight"].t(),   # [F, A]
        "wh": sd["attention.state_proj.weight"].t(),  # [H, A]
        "bh": sd["attention.state_proj.bias"],        # [A]
        "v": sd["attention.score.weight"][0],         # [A]
        "wc": sd["init_c.weight"].t(),                # [F, H]
        "bc": sd["init_c.bias"],                      # [H]
        "wi": sd["init_h.weight"].t(),                # [F, H]
        "bi": sd["init_h.bias"],                      # [H]
        "k": sd["cell.kernel"],                       # [F+E+Z+H, 4H]
        "bk": sd["cell.bias"],                        # [4H]
        "wd": sd["deep_out.weight"].t(),              # [H+F, E]
        "bd": sd["deep_out.bias"],                    # [E]
        "wv": sd["vocab_proj.weight"].t(),            # [E, V]
        "bv": sd["vocab_proj.bias"],                  # [V]
        "emb": sd["token_embedding"],                 # [V, E]
    }
    return cast_params(raw, dtype, device)


def cast_params(params: dict, dtype: torch.dtype, device=None) -> dict[str, torch.Tensor]:
    """Weights to ``dtype``, biases to float32, contiguous on ``device``."""
    out = {}
    for n in WEIGHT_NAMES:
        t = params[n]
        t = t if torch.is_tensor(t) else torch.from_numpy(np.array(t))
        t = t.to(device=device, dtype=torch.float32 if n in BIAS_NAMES else dtype)
        out[n] = t.contiguous()
    return out


def step_mask_bias(step_mask, device=None) -> torch.Tensor:
    """bool[3, V] legality mask → additive float32 bias (0 legal, -1e9 not)."""
    m = torch.as_tensor(step_mask, dtype=torch.bool, device=device)
    return torch.where(m, 0.0, -1e9).to(torch.float32)


def decode_plain(
    params: dict, feats: torch.Tensor, z: torch.Tensor, gumbel: torch.Tensor,
    tau: float = 1.0, mask_bias: torch.Tensor | None = None, hard: bool = True,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch → y [B, 3, V] in feats' dtype."""
    p = params
    dtype = feats.dtype
    f32 = torch.float32
    B, R, F = feats.shape
    E = p["emb"].shape[1]
    H = p["wc"].shape[1]
    V = p["wv"].shape[1]
    if mask_bias is None:
        mask_bias = torch.zeros(TRIPLE_LEN, V, dtype=f32, device=feats.device)

    def dot(a, w):  # products accumulate in float32
        return a.to(f32) @ w.to(f32)

    mean = feats.to(f32).mean(dim=1).to(dtype)
    c = torch.tanh(dot(mean, p["wc"]) + p["bc"]).to(dtype)
    h = torch.tanh(dot(mean, p["wi"]) + p["bi"]).to(dtype)
    proj = dot(feats.reshape(B * R, F), p["wf"]).to(dtype).reshape(B, R, -1)
    prev = torch.zeros(B, E, dtype=dtype, device=feats.device)
    iota_v = torch.arange(V, device=feats.device).expand(B, V)

    ys = []
    for t in range(TRIPLE_LEN):
        hp = (dot(h, p["wh"]) + p["bh"]).to(dtype)
        s = torch.tanh(proj + hp[:, None, :])  # [B, R, A] in dtype
        scores = (s.to(f32) * p["v"].to(f32)[None, None, :]).sum(dim=-1)
        m = scores.max(dim=-1, keepdim=True).values
        e = torch.exp(scores - m)
        alpha = e / e.sum(dim=-1, keepdim=True)
        ctx = (alpha[:, :, None] * feats.to(f32)).sum(dim=1).to(dtype)
        x = torch.cat([ctx, prev, z.to(dtype), h], dim=-1)
        gates = dot(x, p["k"]) + p["bk"]
        i, j, fg, o = torch.split(gates, H, dim=-1)
        cf = c.to(f32) * torch.sigmoid(fg + 1.0) + torch.sigmoid(i) * torch.tanh(j)
        c = cf.to(dtype)
        h = (torch.tanh(cf) * torch.sigmoid(o)).to(dtype)
        dec = torch.tanh(dot(torch.cat([h, ctx], dim=-1), p["wd"]) + p["bd"]).to(dtype)
        logits = dot(dec, p["wv"]) + p["bv"] + mask_bias[t][None, :]
        ly = (logits + gumbel[:, t, :]) / tau
        mly = ly.max(dim=-1, keepdim=True).values
        ey = torch.exp(ly - mly)
        y = ey / ey.sum(dim=-1, keepdim=True)  # [B, V] float32
        if hard:
            ymax = y.max(dim=-1, keepdim=True).values
            # Tie-break like argmax: smallest index among maxima.
            first = torch.where(y == ymax, iota_v, V).min(dim=-1, keepdim=True).values
            y = (iota_v == first).to(f32)
        y = y.to(dtype)
        prev = dot(y, p["emb"]).to(dtype)
        ys.append(y)
    return torch.stack(ys, dim=1)


@dataclass(frozen=True)
class DecodePlan:
    """One launch of ``fused_decode``: the instance ("batched" or
    "generic"), its grid (batched: one block per SM, all co-resident;
    generic: one per batch row), threads, dynamic shared memory in bytes and
    scratch bytes; the batched instance's 16-row tiles of the batch
    (``row_tiles``), ring depth and, per phase, its work items as (phase,
    items, outputs per item); the generic instance's feature row tile; and
    the widths it was made for."""

    instance: str
    grid: int
    threads: int
    smem: int
    scratch: int
    row_tiles: int = 0
    stages: int = 0
    phases: tuple[tuple[str, int, int], ...] = ()
    row_tile: int = 0
    widths: tuple[int, ...] = ()  # (B, R, F, A, H, E, Z, V)

    def items(self, phase: str) -> list[tuple[int, tuple[int, ...]]]:
        """(block, output columns) of each item of a weight-product phase of
        the batched instance, in item order; item i runs on block i % grid.
        "init" covers c's H columns, then h's as H + n; "gates" the 4H
        columns of k, unit j's four at j, H + j, 2H + j and 3H + j; "dec_hp"
        dec's E columns, then hp's as E + n."""
        _, _, _, A, H, E, _, V = self.widths

        def slices(n, at=0):
            return [tuple(range(at + n0, at + min(n0 + ITEM_COLS, n)))
                    for n0 in range(0, n, ITEM_COLS)]

        groups = {
            "init": lambda: slices(H) + slices(H, H),
            "gates": lambda: [tuple(g * H + j0 + u for g in range(4) for u in range(GATE_UNITS))
                              for j0 in range(0, H, GATE_UNITS)],
            "hp": lambda: slices(A),
            "dec_hp": lambda: slices(E) + slices(A, E),
            "logits": lambda: slices(V),
            "soft_feedback": lambda: slices(E),
        }
        if phase not in groups:
            raise ValueError(f"{phase!r} is not a weight-product phase")
        return [(i % self.grid, g) for i, g in enumerate(groups[phase]())]


def _ring_smem(mt: int, ntw: int, wm: int, wn: int, wk: int, bk: int) -> int:
    """Bytes of one product engine of the batched instance (``Eng`` in the
    source): its ring of STAGES slices, or the warp groups' float32 sums,
    whichever is larger; every row padded by 8."""
    bm, bn = 16 * mt * wm, 8 * ntw * wn
    return max(2 * STAGES * (bm * (bk + 8) + bk * (bn + 8)), 4 * wk * bm * (bn + 8))


def batched_smem(row_tiles: int) -> int:
    """Dynamic shared memory of the batched instance: the larger of its
    weight-product engine (``WEng``) and its proj engine (``PEng``)."""
    return max(_ring_smem(*WEIGHT_ENGINE[row_tiles]), _ring_smem(*PROJ_ENGINE))


def scratch_bytes(B, R, F, A, H, E, Z, V) -> int:
    """Bytes of the batched instance's scratch, laid out as ``layout()`` in
    the source does: proj, the gates' and the deep output's inputs, mean,
    dec and soft y in bf16; c, hp, the scores and the logits in float32;
    wv padded to rows of a multiple of 8 where V is not one; each array
    256-byte aligned."""
    Vx = -(-V // 8) * 8
    sizes = (2 * B * R * A, 2 * B * (F + E + Z + H), 2 * B * (H + F), 2 * B * F, 2 * B * E,
             2 * B * Vx, 4 * B * H, 4 * B * A, 4 * B * R, 4 * B * V,
             2 * E * Vx if V % 8 else 0)
    return sum(-(-n // 256) * 256 for n in sizes)


def generic_smem(R, F, A, H, E, Z, V, row_tile) -> int:
    """Bytes of the generic instance's shared memory (``smem_floats`` in
    the source): the feature tile, then the per-row vectors."""
    K = F + E + Z + H
    return 4 * (row_tile * ((F + 3) & ~3) + K + H + F + 2 * A + R + 4 * H + E + V + 8)


@functools.lru_cache(maxsize=256)  # the wrapper asks once per launch
def plan(B: int, R: int, F: int, A: int, H: int, E: int, Z: int, V: int, dtype,
         sms: int = matmul.SMS, row_tile: int | None = None) -> DecodePlan:
    """The launch of one decode of B rows at these widths on a card of
    ``sms`` streaming multiprocessors.

    "batched" takes bf16 with 1 <= B <= 64 and F, A, H, E, Z multiples of 8,
    on a grid of one block per SM; everything else, and any call that names
    ``row_tile``, runs "generic". ``row_tile`` is for checks only: it picks
    the generic instance's feature row tile (32 or 16, at most the one that
    fits), so that the 16-row tile can be held where 32 fits."""
    if (row_tile is None and dtype == torch.bfloat16 and 1 <= B <= 64
            and min(F, A, H, E) >= 8 and Z >= 0
            and all(w % 8 == 0 for w in (F, A, H, E, Z))):
        mt = ROW_TILE_COUNTS[0] if B <= 16 * ROW_TILE_COUNTS[0] else ROW_TILE_COUNTS[1]
        smem = batched_smem(mt)
        if 4 * R <= smem:  # the context phase's attention weights reuse the ring
            bm, bn = PROJ_TILE
            phases = (
                ("proj", -(-(B * R) // bm) * -(-A // bn), bm * bn),
                ("init", 2 * -(-H // ITEM_COLS), ITEM_COLS),
                ("hp", -(-A // ITEM_COLS), ITEM_COLS),
                ("scores", B * R, 1),
                ("ctx", B * -(-F // CTX_COLS), CTX_COLS),
                ("gates", H // GATE_UNITS, 4 * GATE_UNITS),
                ("dec_hp", -(-E // ITEM_COLS) + -(-A // ITEM_COLS), ITEM_COLS),
                ("logits", -(-V // ITEM_COLS), ITEM_COLS),
                ("feedback", B, V),
                ("soft_feedback", -(-E // ITEM_COLS), ITEM_COLS),
            )
            return DecodePlan("batched", sms, THREADS, smem,
                              scratch_bytes(B, R, F, A, H, E, Z, V), mt, STAGES, phases,
                              widths=(B, R, F, A, H, E, Z, V))
    fits = [rt for rt in ROW_TILES if generic_smem(R, F, A, H, E, Z, V, rt) <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"fused_decode at R={R}, F={F}, A={A}, H={H}, E={E}, Z={Z}, V={V} needs more "
            f"than the {_SMEM_LIMIT} bytes of shared memory a Hopper block has, even "
            f"with 16-row feature tiles"
        )
    if row_tile is None:
        row_tile = fits[0]
    elif row_tile not in ROW_TILES or row_tile > fits[0]:
        raise ValueError(
            f"row_tile {row_tile}: the kernel takes 32 or 16 feature rows per tile, and "
            f"at most {fits[0]} at these widths"
        )
    return DecodePlan("generic", B, THREADS, generic_smem(R, F, A, H, E, Z, V, row_tile),
                      B * R * A * (4 if dtype == torch.float32 else 2), row_tile=row_tile,
                      widths=(B, R, F, A, H, E, Z, V))


@functools.lru_cache(maxsize=64)
def _wanted(B, R, F, A, H, E, Z, V, dtype) -> tuple[list, list]:
    """The dtypes and shapes of feats, z, gumbel, mask_bias and the weights
    (WEIGHT_NAMES' order) at these widths."""
    f32 = torch.float32
    shapes = [(B, R, F), (B, Z), (B, TRIPLE_LEN, V), (TRIPLE_LEN, V),
              (F, A), (H, A), (A,), (A,), (F, H), (H,), (F, H), (H,),
              (F + E + Z + H, 4 * H), (4 * H,), (H + F, E), (E,), (E, V), (V,), (V, E)]
    dtypes = [dtype, dtype, f32, f32] + [f32 if n in BIAS_NAMES else dtype
                                         for n in WEIGHT_NAMES]
    return dtypes, shapes


def _check(params, feats, z, gumbel, mask_bias):
    """Every input's device, dtype, shape and contiguity → (B, R, F, A, H,
    E, Z, V); raises on the first that the kernel does not take."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be [B, R, F], got {tuple(feats.shape)}")
    dtype = feats.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"feats dtype {dtype} not supported (float32, bfloat16)")
    B, R, F = feats.shape
    A = params["wf"].shape[1]
    H = params["wc"].shape[1]
    E = params["emb"].shape[1]
    V = params["wv"].shape[1]
    Z = z.shape[-1]
    ts = [feats, z, gumbel, mask_bias] + [params[n] for n in WEIGHT_NAMES]
    dtypes, shapes = _wanted(B, R, F, A, H, E, Z, V, dtype)
    dev = feats.get_device()
    # One comparison of lists per property: the call runs once per draw, so
    # its host cost shows beside a launch of a tenth of a millisecond.
    if ([t.get_device() for t in ts] == [dev] * len(ts) and [t.dtype for t in ts] == dtypes
            and [t.shape for t in ts] == shapes and all(t.is_contiguous() for t in ts)):
        return B, R, F, A, H, E, Z, V
    names = ["feats", "z", "gumbel", "mask_bias", *WEIGHT_NAMES]
    for name, t, dt, shape in zip(names, ts, dtypes, shapes):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {feats.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt}")
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    raise AssertionError("unreachable")


@functools.cache
def _zero_mask(V: int, index: int) -> torch.Tensor:
    """The additive mask of no mask, [3, V] zeros on CUDA device ``index``;
    read only."""
    return torch.zeros(TRIPLE_LEN, V, dtype=torch.float32, device=torch.device("cuda", index))


def fused_decode(
    params: dict, feats: torch.Tensor, z: torch.Tensor, gumbel: torch.Tensor,
    tau: float = 1.0, mask_bias: torch.Tensor | None = None, hard: bool = True,
    row_tile: int | None = None,
) -> torch.Tensor:
    """One-launch 3-step decode → y [B, 3, V] in feats' dtype (one-hot when
    ``hard``; tokens are its argmax). CPU tensors take :func:`decode_plain`.

    ``row_tile`` is for checks only: it runs the generic instance with that
    feature row tile (32 or 16, no more than fits, or :func:`plan` raises),
    so that a check can hold the 16-row instance at widths where 32 fits and
    the plan would take the batched instance."""
    global launches
    dev = feats.device
    if dev.type == "cpu":
        return decode_plain(params, feats, z, gumbel, tau, mask_bias, hard)
    if dev.type != "cuda":
        raise ValueError(f"fused_decode runs on cuda or cpu, not {dev}")
    if mask_bias is None:
        mask_bias = _zero_mask(params["wv"].shape[1], feats.get_device())
    B, R, F, A, H, E, Z, V = _check(params, feats, z, gumbel, mask_bias)
    index = feats.get_device()
    p = plan(B, R, F, A, H, E, Z, V, feats.dtype, matmul.sm_count(index), row_tile)
    w = [params[n].data_ptr() for n in WEIGHT_NAMES]
    fz = (feats.data_ptr(), z.data_ptr())
    lib = build.load_library()
    y = torch.empty(B, TRIPLE_LEN, V, dtype=feats.dtype, device=dev)
    scratch = torch.empty(p.scratch, dtype=torch.uint8, device=dev)
    # At a tenth of a millisecond a launch, the host's cost of a call shows:
    # the wrapper switches devices only when it must and reads the current
    # stream's handle without building a torch.cuda.Stream.
    switch = index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        stream = torch._C._cuda_getCurrentRawStream(index)
        if p.instance == "batched":
            err = lib.sgg_fused_decode_batched(
                int(bool(hard)), B, R, F, A, H, E, Z, V, *fz,
                gumbel.data_ptr(), mask_bias.data_ptr(), float(tau), *w, scratch.data_ptr(),
                y.data_ptr(), p.row_tiles, p.grid, p.threads, p.stages, p.smem, p.scratch,
                stream)
        else:
            err = lib.sgg_fused_decode(
                _DTYPE_CODES[feats.dtype], int(bool(hard)), p.row_tile, B, R, F, A, H, E, Z,
                V, *fz, gumbel.data_ptr(), mask_bias.data_ptr(),
                float(tau), *w, scratch.data_ptr(), y.data_ptr(), stream)
    if err != 0:
        # The batched entry refuses bf16 inputs that do not start 16-byte
        # aligned (it reads them in 16-byte words); name them.
        named = [("feats", fz[0]), ("z", fz[1])] + list(zip(WEIGHT_NAMES, w))
        bad = [n for n, v in named if v % 16 and n not in BIAS_NAMES]
        if p.instance == "batched" and bad:
            raise ValueError(f"fused_decode's batched instance reads {', '.join(bad)} in "
                             f"16-byte words; their storage must start 16-byte aligned")
        raise RuntimeError(f"fused_decode {p.instance} kernel launch failed: CUDA error {err} "
                           f"(grid {p.grid}, {p.smem} bytes of shared memory)")
    launches += 1
    return y
