"""Fused matmul with a scale, bias and ReLU epilogue: the CUDA kernel and its
plain PyTorch version.

Port of ``sgg/kernels/matmul.py``. ``fused_matmul(a, b, bias, scale, relu,
out_dtype)`` computes ``relu(scale * (a @ b) + bias)`` in one launch of
``csrc/fused_matmul.cu``: the sum is float32, scale and bias are float32, the
epilogue runs once on the float32 sums, then one cast to ``out_dtype``. It is
the engine of the 1x1 convolutions and of the im2col convolution route
(``sgg_torch.kernels.conv``).

:func:`plan` chooses the kernel's instance and launch before each launch: the
"tiled" Hopper instance (bf16 in and out, K % 16 == 0, N % 8 == 0, a and b
16-byte aligned) with its tile, ring depth, threads, shared memory and grid,
or the "generic" one for everything else. The C entry takes the plan as it
is.

On a CUDA tensor the wrapper launches the kernel or raises (also under grad
mode when an operand needs a gradient: the kernel has no backward,
:func:`refuse_grad`); on a CPU tensor it runs :func:`fused_matmul_plain`, the
same arithmetic in PyTorch.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import torch

from sgg_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process; the wrapper adds one per launch.
launches = 0

# Streaming multiprocessors of an H100 SXM: plan()'s default here and in
# conv_direct; the wrappers pass the count of the device they launch on.
SMS = 132
# The tiled instance's ring depth and tiles as (BM, BN, BK, WM, WN), in the
# plan's order of preference: a block of BM x BN outputs, K slices of BK,
# warp tiles of WM x WN. The order is the card's, from timing every tile at
# every ResNet-50 1x1 shape (H100): four warps of 64 x 64 only where K >=
# LONG_K, the 64-deep slice only where K % 64 == 0. csrc/fused_matmul.cu
# compiles exactly these.
STAGES = 4
LONG_K = 1024
TILES = ((128, 128, 32, 64, 64), (128, 128, 32, 64, 32), (128, 64, 64, 64, 32),
         (128, 64, 32, 64, 32))
GENERIC_TILE = (128, 64, 32)  # gemm_tile.cuh's kBM, kBN, kBK, shared with conv_direct
GENERIC_THREADS = 256


@dataclass(frozen=True)
class GemmPlan:
    """One launch of a GEMM kernel (``fused_matmul``, or ``conv2d_direct``'s
    implicit GEMM): the instance, its block tile (bm x bn outputs, K slices
    of bk), ring depth, threads, dynamic shared memory in bytes and grid (M
    tiles, N tiles). a_vec and b_vec are the generic instance's 16-byte load
    flags."""

    instance: str
    bm: int
    bn: int
    bk: int
    stages: int
    threads: int
    smem: int
    grid: tuple[int, int]
    a_vec: bool = False
    b_vec: bool = False


def tiled_smem(bm: int, bn: int, bk: int, stages: int) -> int:
    """Bytes of a tiled instance's ring (A [bm, bk] and B [bk, bn] per
    slot, bf16 rows padded by 8), or of the staged output tile [bm, bn + 8]
    if larger; conv_direct's tiled instance lays out the same."""
    return 2 * max(stages * (bm * (bk + 8) + bk * (bn + 8)), bm * (bn + 8))


def tile_fits(tile: tuple[int, int, int, int, int], K: int, N: int) -> bool:
    """Whether the plan may take ``tile`` for a [., K] @ [K, N] product: no
    wider than N rounded up to 64, a 64-deep slice only where K % 64 == 0,
    64 x 64 warps only where K >= LONG_K."""
    bm, bn, bk, wm, wn = tile
    return (bn <= -(-max(N, 1) // 64) * 64 and (bk == 32 or K % bk == 0)
            and (wm * wn < 64 * 64 or K >= LONG_K))


@functools.lru_cache(maxsize=256)  # the wrapper asks once per launch
def plan(M: int, K: int, N: int, dtype, out_dtype, a_aligned: bool, b_aligned: bool,
         sms: int = SMS) -> GemmPlan:
    """The launch of one [M, K] @ [K, N] on a card of ``sms`` streaming
    multiprocessors.

    "tiled" takes bf16 in and out with K % 16 == 0, N % 8 == 0 and both
    operands 16-byte aligned; everything else runs "generic". The tiled
    instance takes the first tile of TILES that fits the shape
    (:func:`tile_fits`) and gives every SM a block (at least ``sms``), else
    the fitting tile with the most blocks."""
    if not (dtype == torch.bfloat16 and out_dtype == torch.bfloat16 and K % 16 == 0
            and N % 8 == 0 and a_aligned and b_aligned):
        bm, bn, bk = GENERIC_TILE
        return GemmPlan("generic", bm, bn, bk, 1, GENERIC_THREADS, 0,
                          (-(-M // bm), -(-N // bn)), a_vec=K % 16 == 0 and a_aligned,
                          b_vec=N % 8 == 0 and b_aligned)
    fits = [t for t in TILES if tile_fits(t, K, N)]
    blocks = [(-(-M // t[0])) * (-(-N // t[1])) for t in fits]
    full = [t for t, n in zip(fits, blocks) if n >= sms]
    bm, bn, bk, wm, wn = full[0] if full else fits[blocks.index(max(blocks))]
    return GemmPlan("tiled", bm, bn, bk, STAGES, 32 * (bm // wm) * (bn // wn),
                      tiled_smem(bm, bn, bk, STAGES), (-(-M // bm), -(-N // bn)))


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def epilogue(
    acc: torch.Tensor, scale: torch.Tensor | None, bias: torch.Tensor | None,
    relu: bool, out_dtype: torch.dtype,
) -> torch.Tensor:
    """float32 sums → cast(relu(acc * scale + bias)), scale and bias in float32."""
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(out_dtype)


def fused_matmul_plain(
    a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None, relu: bool = False, out_dtype=None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: float32 product, epilogue, cast."""
    _check_operands(a, b)
    return epilogue(a.float() @ b.float(), scale, bias, relu, out_dtype or a.dtype)


def _check_operands(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fused_matmul needs [M, K] @ [K, N], got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"fused_matmul takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")


def epilogue_vectors(scale, bias, N, device):
    """scale and bias as contiguous float32 [N] on ``device`` (ones, zeros)."""
    out = []
    for t, fill in ((scale, 1.0), (bias, 0.0)):
        if t is None:
            t = torch.full((N,), fill, dtype=torch.float32, device=device)
        t = t.to(device=device, dtype=torch.float32).contiguous()
        if tuple(t.shape) != (N,):
            raise ValueError(f"scale and bias must be [{N}], got {tuple(t.shape)}")
        out.append(t)
    return out


def refuse_grad(name: str, *operands) -> None:
    """Raise when grad mode is on and an operand needs a gradient: the CUDA
    kernel writes its output outside autograd, so the gradient would stop
    there without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        raise NotImplementedError(
            f"{name} is forward only on the card; an operand needs a gradient: train on the "
            "library conv (conv2d_fused impl='xla', model.use_pallas=false), or run under "
            "torch.no_grad()")


def aligned(t: torch.Tensor) -> bool:
    """Whether the tensor's storage starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0


def fused_matmul(
    a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None, relu: bool = False, out_dtype=None,
) -> torch.Tensor:
    """relu(scale * (a @ b) + bias) → [M, N] in ``out_dtype`` (default a's).

    ``a`` [M, K] and ``b`` [K, N] share a dtype, float32 or bfloat16; the
    output is that dtype or float32. CPU tensors take the plain version.
    Forward only: on a CUDA tensor an operand that needs a gradient raises."""
    global launches
    dev = a.device
    out_dtype = out_dtype or a.dtype
    if dev.type == "cpu":
        return fused_matmul_plain(a, b, bias, scale, relu, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_matmul runs on cuda or cpu, not {dev}")
    refuse_grad("fused_matmul", a, b, bias, scale)
    _check_operands(a, b)
    if out_dtype not in (a.dtype, torch.float32):
        raise TypeError(f"fused_matmul writes {a.dtype} or float32, not {out_dtype}")
    if b.device != dev:
        raise ValueError(f"b is on {b.device}, a on {dev}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("fused_matmul needs contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    scale, bias = epilogue_vectors(scale, bias, N, dev)
    out = torch.empty(M, N, dtype=out_dtype, device=dev)
    p = plan(M, K, N, a.dtype, out_dtype, aligned(a), aligned(b), sm_count(dev.index))
    lib = build.load_library()
    ptrs = (a.data_ptr(), b.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr())
    # The host's cost of a call is about that of the kernel at the smaller
    # shapes, so the wrapper switches devices only when it must and reads
    # the current stream's handle without building a torch.cuda.Stream.
    switch = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if p.instance == "tiled":
            err = lib.sgg_fused_matmul_tiled(
                int(bool(relu)), M, N, K, *ptrs, p.bm, p.bn, p.bk, p.stages, p.threads,
                p.smem, *p.grid, stream)
        else:
            err = lib.sgg_fused_matmul(
                DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype], int(bool(relu)), M, N, K,
                *ptrs, int(p.a_vec), int(p.b_vec), stream)
    if err != 0:
        raise RuntimeError(f"fused_matmul {p.instance} kernel launch failed: CUDA error "
                           f"{err} ({p})")
    launches += 1
    return out
