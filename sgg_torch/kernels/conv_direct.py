"""Direct stride-1 SAME convolution with a scale, bias and ReLU epilogue: the
CUDA kernel and its plain PyTorch version.

Port of ``sgg/kernels/conv_direct.py``. ``conv2d_direct(x, w, bias, scale,
relu)`` takes NHWC activations and HWIO weights, as the reference does, and
computes ``relu(scale * conv_same_s1(x, w) + bias)`` for odd kernels in one
launch of ``csrc/conv_direct.cu``, an implicit GEMM that never writes the
im2col patches to memory. Sums and epilogue are float32, then one cast to
x's dtype.

:func:`plan` chooses the kernel's instance and launch before each launch: the
"tiled" Hopper instance (bf16, C % 16 == 0, Cout % 8 == 0, x and w 16-byte
aligned) with its tile, channel-slice depth, ring depth, threads, shared
memory and grid, or the "generic" one for everything else. The C entry takes
the plan as it is.

On a CUDA tensor the wrapper launches the kernel or raises (also under grad
mode when an operand needs a gradient: the kernel has no backward); on a CPU
tensor it runs :func:`conv2d_direct_plain`: explicit zero padding and a float32
``F.conv2d``, the same epilogue, NHWC in and out.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from sgg_torch.kernels import build
from sgg_torch.kernels.matmul import (DTYPE_CODES, GENERIC_THREADS, GENERIC_TILE, SMS,
                                      GemmPlan, aligned, epilogue, epilogue_vectors,
                                      refuse_grad, sm_count, tiled_smem)

# Kernel launches in this process; the wrapper adds one per launch.
launches = 0

# The ring's depth; at every tile below two blocks' rings fit in an SM's
# 228 KB of shared memory, so the plan can put two blocks on each SM.
STAGES = 4
# The tiled instance's tiles as (BM, BN, BK, WM, WN), largest first: a block
# of BM x BN outputs, K slices of BK channels, warp tiles of WM x WN. The
# 64-channel slice is taken only where C % 64 == 0. csrc/conv_direct.cu
# compiles exactly these.
TILES = ((128, 128, 32, 64, 32), (128, 64, 32, 64, 32), (64, 64, 64, 32, 32))


@functools.lru_cache(maxsize=256)  # the wrapper asks once per launch
def plan(B: int, H: int, W: int, C: int, N: int, kh: int, kw: int, dtype,
         x_aligned: bool, w_aligned: bool, sms: int = SMS) -> GemmPlan:
    """The launch of one stride-1 SAME conv of x [B, H, W, C] with w
    [kh, kw, C, N] on a card of ``sms`` streaming multiprocessors.

    "tiled" takes bf16 with C % 16 == 0, N % 8 == 0 and both operands 16-byte
    aligned; everything else runs "generic". The tiled instance takes the
    largest tile of TILES that gives two blocks to each SM (at least
    2 * sms), skipping tiles wider than N rounded up to 64 and 64-channel
    slices where C % 64 != 0, else the tile with the most blocks."""
    M = B * H * W
    if not (dtype == torch.bfloat16 and C % 16 == 0 and N % 8 == 0 and x_aligned
            and w_aligned):
        bm, bn, bk = GENERIC_TILE
        return GemmPlan("generic", bm, bn, bk, 1, GENERIC_THREADS, 0,
                        (-(-M // bm), -(-N // bn)), a_vec=C % 16 == 0 and x_aligned,
                        b_vec=N % 8 == 0 and w_aligned)
    fits = [t for t in TILES
            if t[1] <= -(-max(N, 1) // 64) * 64 and (t[2] == 32 or C % t[2] == 0)]
    blocks = [(-(-M // t[0])) * (-(-N // t[1])) for t in fits]
    full = [t for t, n in zip(fits, blocks) if n >= 2 * sms]
    bm, bn, bk, wm, wn = full[0] if full else fits[blocks.index(max(blocks))]
    return GemmPlan("tiled", bm, bn, bk, STAGES, 32 * (bm // wm) * (bn // wn),
                    tiled_smem(bm, bn, bk, STAGES), (-(-M // bm), -(-N // bn)))


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """TensorFlow/XLA "SAME" padding of one axis → (low, high).

    The output has ceil(size / stride) positions; the total padding splits
    with the smaller half low, so under stride 2 it is asymmetric (a 7x7
    stride-2 conv on 224 pads (2, 3), a 3x3 stride-2 on 56 pads (0, 1)),
    which PyTorch's symmetric ``padding=k // 2`` does not reproduce."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_nhwc(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str,
             value: float = 0.0) -> torch.Tensor:
    """Pad H and W of an NHWC tensor for ``padding`` 'SAME' or 'VALID'."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', not {padding!r}")
    (ht, hb), (wl, wr) = same_pads(x.shape[1], kh, stride), same_pads(x.shape[2], kw, stride)
    return F.pad(x, (0, 0, wl, wr, ht, hb), value=value)


@contextlib.contextmanager
def _cudnn_tf32(enabled: bool):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def tf32_allowed(dtype: torch.dtype) -> bool:
    """Whether cuDNN may use TF32 for a conv of operands of ``dtype``: only
    for bfloat16 and float16, whose values TF32 holds exactly."""
    return dtype in (torch.bfloat16, torch.float16)


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` of float32 NCHW operands with cuDNN's TF32 set for both
    passes (the library reads the setting when each pass runs)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, tf32: bool):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.tf32 = stride, tf32
        with _cudnn_tf32(tf32):
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        with _cudnn_tf32(ctx.tf32):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [ctx.stride] * 2, [0, 0], [1, 1], False, [0, 0], 1,
                [need_x, need_w, False])
        return gx, gw, None, None


def conv2d_nhwc_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                    padding: str = "SAME") -> torch.Tensor:
    """float32 convolution of NHWC x with HWIO w → float32 NHWC, as
    ``lax.conv_general_dilated`` on float32 operands. On the card cuDNN's
    TF32 follows :func:`tf32_allowed` of x's and w's dtypes, in the forward
    and the backward: float32 operands get float32 products; bfloat16 x and
    w are exact in TF32, and each gradient the backward returns is cast to
    bfloat16, which rounds coarser than TF32 (at VGG-19's shapes the results
    lie at most 5.3e-4 rel L2 from float64, ``chip_smoke.conv_tf32_hold``,
    under half a bfloat16 rounding). The NCHW tensors are views of the NHWC
    ones (channels-last), not copies."""
    kh, kw = w.shape[0], w.shape[1]
    xp = pad_nhwc(x.float(), kh, kw, stride, padding)
    y = _Conv2dF32.apply(xp.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), stride,
                         tf32_allowed(x.dtype) and tf32_allowed(w.dtype))
    return y.permute(0, 2, 3, 1)


def conv2d_direct_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None, relu: bool = True, out_dtype=None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 conv, epilogue, cast."""
    _check(x, w)
    return epilogue(conv2d_nhwc_f32(x, w.to(x.dtype)), scale, bias, relu,
                    out_dtype or x.dtype).contiguous()


def _check(x, w):
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d_direct needs x [B,H,W,C] and w [kh,kw,C,N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[0] % 2 == 0 or w.shape[1] % 2 == 0:
        raise ValueError(f"SAME stride-1 kernel must be odd, got {tuple(w.shape[:2])}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"conv2d_direct takes float32 or bfloat16, not {x.dtype}")


def conv2d_direct(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None, relu: bool = True, out_dtype=None,
) -> torch.Tensor:
    """relu(scale * conv_same_s1(x, w) + bias) → NHWC in x's dtype.

    x [B, H, W, C] and w [kh, kw, C, N] with odd kh and kw; w is cast to x's
    dtype, as the reference casts it. CPU tensors take the plain version.
    Forward only: on a CUDA tensor an operand that needs a gradient raises
    (the library conv, ``conv2d_fused(impl='xla')``, carries the backward)."""
    global launches
    dev = x.device
    if dev.type == "cpu":
        return conv2d_direct_plain(x, w, bias, scale, relu, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"conv2d_direct runs on cuda or cpu, not {dev}")
    refuse_grad("conv2d_direct", x, w, bias, scale)
    _check(x, w)
    if (out_dtype or x.dtype) != x.dtype:
        raise TypeError(f"conv2d_direct writes x's dtype {x.dtype}, not {out_dtype}")
    if w.device != dev:
        raise ValueError(f"w is on {w.device}, x on {dev}")
    if not x.is_contiguous():
        raise ValueError("conv2d_direct needs a contiguous NHWC x")
    B, H, W, C = x.shape
    kh, kw, _, N = w.shape
    w = w.to(x.dtype).contiguous()  # [kh*kw*C, N] as it lies
    scale, bias = epilogue_vectors(scale, bias, N, dev)
    out = torch.empty(B, H, W, N, dtype=x.dtype, device=dev)
    p = plan(B, H, W, C, N, kh, kw, x.dtype, aligned(x), aligned(w), sm_count(dev.index))
    lib = build.load_library()
    ptrs = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr())
    # The host's cost of a call is about that of the tiled kernel, so the
    # wrapper switches devices only when it must and reads the current
    # stream's handle without building a torch.cuda.Stream.
    switch = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if p.instance == "tiled":
            err = lib.sgg_conv_direct_tiled(
                int(bool(relu)), B, H, W, C, kh, kw, N, *ptrs, p.bm, p.bn, p.bk,
                p.stages, p.threads, p.smem, *p.grid, stream)
        else:
            err = lib.sgg_conv_direct(
                DTYPE_CODES[x.dtype], int(bool(relu)), B, H, W, C, kh, kw, N, *ptrs,
                int(p.a_vec), int(p.b_vec), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_direct {p.instance} kernel launch failed: CUDA error "
                           f"{err} ({p})")
    launches += 1
    return out
