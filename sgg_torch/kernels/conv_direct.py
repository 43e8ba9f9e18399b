"""Direct stride-1 SAME convolution with a scale, bias and ReLU epilogue: the
CUDA kernel and its plain PyTorch version.

Port of ``sgg/kernels/conv_direct.py``. ``conv2d_direct(x, w, bias, scale,
relu)`` takes NHWC activations and HWIO weights, as the reference does, and
computes ``relu(scale * conv_same_s1(x, w) + bias)`` for odd kernels in one
launch of ``csrc/conv_direct.cu``, an implicit GEMM that never writes the
im2col patches to memory. Sums and epilogue are float32, then one cast to
x's dtype.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs :func:`conv2d_direct_plain`: explicit zero padding and a float32
``F.conv2d``, the same epilogue, NHWC in and out.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from sgg_torch.kernels import build
from sgg_torch.kernels.matmul import DTYPE_CODES, aligned, epilogue, epilogue_vectors

# Kernel launches in this process; the wrapper adds one per launch.
launches = 0


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
def _cudnn_without_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv2d_nhwc_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                    padding: str = "SAME") -> torch.Tensor:
    """float32 convolution of NHWC x with HWIO w → float32 NHWC, as
    ``lax.conv_general_dilated`` on float32 operands. cuDNN's TF32 is off
    for the call, so a float32 input gets float32 products on the card too.
    The NCHW tensors are views of the NHWC ones (channels-last), not copies."""
    kh, kw = w.shape[0], w.shape[1]
    xp = pad_nhwc(x.float(), kh, kw, stride, padding)
    with _cudnn_without_tf32():
        y = F.conv2d(xp.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), stride=stride)
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
    dtype, as the reference casts it. CPU tensors take the plain version."""
    global launches
    if x.device.type == "cpu":
        return conv2d_direct_plain(x, w, bias, scale, relu, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_direct runs on cuda or cpu, not {x.device}")
    _check(x, w)
    if (out_dtype or x.dtype) != x.dtype:
        raise TypeError(f"conv2d_direct writes x's dtype {x.dtype}, not {out_dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("conv2d_direct needs a contiguous NHWC x")
    B, H, W, C = x.shape
    kh, kw, _, N = w.shape
    w = w.to(x.dtype).contiguous()  # [kh*kw*C, N] as it lies
    scale, bias = epilogue_vectors(scale, bias, N, x.device)
    out = torch.empty(B, H, W, N, dtype=x.dtype, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sgg_conv_direct(
            DTYPE_CODES[x.dtype], int(bool(relu)), B, H, W, C, kh, kw, N,
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), int(C % 16 == 0 and aligned(x)),
            int(N % 8 == 0 and aligned(w)), stream,
        )
    if err != 0:
        raise RuntimeError(f"conv2d_direct kernel launch failed: CUDA error {err}")
    launches += 1
    return out
