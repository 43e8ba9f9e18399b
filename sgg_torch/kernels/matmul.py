"""Fused matmul with a scale, bias and ReLU epilogue: the CUDA kernel and its
plain PyTorch version.

Port of ``sgg/kernels/matmul.py``. ``fused_matmul(a, b, bias, scale, relu,
out_dtype)`` computes ``relu(scale * (a @ b) + bias)`` in one launch of
``csrc/fused_matmul.cu``: the sum is float32, scale and bias are float32, the
epilogue runs once on the float32 sums, then one cast to ``out_dtype``. It is
the engine of the 1x1 convolutions and of the im2col convolution route
(``sgg_torch.kernels.conv``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs :func:`fused_matmul_plain`, the same arithmetic in PyTorch.
"""

from __future__ import annotations

import torch

from sgg_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process; the wrapper adds one per launch.
launches = 0


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


def aligned(t: torch.Tensor) -> bool:
    """Whether the tensor's storage starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0


def fused_matmul(
    a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None, relu: bool = False, out_dtype=None,
) -> torch.Tensor:
    """relu(scale * (a @ b) + bias) → [M, N] in ``out_dtype`` (default a's).

    ``a`` [M, K] and ``b`` [K, N] share a dtype, float32 or bfloat16; the
    output is that dtype or float32. CPU tensors take the plain version."""
    global launches
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return fused_matmul_plain(a, b, bias, scale, relu, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"fused_matmul runs on cuda or cpu, not {a.device}")
    _check_operands(a, b)
    if out_dtype not in (a.dtype, torch.float32):
        raise TypeError(f"fused_matmul writes {a.dtype} or float32, not {out_dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("fused_matmul needs contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    scale, bias = epilogue_vectors(scale, bias, N, a.device)
    out = torch.empty(M, N, dtype=out_dtype, device=a.device)
    lib = build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sgg_fused_matmul(
            DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype], int(bool(relu)), M, N, K,
            a.data_ptr(), b.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), int(K % 16 == 0 and aligned(a)),
            int(N % 8 == 0 and aligned(b)), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_matmul kernel launch failed: CUDA error {err}")
    launches += 1
    return out
