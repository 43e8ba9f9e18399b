"""Fused conv + folded batch-norm + ReLU: the route from a convolution to a
kernel, from ``sgg/kernels/conv.py``.

Layout: NHWC activations, HWIO weights, as in the reference. ``conv2d_fused``
computes ``relu(scale * conv(x, w) + bias)`` by one of the reference's routes,
which all compute that same function:

- ``'direct'``: stride-1 SAME convs with odd kernels go to the CUDA
  ``conv2d_direct``; other strides and paddings go to ``'xla'``;
- ``'pallas'``: im2col patches, then the CUDA ``fused_matmul``;
- ``'xla'``: the library conv (``F.conv2d`` in float32, cuDNN on the card),
  then the epilogue, as ``conv2d_reference``;
- ``'auto'``: ``'direct'``. The reference routes ``'auto'`` to XLA from TPU
  measurements, which do not carry over; which route is faster on the H100
  is not measured yet, so the port takes its hand-written kernels.

Under ``'direct'`` and ``'pallas'`` a 1x1 conv is a matmul: a stride first
subsamples the input (``x[:, ::s, ::s]``), then ``fused_matmul`` runs on
[B*H*W, Cin] @ [Cin, Cout]. ``'int8'`` is dynamic post-training
quantization (``sgg_torch.kernels.quant.conv2d_int8``, the reference's route
at ``sgg/kernels/conv.py:69-75``): every conv of VGG-19 and ResNet-50, the
7x7 stem, the strided convs and the 1x1 projections included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgg_torch.kernels.conv_direct import conv2d_direct, conv2d_nhwc_f32, pad_nhwc
from sgg_torch.kernels.matmul import epilogue, fused_matmul
from sgg_torch.kernels.quant import conv2d_int8

IMPLS = ("auto", "direct", "pallas", "xla", "int8")


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str):
    """[B,H,W,C] → patches [B*Ho*Wo, kh*kw*C] in the (kh, kw, C) order of a
    reshaped HWIO kernel, and (B, Ho, Wo)."""
    B, C = x.shape[0], x.shape[3]
    xp = pad_nhwc(x, kh, kw, stride, padding)
    Ho = (xp.shape[1] - kh) // stride + 1
    Wo = (xp.shape[2] - kw) // stride + 1
    taps = [
        xp[:, dh : dh + stride * (Ho - 1) + 1 : stride, dw : dw + stride * (Wo - 1) + 1 : stride]
        for dh in range(kh) for dw in range(kw)
    ]
    cols = torch.stack(taps, dim=3)  # [B, Ho, Wo, kh*kw, C]
    return cols.reshape(B * Ho * Wo, kh * kw * C), (B, Ho, Wo)


def conv2d_fused(
    x: torch.Tensor,  # [B, H, W, Cin]
    w: torch.Tensor,  # [kh, kw, Cin, Cout] (HWIO)
    bias: torch.Tensor | None = None,  # [Cout]
    scale: torch.Tensor | None = None,  # [Cout] folded-BN scale
    stride: int = 1,
    padding: str = "SAME",
    relu: bool = True,
    use_pallas: bool = True,
    impl: str | None = None,
) -> torch.Tensor:
    """relu(scale · conv(x, w) + bias) in x's dtype, by route ``impl``
    (None: ``'auto'`` if ``use_pallas`` else ``'xla'``, as the reference)."""
    if impl is None:
        impl = "auto" if use_pallas else "xla"
    if impl not in IMPLS:
        raise ValueError(f"unknown conv impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        impl = "direct"
    if impl == "int8":
        return conv2d_int8(x, w, bias=bias, scale=scale, stride=stride, padding=padding,
                           relu=relu)
    kh, kw, cin, cout = w.shape
    if impl in ("pallas", "direct") and kh == 1 and kw == 1:
        # k = 1 needs no padding under SAME, and its taps sit at 0, s, 2s, …
        if stride != 1:
            x = x[:, ::stride, ::stride, :]
        B, H, W, _ = x.shape
        y = fused_matmul(
            x.reshape(B * H * W, cin).contiguous(),
            w.reshape(cin, cout).to(x.dtype).contiguous(),
            bias=bias, scale=scale, relu=relu, out_dtype=x.dtype,
        )
        return y.reshape(B, H, W, cout)
    if impl == "direct":
        if stride == 1 and padding == "SAME" and kh % 2 == 1 and kw % 2 == 1:
            return conv2d_direct(x.contiguous(), w, bias=bias, scale=scale, relu=relu)
        impl = "xla"  # outside the direct kernel's scope: the dispatcher's route
    if impl == "xla":
        return conv2d_reference(x, w, bias=bias, scale=scale, stride=stride,
                                padding=padding, relu=relu)
    cols, (B, Ho, Wo) = _im2col(x, kh, kw, stride, padding)
    y = fused_matmul(cols, w.reshape(kh * kw * cin, cout).to(x.dtype).contiguous(),
                     bias=bias, scale=scale, relu=relu, out_dtype=x.dtype)
    return y.reshape(B, Ho, Wo, cout)


def conv2d_reference(x, w, bias=None, scale=None, stride=1, padding="SAME", relu=True):
    """The library conv in float32, then the epilogue, cast to x's dtype."""
    y = conv2d_nhwc_f32(x, w, stride, padding)
    return epilogue(y, scale, bias, relu, x.dtype).contiguous()


def fold_batchnorm(gamma, beta, mean, var, conv_bias=None, eps: float = 1e-5):
    """Inference batch-norm folded into the epilogue's (scale, bias), float32:

    BN(conv(x) + b) = gamma·(conv(x) + b − mean)/sqrt(var + eps) + beta
                    = scale·conv(x) + bias
    """
    inv = gamma.float() * torch.rsqrt(var.float() + eps)
    b = beta.float() - mean.float() * inv
    if conv_bias is not None:
        b = b + conv_bias.float() * inv
    return inv, b


def max_pool_nhwc(x: torch.Tensor, window: int, stride: int, padding: str = "VALID"):
    """Max pool of an NHWC tensor as flax ``nn.max_pool``: SAME pads with −inf
    by the asymmetric TensorFlow rule (3x3 stride 2 on 112 pads (0, 1))."""
    xp = pad_nhwc(x, window, window, stride, padding, value=float("-inf"))
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1).contiguous()
