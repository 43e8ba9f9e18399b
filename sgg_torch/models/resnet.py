"""ResNet-50 feature extractor with fused conv + BN + ReLU blocks, from
``sgg/models/resnet.py``.

A frozen feature extractor with inference batch-norm, so each BN folds into
its conv's epilogue (``fold_batchnorm``, float32, eps 1e-5) and every
conv + BN (+ ReLU) is one ``conv2d_fused`` call. Under the ``'direct'`` and
``'auto'`` routes the 1x1 convs run on ``fused_matmul`` and the 3x3 stride-1
convs on ``conv2d_direct``; the 7x7 stride-2 stem and the three 3x3 stride-2
convs take the library conv. Activations are NHWC in the compute dtype;
weights are float32 parameters cast to it at the call, scale and bias stay
float32.

Parameter names are the flax module's: ``stem``,
``stage{s}_block{b}.conv{1,2,3}`` and ``.proj``, each with ``kernel`` (HWIO),
``bn_scale``, ``bn_bias``, ``bn_mean`` and ``bn_var``.

Output: the conv5 map, [B, H/32 · W/32, 2048] (7 × 7 = 49 regions at 224 px).
"""

from __future__ import annotations

import torch
from torch import nn

from sgg_torch.kernels.conv import conv2d_fused, fold_batchnorm, max_pool_nhwc

# (blocks, mid_channels) per stage.
_STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]


def he_normal(shape: tuple[int, ...]) -> torch.Tensor:
    """flax ``he_normal`` for an HWIO kernel: a normal truncated at ±2σ with
    variance 2 / fan_in, fan_in = kh · kw · Cin."""
    fan_in = 1
    for d in shape[:-1]:
        fan_in *= d
    # 0.8796 is the stddev of a unit normal truncated to [-2, 2].
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)
    return w


class _ConvBN(nn.Module):
    """conv → folded BN → optional ReLU, as one fused conv call."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1,
                 relu: bool = True, use_pallas: bool = False,
                 conv_impl: str | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.relu = stride, relu
        self.use_pallas, self.conv_impl, self.dtype = use_pallas, conv_impl, dtype
        self.kernel = nn.Parameter(he_normal((kernel, kernel, in_ch, features)))
        self.bn_scale = nn.Parameter(torch.ones(features))
        self.bn_bias = nn.Parameter(torch.zeros(features))
        self.bn_mean = nn.Parameter(torch.zeros(features))
        self.bn_var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = fold_batchnorm(self.bn_scale, self.bn_bias, self.bn_mean, self.bn_var)
        return conv2d_fused(
            x, self.kernel.to(self.dtype), bias=bias, scale=scale, stride=self.stride,
            padding="SAME", relu=self.relu, use_pallas=self.use_pallas, impl=self.conv_impl,
        )


class _Bottleneck(nn.Module):
    def __init__(self, in_ch: int, mid: int, stride: int = 1, project: bool = False,
                 **kw):
        super().__init__()
        self.conv1 = _ConvBN(in_ch, mid, 1, **kw)
        self.conv2 = _ConvBN(mid, mid, 3, stride=stride, **kw)
        self.conv3 = _ConvBN(mid, mid * 4, 1, relu=False, **kw)
        self.proj = (_ConvBN(in_ch, mid * 4, 1, stride=stride, relu=False, **kw)
                     if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.proj is None else self.proj(x)
        return torch.relu(y + residual)  # in the compute dtype, as nn.relu(y + residual)


class ResNet50Features(nn.Module):
    """Images [B, H, W, 3] (normalized) → [B, H/32·W/32, 2048] regions."""

    def __init__(self, use_pallas: bool = False, conv_impl: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(use_pallas=use_pallas, conv_impl=conv_impl, dtype=dtype)
        self.stem = _ConvBN(3, 64, 7, stride=2, **kw)
        in_ch = 64
        self.blocks = []
        for s, (blocks, mid) in enumerate(_STAGES, start=1):
            for b in range(blocks):
                name = f"stage{s}_block{b}"
                self.add_module(name, _Bottleneck(
                    in_ch, mid, stride=2 if (b == 0 and s > 1) else 1,
                    project=(b == 0), **kw))
                self.blocks.append(name)
                in_ch = mid * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.to(self.dtype))
        x = max_pool_nhwc(x, 3, 2, "SAME")
        for name in self.blocks:
            x = getattr(self, name)(x)
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C)
