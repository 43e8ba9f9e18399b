"""Layers that follow flax's: ``nn.Dense`` (float32 parameters cast to the
compute dtype at the call), ``nn.LayerNorm``, ``nn.gelu``, ``nn.softmax``,
``nn.leaky_relu``, and flax's initializers."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ kernel + bias`` in ``dtype``, as a flax Dense with that dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def init_dense_(layer: nn.Linear) -> nn.Linear:
    """flax's Dense init: lecun-normal kernel (truncated at ±2σ), zero bias."""
    fan_in = layer.weight.shape[1]
    # 0.8796 is the stddev of a unit normal truncated to [-2, 2].
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
    return layer


def lecun_normal(shape: tuple[int, ...]) -> torch.Tensor:
    """flax's default kernel init for a ``[..., in, out]`` kernel: a normal
    truncated at ±2σ with variance 1 / fan_in (all dims but the last)."""
    fan_in = 1
    for d in shape[:-1]:
        fan_in *= d
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)
    return w


class Dense(nn.Module):
    """flax ``nn.Dense`` with its parameter names and layout: ``kernel``
    [in, out] and ``bias`` [out] (none when ``use_bias`` is false), float32,
    cast to the compute dtype at the call. The product is rounded to that
    dtype, then the bias add, as flax's separate ``dot_general`` and ``+``.
    ``dot_fn`` (x, kernel) → product in their dtype replaces ``torch.matmul``,
    as flax's ``dot_general`` argument (the int8 tier passes
    ``sgg_torch.kernels.quant.int8_linear``)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32,
                 use_bias: bool = True, dot_fn=None):
        super().__init__()
        self.dtype, self.dot_fn = dtype, dot_fn or torch.matmul
        self.kernel = nn.Parameter(lecun_normal((in_features, out_features)))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self.dot_fn(x.to(dt), self.kernel.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: eps 1e-6, statistics in
    float32 (variance as E[x²] − E[x]², clipped at 0), ``scale`` and
    ``bias`` applied in float32, one cast to the compute dtype."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((x - mean) * mul + self.bias.float()).to(self.dtype)


def _const(v: float, x: torch.Tensor) -> torch.Tensor:
    """A Python float as JAX combines it with an array: rounded to x's dtype
    (a fill on x's device, no copy from the host)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` op by op in x's dtype: exp(x − max) / its sum, each
    operation rounded to that dtype."""
    u = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return u / u.sum(dim=dim, keepdim=True)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """``jax.nn.leaky_relu``: x where x >= 0, else slope·x with the slope
    rounded to x's dtype."""
    return torch.where(x >= 0, x, x * _const(negative_slope, x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.gelu``, the tanh approximation, op by op in x's dtype
    as ``jax.nn.gelu`` computes it: in bfloat16 every operation rounds, and
    the constants are rounded to the dtype first."""

    def c(v: float) -> torch.Tensor:
        return _const(v, x)

    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))
