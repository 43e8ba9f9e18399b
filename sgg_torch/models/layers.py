"""Dense-layer helpers that follow flax ``nn.Dense``: float32 parameters,
cast to the compute dtype at the call, and flax's initializers."""

from __future__ import annotations

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
