"""VGG-19 convolutional feature extractor, from ``sgg/models/vgg.py``.

Images run to the conv5_4 map (14 × 14 × 512 at 224 px → 196 regions), with
2 × 2 VALID max pools after blocks 1–4 only. Every conv + ReLU is one
``conv2d_fused`` call: under ``'direct'`` (and ``'auto'``) the 16 convs run on
``conv2d_direct``, under ``'pallas'`` on im2col + ``fused_matmul``.
Activations are NHWC in the compute dtype; kernels (HWIO) are float32
parameters cast to it at the call, biases stay float32.

Parameter names follow the reference weight dict: ``conv1_1`` … ``conv5_4``,
each with ``kernel`` and ``bias`` (the flax names ``conv1_1/kernel`` …).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from sgg_torch.kernels.conv import conv2d_fused, max_pool_nhwc
from sgg_torch.models.resnet import he_normal

# (block, convs-in-block, channels): VGG-19, configuration "E".
_CFG = [(1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512)]

# Mean pixel (BGR order) of the reference preprocessing.
VGG_BGR_MEAN = np.array([103.939, 116.779, 123.68], np.float32)


def conv_names() -> list[str]:
    return [f"conv{block}_{i}" for block, n, _ in _CFG for i in range(1, n + 1)]


class _Conv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(he_normal((3, 3, in_ch, out_ch)))
        self.bias = nn.Parameter(torch.zeros(out_ch))


class VGG19Features(nn.Module):
    """Images [B, H, W, 3] (preprocessed) → conv5_4 features [B, H/16·W/16, 512]."""

    def __init__(self, use_pallas: bool = False, conv_impl: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_pallas, self.conv_impl, self.dtype = use_pallas, conv_impl, dtype
        in_ch = 3
        for block, n_convs, ch in _CFG:
            for i in range(1, n_convs + 1):
                self.add_module(f"conv{block}_{i}", _Conv(in_ch, ch))
                in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for block, n_convs, _ in _CFG:
            for i in range(1, n_convs + 1):
                conv = getattr(self, f"conv{block}_{i}")
                x = conv2d_fused(
                    x, conv.kernel.to(self.dtype), bias=conv.bias, stride=1,
                    padding="SAME", relu=True, use_pallas=self.use_pallas,
                    impl=self.conv_impl,
                )
            if block < 5:  # pools 1–4; conv5 stays at stride 16
                x = max_pool_nhwc(x, 2, 2, "VALID")
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C)


def load_npy_weights(path_or_dict) -> "OrderedDict[str, torch.Tensor]":
    """machrisaa-style ``{'conv1_1': [kernel (3,3,in,out), bias (out,)], …}``
    (an ``.npy`` path or the dict) → :class:`VGG19Features` state_dict."""
    if isinstance(path_or_dict, str):
        raw = np.load(path_or_dict, allow_pickle=True, encoding="latin1").item()
    else:
        raw = path_or_dict
    sd = OrderedDict()
    for name in conv_names():
        kernel, bias = raw[name]
        sd[f"{name}.kernel"] = torch.from_numpy(np.asarray(kernel, np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(bias, np.float32))
    return sd
