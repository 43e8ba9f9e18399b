"""Gumbel noise and Gumbel-softmax, from ``sgg/utils/gumbel.py``.

All noise comes from an explicit ``torch.Generator``. The draws differ from
``jax.random``'s for the same seed, so parity tests hand both packages the
same noise instead.
"""

from __future__ import annotations

import torch

_EPS = 1e-20


def sample_gumbel(
    shape, generator: torch.Generator | None = None,
    device=None, dtype=torch.float32,
) -> torch.Tensor:
    """g = -log(-log u), u uniform in [1e-20, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = (u * (1.0 - _EPS) + _EPS).clamp_min(_EPS)
    return -torch.log(-torch.log(u))


def gumbel_softmax(
    logits: torch.Tensor, gumbel: torch.Tensor, tau: float = 1.0,
    hard: bool = False, dim: int = -1,
) -> torch.Tensor:
    """Sample from Categorical(softmax(logits)) given its Gumbel noise.

    Soft: a point on the simplex. Hard: the one-hot of the argmax (first
    index among ties), with the straight-through gradient of the soft sample.
    """
    y_soft = torch.softmax((logits + gumbel) / tau, dim=dim)
    if not hard:
        return y_soft
    idx = torch.argmax(y_soft, dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, idx, 1.0)
    return y_soft + (y_hard - y_soft).detach()
