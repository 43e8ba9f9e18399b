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


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0, top_p=None) -> torch.Tensor:
    """Top-k, then nucleus (top-p), filtering of the tempered logits for
    sampling: ``top_k`` > 0 keeps the k highest per row (ties with the k-th
    kept); ``top_p`` in (0, 1] keeps the smallest set of tokens whose
    cumulative probability reaches p (the most likely token always survives).
    Filtered tokens get -1e9, the step mask's value."""
    neg = torch.full((), -1e9, dtype=logits.dtype, device=logits.device)
    if top_k:
        kth = torch.sort(logits, dim=-1).values[..., -int(top_k), None]
        logits = torch.where(logits >= kth, logits, neg)
    if top_p is not None:
        sorted_desc = -torch.sort(-logits, dim=-1).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum_before = torch.cumsum(probs, dim=-1) - probs
        keep = cum_before < torch.full((), top_p, dtype=logits.dtype, device=logits.device)
        inf = torch.full((), float("inf"), dtype=logits.dtype, device=logits.device)
        thresh = torch.where(keep, sorted_desc, inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= thresh, logits, neg)
    return logits
