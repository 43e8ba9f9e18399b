"""Mixture-of-Experts MLP on one device, from ``sgg/models/moe.py``.

A top-k-routed feed-forward layer that replaces the dense MLP inside the
ViT's transformer blocks (``model.moe_experts > 0``). Routing is dense
algebra over static shapes, as in the reference (GShard/Switch dispatch):
a float32 [G, S, E, C] combine tensor built from one-hots, no sort.

- :func:`moe_routing`: iterative top-k (argmax, mask, repeat; a tie keeps
  the first index, as ``jnp.argmax``), gates taken from the original
  probabilities and renormalized over the kept experts, positional capacity
  by ``cumsum`` (tokens claim an expert's slots in sequence order, the
  k = 0 choices before the k = 1 choices; a token past C is dropped), and
  the Switch load-balance term E·Σ_e f_e·P_e (f_e: the share of tokens whose
  top-1 choice is e; P_e: the mean router probability).
- :func:`moe_forward`: router in float32, dispatch, the experts' tanh-GELU
  MLP (``jax.nn.gelu``'s default tanh approximation, op by op as
  ``sgg_torch.models.layers.gelu``) and the combine, in the input's dtype.

:class:`MoEMLP` is the module face: float32 parameters ``router`` [M, E],
``wi`` [E, M, H] and ``wo`` [E, H, M] (the flax names and layouts), cast to
the compute dtype at the call; its forward returns (y, aux). With its
``ep_mesh`` set (a mesh with an 'expert' axis) the layer runs expert parallel
(:func:`sgg_torch.dist.expert_parallel.moe_forward_ep`): its ``wi`` and ``wo``
are then this rank's experts. ``sgg_torch.dist.sharding.place_state`` alone
sets it, when it leaves the layer this rank's experts; the names and layouts
stay the global ones, so that one checkpoint serves with or without EP.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from sgg_torch.models.layers import gelu
from sgg_torch.models.resnet import he_normal


class MoEDims(NamedTuple):
    num_experts: int
    top_k: int
    capacity: int


def moe_capacity(num_experts: int, top_k: int, seq_len: int, capacity_factor: float) -> int:
    """Static per-expert per-group slot count."""
    return max(1, math.ceil(top_k * seq_len * capacity_factor / num_experts))


def moe_routing(router_logits: torch.Tensor, top_k: int, capacity: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Router logits [G, S, E] → (combine [G, S, E, C] float32, aux float32).
    ``dispatch`` is ``combine > 0``; callers derive it."""
    G, S, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)

    masks, gates = [], []
    p = probs
    for _ in range(top_k):
        oh = F.one_hot(torch.argmax(p, dim=-1), E).float()  # [G, S, E]
        masks.append(oh)
        gates.append((probs * oh).sum(-1))  # the gate from the original probs
        p = p * (1.0 - oh)

    denom = torch.clamp_min(sum(gates), 1e-9)
    combine = torch.zeros((G, S, E, capacity), dtype=torch.float32, device=probs.device)
    used = torch.zeros((G, E), dtype=torch.float32, device=probs.device)
    for oh, gate in zip(masks, gates):
        # The slot each token would take in its expert's buffer.
        pos = torch.cumsum(oh, dim=1) - oh + used[:, None, :]
        keep = oh * (pos < capacity)
        slot = F.one_hot((pos * keep).long(), capacity).float()
        combine = combine + (gate / denom)[..., None, None] * (keep[..., None] * slot)
        used = used + keep.sum(dim=1)

    f = masks[0].mean(dim=(0, 1))  # top-1 token share per expert
    P = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f * P)
    return combine, aux


def moe_expert_ffn(wi: torch.Tensor, wo: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's GELU MLP over its dispatched buffers: wi [E, M, H],
    wo [E, H, M], xe [E, G, C, M] → [E, G, C, M]."""
    h = gelu(torch.einsum("egcm,emh->egch", xe, wi))
    return torch.einsum("egch,ehm->egcm", h, wo)


def moe_forward(params: dict, x: torch.Tensor, top_k: int, capacity: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One MoE layer on x [G, S, M] → (y [G, S, M] in x's dtype, aux).
    ``params``: ``router`` [M, E], ``wi`` [E, M, H], ``wo`` [E, H, M]."""
    dtype = x.dtype
    logits = torch.einsum("gsm,me->gse", x.float(), params["router"].float())
    combine, aux = moe_routing(logits, top_k, capacity)
    dispatch = (combine > 0).to(dtype)
    xe = torch.einsum("gsec,gsm->egcm", dispatch, x)
    ye = moe_expert_ffn(params["wi"].to(dtype), params["wo"].to(dtype), xe)
    y = torch.einsum("gsec,egcm->gsm", combine.to(dtype), ye)
    return y.to(dtype), aux


class MoEMLP(nn.Module):
    """Drop-in MoE replacement for a transformer block's dense MLP:
    x [G, S, M] → (y [G, S, M], aux), capacity factor 1.25."""

    def __init__(self, embed_dim: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        M, H = embed_dim, embed_dim * mlp_ratio
        self.num_experts, self.top_k, self.capacity_factor = num_experts, top_k, capacity_factor
        self.dtype, self.ep_mesh = dtype, None  # set by place_state under EP
        self.router = nn.Parameter(0.02 * torch.randn(M, num_experts))
        self.wi = nn.Parameter(he_normal((num_experts, M, H)))
        self.wo = nn.Parameter(he_normal((num_experts, H, M)))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cap = moe_capacity(self.num_experts, self.top_k, x.shape[1], self.capacity_factor)
        dt = self.dtype
        params = {"router": self.router.to(dt), "wi": self.wi.to(dt), "wo": self.wo.to(dt)}
        if self.ep_mesh is not None:
            from sgg_torch.dist.expert_parallel import moe_forward_ep

            return moe_forward_ep(params, x.to(dt), self.ep_mesh, self.top_k, cap)
        return moe_forward(params, x.to(dt), self.top_k, cap)
