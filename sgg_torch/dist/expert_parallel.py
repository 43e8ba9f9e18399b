"""Expert parallelism: a MoE layer over the 'expert' mesh axis, from
``sgg/dist/expert_parallel.py``.

The layout is the reference's (GShard):
  - tokens: the ranks of one data coordinate hold the same rows, and each
    rank of its expert group takes its ``1/n_e`` of the token groups, so
    that together the groups lie over ('data', 'expert') as the reference's
    ``P(('data', 'expert'))``: no rank routes a group that another routes;
  - experts: ``wi`` and ``wo`` split dim 0 (the expert) over 'expert';
  - router: replicated (it is small).

Each rank routes its groups in float32, builds the dispatched buffers
``[E, G_l, C, M]``, and one tiled all-to-all over the expert group in each
direction (:func:`~sgg_torch.dist.multihost.all_to_all`, whose gradient is
the inverse all-to-all) brings every group's tokens to the rank that holds
their expert and the outputs back. The groups are then all-gathered over
the expert group, so that everything outside the layer stays replicated
over the axis.

Gradients follow the tensor-parallel convention of
:mod:`sgg_torch.dist.multihost`: an expert's gradient on its rank comes from
every token of the data coordinate (the all-to-all brings them all), so it
is reduced over 'data' alone; the router enters through ``copy_to``, whose
gradient, a partial sum over this rank's groups, is summed over the expert
group, as the reference's transpose sums it over every device.
"""

from __future__ import annotations

import torch

from sgg_torch.dist import multihost as mh
from sgg_torch.dist.mesh import EXPERT_AXIS
from sgg_torch.models.moe import moe_expert_ffn, moe_routing


class _DataMean(torch.autograd.Function):
    """The mean over the data group of a per-rank scalar, whose gradient
    passes to this rank's own as it is: each rank's loss holds the global
    value, and the step's mean of the ranks' gradients over 'data' then
    gives the global value's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return mh.pmean([x], group)[0] if group is not None else x.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def moe_forward_ep(params: dict, x: torch.Tensor, mesh, top_k: int, capacity: int,
                   expert_axis: str = EXPERT_AXIS) -> tuple[torch.Tensor, torch.Tensor]:
    """One MoE layer over the expert axis of ``mesh`` → (y [G, S, M] in x's
    dtype, aux).

    ``x``: this data coordinate's groups ``[G, S, M]``, the same on every
    rank of the expert group. ``params``: ``router`` [M, E]; ``wi`` [E, M, H]
    and ``wo`` [E, H, M], either whole (this rank takes its experts with
    :func:`~sgg_torch.dist.multihost.split`, whose gradient all-gathers) or
    this rank's ``E/n_e`` experts already, as a placed state holds them.
    ``aux``: the reference's expert-parallel load-balance term, the mean of
    the ranks' terms (each of its own groups) over 'expert' and 'data'
    (not the whole batch's term: ``tests/dist/test_expert_parallel.py``
    leaves it out of its parity for that); its gradient is this data
    coordinate's part, for the step's mean over 'data'. Every rank of the
    mesh calls it alike."""
    group = mesh.axis_group(expert_axis)
    n_e = mh.group_size(group)
    E = params["router"].shape[1]
    wi, wo = params["wi"], params["wo"]
    if n_e > 1 and wi.shape[0] * n_e == E:
        pass  # this rank's experts already
    elif wi.shape[0] % n_e:
        raise ValueError(f"num_experts {wi.shape[0]} not divisible by '{expert_axis}' axis "
                         f"size {n_e}")
    elif wi.shape[0] != E:
        raise ValueError(f"wi holds {wi.shape[0]} experts and the router {E}")
    else:  # whole: this rank's experts
        wi, wo = mh.split(wi, group, 0), mh.split(wo, group, 0)
    G = x.shape[0]
    if G % n_e:
        raise ValueError(f"{G} token groups on this rank not divisible by '{expert_axis}' "
                         f"axis size {n_e}")
    dtype = x.dtype
    x_l = mh.split(x, group, 0)  # [G/n_e, S, M]
    router = mh.copy_to(params["router"], group)
    logits = torch.einsum("gsm,me->gse", x_l.float(), router.float())
    combine, aux = moe_routing(logits, top_k, capacity)
    dispatch = (combine > 0).to(dtype)
    xe = torch.einsum("gsec,gsm->egcm", dispatch, x_l)  # [E, G_l, C, M]
    # Each rank keeps its experts' slice of every peer's tokens:
    # [E, G_l, C, M] → [E/n_e, G_l·n_e, C, M].
    xg = mh.all_to_all(xe, group, split_dim=0, concat_dim=1)
    yg = moe_expert_ffn(wi.to(dtype), wo.to(dtype), xg)
    ye = mh.all_to_all(yg, group, split_dim=1, concat_dim=0)  # back to the token owners
    y = torch.einsum("gsec,egcm->gsm", combine.to(dtype), ye)
    aux = mh.all_reduce(aux, group) * (1.0 / n_e)
    aux = _DataMean.apply(aux, mesh.group)
    return mh.all_gather(y.to(dtype), group, 0), aux
