"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh axis, from
``sgg/dist/pipeline_parallel.py``.

The stages live on the ranks of one mesh axis (``'model'``), stage s on the
axis's rank s. Every stage works on a different microbatch at each tick of
the skewed schedule (fill, steady state, drain: ``n_micro + n_stages - 1``
ticks), and the activations hop from stage to stage with
:func:`~sgg_torch.dist.multihost.shift_tensors`, rank i to rank i + 1 mod n,
the reference's ``ppermute``. The stage body is shape- and dtype-preserving
(a block stack, the usual case). The parameters come stacked
``[n_stages, ...]`` and each rank takes its own stage's out of the stack.

:func:`pipeline_vit_features` stages the ViT's block stack between its
``embed`` and ``final``, which every rank runs. With a seq axis, each seq
rank carries ``S/n_seq`` patch rows of every microbatch and the blocks'
attention is the ring or Ulysses over the seq group
(:mod:`sgg_torch.dist.sequence_parallel`), so the hops move only the local
slice, as the reference's docstring has it (``sgg/dist/pipeline_parallel.py:
115-121``; its ``pipeline_vit_features`` does not pass ``seq_axis`` on, and
every seq device there holds all S: ROADMAP's recorded divergences).

Forward only: the reference's one caller, the frozen encoder of the gspmd
step, stops the gradient at the pipeline (``train.train_encoder`` with
``model.pp_microbatches`` is refused), and here the hops carry none.
"""

from __future__ import annotations

from typing import Callable

import torch

from sgg_torch.dist import multihost as mh
from sgg_torch.dist.sequence_parallel import ring_flash_attention, sp_encoder, ulysses_attention


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, mesh,
                   axis_name: str = "model", num_microbatches: int | None = None,
                   batch_axis: str | None = None, seq_axis: str | None = None) -> torch.Tensor:
    """``stage_{n-1}(… stage_0(x))`` pipelined over the ranks of mesh axis
    ``axis_name``; every rank of the axis calls it alike and gets the result.

    ``stage_fn(stage_params, act [mb, ...]) → act`` of the same shape and
    dtype; ``stacked_params``: a tree (dicts, lists) of tensors whose leading
    dim is the stage. ``x``: this rank's shard, ``[B_local, ...]``: its rows
    of the batch that ``batch_axis`` splits (the whole batch without one),
    the whole of dim 1; split into ``num_microbatches`` (default: one per
    stage) contiguous microbatches of its rows. With ``seq_axis`` each rank
    of that axis carries its ``1/n_seq`` of dim 1 (the ViT's patch rows)
    through the stages and the slices are gathered at the end; ``stage_fn``
    must then be sequence parallel itself. Returns the result in x's layout.

    A stage computes only on the ticks where it holds a microbatch
    (``0 <= t - stage < n_micro``): ``n_micro`` calls of ``stage_fn`` on each
    rank, where the reference computes every tick and discards the bubble's.
    Every rank posts the same hop at every tick but the last (a stage in its
    bubble sends zeros), so that the ranks of the axis stay in lock-step.
    The last stage's outputs reach the other stages by a broadcast, where
    the reference sums the one-hot stage's; a sum with zeros is exact, so
    the two give the same bits."""
    group = mesh.axis_group(axis_name)
    n_stages = mesh.shape[axis_name]
    n_micro = num_microbatches or n_stages
    B = x.shape[0] * (mesh.shape[batch_axis] if batch_axis else 1)  # the global batch
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible into {n_micro} microbatches")
    mb = B // n_micro
    if batch_axis and mb % mesh.shape[batch_axis]:
        raise ValueError(
            f"microbatch size {mb} (batch {B} / {n_micro} microbatches) must be divisible by "
            f"mesh axis {batch_axis!r} of size {mesh.shape[batch_axis]} — lower "
            "num_microbatches or raise the batch")
    seq_group = None
    if seq_axis:
        if x.shape[1] % mesh.shape[seq_axis]:
            raise ValueError(f"sequence dim {x.shape[1]} not divisible by mesh axis "
                             f"{seq_axis!r} of size {mesh.shape[seq_axis]}")
        seq_group = mesh.axis_group(seq_axis)
        x = mh.slice_of(x, seq_group, 1)
    stage = 0 if group is None else torch.distributed.get_rank(group)
    last = n_stages - 1
    with torch.no_grad():
        local = _tree_map(lambda p: p[stage], stacked_params)
        mbs = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:]).unbind(0)
        out, carry = [None] * n_micro, None
        ticks = n_micro + n_stages - 1
        for t in range(ticks):
            i = t - stage
            y = None
            if 0 <= i < n_micro:
                y = stage_fn(local, mbs[i] if stage == 0 else carry)
                if stage == last:
                    out[i] = y
            if t < ticks - 1:
                (carry,) = mh.shift_tensors([torch.zeros_like(mbs[0]) if y is None else y], group)
        full = torch.cat(out, 0) if stage == last else torch.empty_like(x)
        full = mh.broadcast_tensor(full, group, last)
        return full if seq_group is None else mh.gather_tensor(full, seq_group, 1)


def stack_layer_params(params: dict, prefix: str, num_layers: int, n_stages: int) -> dict:
    """``{prefix}{i}.<key>`` entries of a state_dict (layers 0..num_layers-1)
    → ``{<key>: [n_stages, num_layers / n_stages, ...]}``, layer i at stage
    ``i // (num_layers / n_stages)``."""
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} layers not divisible into {n_stages} stages")
    head = f"{prefix}0."
    keys = [k[len(head):] for k in params if k.startswith(head)]
    bps = num_layers // n_stages
    return {k: torch.stack([params[f"{prefix}{i}.{k}"] for i in range(num_layers)])
            .reshape(n_stages, bps, *params[head + k].shape) for k in keys}


def pipeline_vit_features(encoder, x: torch.Tensor, mesh, axis_name: str = "model",
                          num_microbatches: int | None = None, batch_axis: str | None = None,
                          seq_axis: str | None = None, sp_mode: str = "ring") -> torch.Tensor:
    """The ViT's features of normalized images ``x`` (this rank's rows) with
    its block stack GPipe-pipelined over ``axis_name``: ``embed`` and
    ``final`` on every rank, the ``num_layers`` blocks in
    ``mesh.shape[axis_name]`` stages of L/n each (:func:`pipeline_apply`),
    each rank running its own stage's block modules in place; the stacked
    "parameters" are the blocks' indices. The blocks run their own attention
    route (the CUDA flash kernel on a CUDA tensor with ``use_pallas``, else
    the plain one); with ``seq_axis`` each seq rank carries its S/n_seq patch
    rows and the attention is the ring or Ulysses (``sp_mode``) over the seq
    group, on the flash kernels on CUDA tensors. No gradient."""
    n_stages = mesh.shape[axis_name]
    L = len(encoder.blocks)
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible into {n_stages} stages")
    attn = None
    if seq_axis is not None:
        raw = {"ring": ring_flash_attention, "ulysses": ulysses_attention}[sp_mode or "ring"]
        seq_group = mesh.axis_group(seq_axis)

        def attn(q, k, v):
            return raw(q, k, v, seq_group)

    def stage_fn(blocks, act):
        for i in blocks.tolist():
            act = getattr(encoder, encoder.blocks[i])(act)
        return act

    with torch.no_grad(), sp_encoder(encoder, attn):
        emb = encoder.embed(x)
        out = pipeline_apply(stage_fn, torch.arange(L).reshape(n_stages, L // n_stages), emb,
                             mesh, axis_name=axis_name, num_microbatches=num_microbatches,
                             batch_axis=batch_axis, seq_axis=seq_axis)
        return encoder.final(out)
