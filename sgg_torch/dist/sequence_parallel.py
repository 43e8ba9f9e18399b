"""Sequence-parallel attention over the ViT's patch axis: ring (context
parallel) and Ulysses, from ``sgg/dist/sequence_parallel.py``.

Both act on this rank's shard of the sequence, ``[B, H, S/n, D]``, over the
process group of one mesh axis (n ranks):

  - **ring** (:func:`ring_flash_attention`): the q shard stays; k and v
    travel round the ring (:func:`~sgg_torch.dist.multihost.shift_tensors`,
    rank i to rank i + 1), and each hop's partial attention comes from the
    flash kernel with its log-sum-exp. Each partial o is rounded to q's dtype,
    as the kernel stores it, and the partials merge in float32 by the
    online-softmax rule (:func:`_merge`), so the result is full attention.
    The backward is a second, reverse ring: each hop runs the flash backward
    kernels (dq, then dk/dv) for the visiting k/v shard against the global
    lse and o, and the (k, v, dk, dv) bundle moves on, so that after n hops
    every shard is home with the gradient from every rank (the last hop
    carries dk and dv alone: k and v would only come back to where they
    are); dq, dk and dv sum in float32. Differentiable once, as the
    reference's ``custom_vjp``.
  - **Ulysses** (:func:`ulysses_attention`): an all-to-all re-slices
    sequence to heads, each rank runs full-sequence flash attention
    (:func:`~sgg_torch.kernels.flash_attention.flash_attention`, whose
    backward is the flash backward) on H/n heads, and the inverse all-to-all
    re-slices heads to sequence. Needs H divisible by n.

:func:`make_sp_attention` gives a (q, k, v) → o on global ``[B, H, S, D]``
tensors for the ViT's ``attn_fn``, as the reference's ``shard_map`` boundary
does: it takes this rank's S/n rows, runs the mode and all-gathers the rows
(``multihost.split_many`` and ``all_gather``, whose gradients are each
other's, dq, dk and dv gathered in one bucket), so everything outside the
attention stays replicated over the axis.
:func:`sp_encoder` installs it in an encoder's attention layers for a block.
On CUDA tensors every attention launches the CUDA flash kernels; on CPU
tensors their plain versions.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd.function import once_differentiable

from sgg_torch.dist import multihost as mh
from sgg_torch.kernels.flash_attention import flash_attention, flash_attention_with_lse
from sgg_torch.kernels.flash_attention_bwd import flash_attention_bwd

def _merge(o1, lse1, o2, lse2):
    """Two attention partials combined by the online-softmax rule, in
    float32 → (o, lse)."""
    lse = torch.logaddexp(lse1, lse2)  # [B, H, S]
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    return o1.float() * w1 + o2.float() * w2, lse


class RingFlashAttention(torch.autograd.Function):
    """The ring's forward and its reverse-ring backward (``_ring_fa_fwd``
    and ``_ring_fa_bwd`` of the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        n = mh.group_size(group)
        o, lse = flash_attention_with_lse(q, k, v, scale)
        o = o.float()
        k_cur, v_cur = k, v
        for _ in range(n - 1):
            k_cur, v_cur = mh.shift_tensors([k_cur, v_cur], group)
            o_i, lse_i = flash_attention_with_lse(q, k_cur, v_cur, scale)
            o, lse = _merge(o, lse, o_i, lse_i)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.scale = group, scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n = mh.group_size(group)
        g = g.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for hop in range(n):
            dq_i, dk_i, dv_i = flash_attention_bwd(q, k_cur, v_cur, o, lse, g, scale)
            dq += dq_i.float()
            dk_cur += dk_i.float()
            dv_cur += dv_i.float()
            if hop < n - 1:  # the bundle moves on
                k_cur, v_cur, dk_cur, dv_cur = mh.shift_tensors([k_cur, v_cur, dk_cur, dv_cur],
                                                                group)
            elif n > 1:  # the n-th rotation brings dk and dv home (k and v are there)
                dk_cur, dv_cur = mh.shift_tensors([dk_cur, dv_cur], group)
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None, None


def ring_flash_attention(q, k, v, group, scale: float | None = None) -> torch.Tensor:
    """Attention of this rank's q shard ``[B, H, S/n, D]`` over the whole
    sequence, its k and v shards riding the ring of ``group``; differentiable
    once. ``scale`` defaults to D^-0.5."""
    s = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return RingFlashAttention.apply(q, k, v, group, s)


def ulysses_attention(q, k, v, group, scale: float | None = None) -> torch.Tensor:
    """Sequence to heads (all-to-all), full-sequence flash attention on H/n
    heads, heads to sequence; this rank's shard ``[B, H, S/n, D]`` in and
    out."""
    n, H = mh.group_size(group), q.shape[1]
    if H % n:
        raise ValueError(f"ulysses needs heads ({H}) divisible by axis size ({n})")

    def to_seq(t):  # [B, H, S/n, D] → [B, H/n, S, D]
        return mh.all_to_all(t, group, split_dim=1, concat_dim=2)

    def to_heads(t):  # the inverse
        return mh.all_to_all(t, group, split_dim=2, concat_dim=1)

    return to_heads(flash_attention(to_seq(q), to_seq(k), to_seq(v), scale))


def make_sp_attention(mesh, mode: str = "ring", seq_axis: str = "data",
                      scale: float | None = None):
    """(q, k, v) → o on global ``[B, H, S, D]`` tensors, S split over mesh
    axis ``seq_axis``: this rank's S/n rows through ``mode`` ('ring' or
    'ulysses'), the rows all-gathered. Every rank of the axis calls it
    alike."""
    fns = {"ring": ring_flash_attention, "ulysses": ulysses_attention}
    if mode not in fns:
        raise ValueError(f"unknown sp_mode {mode!r} (expected one of {', '.join(fns)})")
    fn, group = fns[mode], mesh.axis_group(seq_axis)
    n = mh.group_size(group)

    def attend(q, k, v):
        if q.shape[2] % n:
            raise ValueError(f"sequence length {q.shape[2]} does not split over the {n} ranks "
                             f"of mesh axis {seq_axis!r}")
        local = mh.split_many([q, k, v], group, 2)
        return mh.all_gather(fn(*local, group, scale), group, 2)

    return attend


@contextlib.contextmanager
def sp_encoder(encoder, attn_fn):
    """Within the block, every attention layer of ``encoder`` (each module
    with an ``attn_fn``) attends through ``attn_fn``; their own route after.
    ``attn_fn`` None leaves them as they are."""
    layers = [] if attn_fn is None or encoder is None else [
        m for m in encoder.modules() if hasattr(m, "attn_fn")]
    before = [m.attn_fn for m in layers]
    try:
        for m in layers:
            m.attn_fn = attn_fn
        yield
    finally:
        for m, fn in zip(layers, before):
            m.attn_fn = fn
