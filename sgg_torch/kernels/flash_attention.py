"""Flash attention: the CUDA forward kernel, its plain PyTorch version, its
autograd Function, the unfused reference and the router.

Port of ``sgg/kernels/flash_attention.py``. ``flash_attention(q, k, v,
scale)`` computes ``softmax(q·kᵀ·scale)·v`` over ``[B, H, S, D]`` tensors in
one launch of ``csrc/flash_attention.cu`` without storing the S × S scores,
with the arithmetic of the Pallas kernel ``_fa_kernel``: q·scale rounded to q's dtype,
float32 scores from the stored-type operands, a float32 softmax, P·V with p
in float32 and v widened to float32, and one cast at the end.
``flash_attention_with_lse`` also returns the per-row log-sum-exp ``[B, H, S]``
float32 that the backward and ring attention need.

Under grad mode, with an input that needs a gradient, ``flash_attention`` runs
through :class:`FlashAttention`, the counterpart of the reference's
``custom_vjp``: the forward also computes lse and saves (q, k, v, o, lse), the
backward is ``flash_attention_bwd`` (the CUDA dq and dk/dv kernels) and is
differentiable once only. Otherwise nothing is saved and no lse is computed.

On a CUDA tensor the wrappers launch the kernel or raise; on a CPU tensor they
run :func:`flash_attention_plain`, the same arithmetic in PyTorch.
:func:`attention_reference` is the reference's unfused route (``'xla'``).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from sgg_torch.kernels import build
from sgg_torch.kernels.flash_attention_bwd import flash_attention_bwd

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process; the wrapper adds one per launch.
launches = 0


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None,
    return_lse: bool = False,
):
    """The kernel's arithmetic in plain PyTorch → o [B,H,S,D] in q's dtype
    (and lse [B,H,S] float32 when ``return_lse``)."""
    s_ = torch.tensor(_scale(q, scale), dtype=q.dtype, device=q.device)
    qs = q * s_  # rounded to q's dtype, as the Pallas wrapper folds it in
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (torch.matmul(p, v.float()) / l).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).squeeze(-1)
    return o


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None,
) -> torch.Tensor:
    """Unfused reference: softmax(q·kᵀ·scale)·v in float32, cast to q's
    dtype (``sgg``'s ``attention_reference``, its ``'xla'`` route)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * _scale(q, scale), dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"flash_attention needs [B, H, S, D] tensors, got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not {q.dtype}")


def _launch(q, k, v, scale, return_lse):
    global launches
    B, H, S, D = q.shape
    if D % 16 != 0 or D > 128:
        raise ValueError(f"flash_attention needs a head width D that is a multiple of 16 "
                         f"and at most 128, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device) if return_lse else None
    # The scale rounded to the compute dtype, as the Pallas wrapper casts it.
    s_ = torch.tensor(_scale(q, scale), dtype=q.dtype).item()
    lib = build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sgg_flash_attention(
            _DTYPE_CODES[q.dtype], B * H, S, D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), None if lse is None else lse.data_ptr(), s_, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return (o, lse) if return_lse else o


def _forward(q, k, v, scale, return_lse):
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, scale, return_lse)


class FlashAttention(torch.autograd.Function):
    """o = softmax(q·kᵀ·scale)·v with the flash backward (``_fa_fwd`` and
    ``_fa_bwd`` of the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _forward(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None,
) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v → [B, H, S, D] in q's dtype; scale defaults to
    D^-0.5. CPU tensors take :func:`flash_attention_plain` (and
    :func:`flash_attention_bwd_plain` for the gradient)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale, return_lse=False)


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """As :func:`flash_attention`, also returning the per-row log-sum-exp
    [B, H, S] float32 of the scaled scores. Forward only: on a CUDA tensor
    that needs a gradient it raises (:func:`flash_attention` carries the
    backward)."""
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        raise NotImplementedError(
            "flash_attention_with_lse is forward only; flash_attention carries the backward")
    return _forward(q, k, v, scale, return_lse=True)


def attention(q, k, v, scale=None, impl: str = "auto") -> torch.Tensor:
    """Routed attention: ``impl`` = 'flash' | 'xla' | 'auto'.

    'flash' is :func:`flash_attention` (the CUDA kernel on a CUDA tensor, its
    plain version on the CPU); 'xla' is :func:`attention_reference`. 'auto'
    takes 'flash' at every sequence length. That default is not yet measured
    on the H100: the reference's S >= 512 threshold was measured on a TPU
    v5e and does not carry over.
    """
    if impl == "auto":
        impl = "flash"
    if impl == "flash":
        return flash_attention(q, k, v, scale)
    if impl == "xla":
        return attention_reference(q, k, v, scale)
    raise ValueError(f"unknown attention impl {impl!r} (auto, flash or xla)")
