"""Flash attention: the CUDA forward kernel, its plain PyTorch version, its
autograd Function, the unfused reference and the router.

Port of ``sgg/kernels/flash_attention.py``. ``flash_attention(q, k, v,
scale)`` computes ``softmax(q·kᵀ·scale)·v`` over ``[B, H, S, D]`` tensors in
one launch of ``csrc/flash_attention.cu`` without storing the S × S scores,
with the arithmetic of the Pallas kernel ``_fa_kernel``: q·scale rounded to q's dtype,
float32 scores from the stored-type operands, a float32 softmax, P·V with p
in float32 and v widened to float32, and one cast at the end. The bf16
kernel runs P·V on the tensor cores as three bf16 products of v with an
exact split of p (:func:`split3`), which is the same function.
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
:func:`launch_f32_result` is for checks only: the bf16 kernel's float32
result before its final cast, which the main path never launches.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from sgg_torch.kernels import build
from sgg_torch.kernels.flash_attention_bwd import flash_attention_bwd

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process; the wrapper adds one per launch.
launches = 0

# The check of the bf16 flash kernels' float32 results before the final cast
# (o here; dq, dk, dv in flash_attention_bwd): the relative L2 distance of
# each to its plain version in float32 from the same bf16 inputs
# (:func:`f32_result_error`) must be at most this. It lies between the sound
# kernels' distance and that of a split cut to hi + mid, 2.0e-6 to 2.5e-6
# (PERF.md). A relative L2 distance rather than max |diff| / max: for
# the cut split the first holds steady over seeds, the second wanders
# (tests/test_torch_flash_split.py).
F32_RESULT_TOL = 1e-6


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' exact split of float32 x into three bf16 terms → (hi,
    mid, lo) as bf16 tensors: hi = bf16(x), mid = bf16(x − hi), lo = bf16(x −
    hi − mid), all rounded to nearest, so hi + mid + lo == x for |x| >=
    2^-100 (``csrc/flash_tile.cuh``, ``split3``). For checks only."""
    x = x.float()
    hi = x.bfloat16()
    r = x - hi.float()
    mid = r.bfloat16()
    return hi, mid, (r - mid.float()).bfloat16()


def f32_result_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖₂ / ‖want‖₂, summed in float64."""
    want = want.double()
    return ((got.double() - want).norm() / want.norm()).item()


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None,
    return_lse: bool = False, cast: bool = True,
):
    """The kernel's arithmetic in plain PyTorch → o [B,H,S,D] in q's dtype
    (float32 acc / l before the cast when ``cast`` is False), and lse
    [B,H,S] float32 when ``return_lse``."""
    s_ = torch.tensor(_scale(q, scale), dtype=q.dtype, device=q.device)
    qs = q * s_  # rounded to q's dtype, as the Pallas wrapper folds it in
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / l
    if cast:
        o = o.to(q.dtype)
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


def _kernel_checks(q, k, v):
    D = q.shape[-1]
    if D % 16 != 0 or D > 128:
        raise ValueError(f"flash_attention needs a head width D that is a multiple of 16 "
                         f"and at most 128, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


def _launch(q, k, v, scale, return_lse):
    global launches
    B, H, S, D = q.shape
    _kernel_checks(q, k, v)
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


def launch_f32_result(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Check only: one launch of the bf16 kernel's instance that stores acc / l
    in float32 before the cast, on CUDA tensors → [B, H, S, D] float32. The
    main path never calls it, and it does not count in ``launches``."""
    _check(q, k, v)
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError("launch_f32_result takes bfloat16 CUDA tensors")
    B, H, S, D = q.shape
    _kernel_checks(q, k, v)
    o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    s_ = torch.tensor(_scale(q, scale), dtype=q.dtype).item()
    with torch.cuda.device(q.device):
        err = build.load_library().sgg_flash_attention_f32_result(
            B * H, S, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(), None, s_,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention f32-result kernel launch failed: CUDA error {err}")
    return o32


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
