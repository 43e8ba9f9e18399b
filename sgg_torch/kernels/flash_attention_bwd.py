"""Flash-attention backward: the CUDA dq and dk/dv kernels and their plain
PyTorch version.

Port of ``sgg/kernels/flash_attention_bwd.py``. ``flash_attention_bwd(q, k,
v, o, lse, do, scale)`` gives (dq, dk, dv) of ``o = softmax(q·kᵀ·scale)·v``
from the forward's saved tensors, recomputing p tile by tile without storing
the S × S scores: ``csrc/flash_attention_bwd.cu`` launches once for dq
(q-stationary, the Pallas ``_dq_kernel``) and once for dk and dv
(kv-stationary, ``_dkv_kernel``). The arithmetic is the Pallas bodies':
q·scale rounded to q's dtype, D = rowsum(do·o) in float32 (computed here by
torch, as XLA fuses it outside the Pallas kernels there), float32 scores and
p = exp(s − lse), dp = do·vᵀ widened, ds = p·(dp − D), then dq = scale·(ds·k),
dk = dsᵀ·q_s and dv = pᵀ·do summed in float32 and cast once. The bf16
kernels run those three products on the tensor cores as three bf16 products
with an exact split of p or ds (``flash_attention.split3``), the same
function.

On a CUDA tensor the wrapper launches the kernels or raises; on a CPU tensor it
runs :func:`flash_attention_bwd_plain`. Ring attention calls it directly, the
autograd ``Function`` of ``flash_attention`` through its backward.
:func:`launch_dq_f32_result` and :func:`launch_dkv_f32_result` are for checks
only: the bf16 kernels' float32 results before the final cast.
"""

from __future__ import annotations

import torch

from sgg_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process; the wrapper adds one per launch of each.
dq_launches = 0
dkv_launches = 0


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def dstat(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(do·o) in float32 → [B, H, S]."""
    return (do.float() * o.float()).sum(dim=-1)


def _p_ds(q, k, v, do, lse, D, scale):
    """(q_s, p, ds) in float32, recomputed from the saved tensors."""
    qs = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)).float()
    p = torch.exp(torch.matmul(qs, k.float().transpose(-1, -2)) - lse[..., None])
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - D[..., None])
    return qs, p, ds


def dq_plain(q, k, v, do, lse, D, scale: float | None = None, cast: bool = True) -> torch.Tensor:
    """The dq kernel's arithmetic in plain PyTorch: scale·(ds·k) (in float32
    before the cast when ``cast`` is False)."""
    s_ = _scale(q, scale)
    _, _, ds = _p_ds(q, k, v, do, lse, D, s_)
    dq = torch.matmul(ds, k.float()) * s_
    return dq.to(q.dtype) if cast else dq


def dkv_plain(q, k, v, do, lse, D, scale: float | None = None, cast: bool = True):
    """The dk/dv kernel's arithmetic in plain PyTorch: (dsᵀ·q_s, pᵀ·do) (in
    float32 before the cast when ``cast`` is False)."""
    qs, p, ds = _p_ds(q, k, v, do, lse, D, _scale(q, scale))
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return (dk.to(k.dtype), dv.to(v.dtype)) if cast else (dk, dv)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float | None = None):
    """The kernels' arithmetic in plain PyTorch → (dq, dk, dv) in the input
    dtypes."""
    D = dstat(o, do)
    return (dq_plain(q, k, v, do, lse, D, scale), *dkv_plain(q, k, v, do, lse, D, scale))


def _check(q, k, v, o, lse, do):
    if q.dim() != 4:
        raise ValueError(f"flash_attention_bwd needs [B, H, S, D] tensors, got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16, not {q.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    for name, t in (("k", k), ("v", v), ("o", o), ("lse", lse), ("do", do)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _kernel_args(q, k, v, do, lse, D, scale):
    """Checks for the kernels → (dtype code, BH, S, D, scale_q, scale)."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash backward kernels run on cuda tensors, not {q.device}")
    B, H, S, Dh = q.shape
    if Dh % 16 != 0 or Dh > 128:
        raise ValueError(f"flash_attention_bwd needs a head width D that is a multiple of 16 "
                         f"and at most 128, got {Dh}")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse), ("D", D)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    s_ = _scale(q, scale)
    # q_s takes the scale rounded to the compute dtype, as the Pallas wrapper
    # casts it; dq is multiplied by its float32 value.
    return _DTYPE_CODES[q.dtype], B * H, S, Dh, torch.tensor(s_, dtype=q.dtype).item(), s_


def launch_dq(q, k, v, do, lse, D, scale: float | None = None) -> torch.Tensor:
    """One launch of the dq kernel on CUDA tensors (D = :func:`dstat`)."""
    global dq_launches
    code, BH, S, Dh, scale_q, s_ = _kernel_args(q, k, v, do, lse, D, scale)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = build.load_library().sgg_flash_attention_bwd_dq(
            code, BH, S, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dq.data_ptr(), scale_q, s_,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd dq kernel launch failed: CUDA error {err}")
    dq_launches += 1
    return dq


def launch_dkv(q, k, v, do, lse, D, scale: float | None = None):
    """One launch of the dk/dv kernel on CUDA tensors → (dk, dv)."""
    global dkv_launches
    code, BH, S, Dh, scale_q, _ = _kernel_args(q, k, v, do, lse, D, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = build.load_library().sgg_flash_attention_bwd_dkv(
            code, BH, S, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dk.data_ptr(), dv.data_ptr(), scale_q,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd dk/dv kernel launch failed: CUDA error {err}")
    dkv_launches += 1
    return dk, dv


def _f32_args(q, k, v, do, lse, D, scale):
    if q.dtype != torch.bfloat16:
        raise ValueError("the f32-result entries take bfloat16 tensors")
    return _kernel_args(q, k, v, do, lse, D, scale)[1:]


def launch_dq_f32_result(q, k, v, do, lse, D, scale: float | None = None) -> torch.Tensor:
    """Check only: the bf16 dq kernel's instance that stores scale·(ds·k) in
    float32 before the cast → [B, H, S, D] float32. Not counted in
    ``dq_launches``; the main path never calls it."""
    BH, S, Dh, scale_q, s_ = _f32_args(q, k, v, do, lse, D, scale)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = build.load_library().sgg_flash_attention_bwd_dq_f32_result(
            BH, S, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dq.data_ptr(), scale_q, s_,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd dq f32-result launch failed: CUDA error {err}")
    return dq


def launch_dkv_f32_result(q, k, v, do, lse, D, scale: float | None = None):
    """Check only: the bf16 dk/dv kernel's instance that stores dk and dv in
    float32 before the cast → (dk, dv) float32. Not counted in
    ``dkv_launches``; the main path never calls it."""
    BH, S, Dh, scale_q, _ = _f32_args(q, k, v, do, lse, D, scale)
    dk, dv = (torch.empty(q.shape, dtype=torch.float32, device=q.device) for _ in range(2))
    with torch.cuda.device(q.device):
        err = build.load_library().sgg_flash_attention_bwd_dkv_f32_result(
            BH, S, Dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dk.data_ptr(), dv.data_ptr(), scale_q,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd dk/dv f32-result launch failed: CUDA error {err}")
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale: float | None = None):
    """(dq, dk, dv) of ``softmax(q·kᵀ·scale)·v`` given its output o, its
    per-row log-sum-exp lse [B, H, S] float32 and the upstream gradient do;
    scale defaults to D^-0.5. CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors one launch of each
    kernel."""
    _check(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    D = dstat(o, do).contiguous()
    return (launch_dq(q, k, v, do, lse, D, scale), *launch_dkv(q, k, v, do, lse, D, scale))
