"""Int8 post-training quantization for encoder inference, from
``sgg/kernels/quant.py``.

Dynamic symmetric absmax quantization, with no calibration pass and no stored
scales: a scale is the float32 absmax over its axes, floored at 1e-12, over
127; a value is round-half-to-even(x / scale) clipped to ±127. Weights get
one scale per output channel; activations one per row for a dense layer and
one per tensor for a conv. The product sums int8 values into int32, and a
float32 epilogue scales it back.

- :func:`int8_linear` is the Dense pattern of the reference's
  ``int8_dot_general``: x [..., K] (2-D or 3-D) @ w [K, N] → x's rows times
  w's columns, ``(acc.float() * (row_scale ⊗ col_scale))`` in the output
  dtype; the caller adds the bias after it, as flax's ``Dense`` does
  (``sgg_torch.models.layers.Dense``).
- :func:`conv2d_int8` is ``relu(scale · dequant(conv_s8(x, w)) + bias)`` in
  x's dtype, at any stride, SAME or VALID, any kernel size.

Two routes compute the int32 product, and both sum integers exactly, so they
agree bit for bit:

- ``'plain'``: float64 sums of the int8 values (a float64 matmul, or
  ``F.conv2d`` in float64), exact because K · 127² < 2⁵³ at every shape
  here. It runs on CPU tensors and is the tests' reference.
- ``'int_mm'``: ``torch._int_mm`` (cuBLASLt's s8×s8→s32 on the card). A conv
  goes through int8 im2col (``sgg_torch.kernels.conv._im2col``), a 1x1 conv
  straight to the matmul. On CUDA ``_int_mm`` needs K and N multiples of 8
  and more than 16 rows: the operands are padded with zeros, which add
  nothing, since symmetric quantization maps 0 to 0. It runs on CUDA
  tensors, and in an exported program (``sgg_torch.export``, which traces
  under :func:`forced_route`) on either device.

The reference computes these products with ``lax.dot_general`` and
``lax.conv_general_dilated`` outside any Pallas kernel, so a library product
stands here too; there is no hand-written int8 kernel. If ``_int_mm`` raises
on the card, the error stands: there is no quiet float route.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from sgg_torch.kernels.conv_direct import pad_nhwc

QMAX = 127.0
_MIN_ROWS = 17  # _int_mm on CUDA takes more than 16 rows


def _absmax_scale(x: torch.Tensor, dim) -> torch.Tensor:
    """Symmetric absmax scale over ``dim`` (kept), float32, floored at 1e-12."""
    a = x.float().abs().amax(dim=dim, keepdim=True)
    return torch.clamp(a, min=1e-12) / QMAX


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round-half-to-even(x / scale) clipped to ±127, int8."""
    return torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX).to(torch.int8)


_FORCED: list = []  # the route forced_route sets, innermost last


@contextlib.contextmanager
def forced_route(impl: str):
    """Every int8 product in the block takes ``impl``, whatever its device:
    ``sgg_torch.export`` traces on the CPU with ``'int_mm'``, so that an
    artifact carries cuBLASLt's product to the card."""
    _FORCED.append(impl)
    try:
        yield
    finally:
        _FORCED.pop()


def route(x: torch.Tensor) -> str:
    """The product's route for ``x``: the one :func:`forced_route` sets, else
    ``'int_mm'`` on CUDA and ``'plain'`` elsewhere."""
    if _FORCED:
        return _FORCED[-1]
    return "int_mm" if x.device.type == "cuda" else "plain"


def _pad2(t: torch.Tensor, rows, cols) -> torch.Tensor:
    """t [M, K] with ``rows`` zero rows below and ``cols`` zero columns right."""
    return F.pad(t, (0, cols, 0, rows))


def int8_mm(a: torch.Tensor, b: torch.Tensor, impl: str | None = None) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K, N] → int32 [M, N], exact, by ``impl``
    (``'plain'`` or ``'int_mm'``; None: :func:`route` of a)."""
    impl = impl or route(a)
    if impl == "plain":
        return (a.double() @ b.double()).to(torch.int32)
    if impl != "int_mm":
        raise ValueError(f"unknown int8 route {impl!r} (want 'plain' or 'int_mm')")
    M, K = a.shape
    N = b.shape[1]
    pk, pn = -K % 8, -N % 8
    # A symbolic M (an export with a symbolic batch) takes the rows' pad as a
    # symbolic max, which adds no guard on the batch.
    pm = torch.sym_max(_MIN_ROWS - M, 0) if isinstance(M, torch.SymInt) else \
        max(_MIN_ROWS - M, 0)
    if pk or not isinstance(pm, int) or pm:
        a = _pad2(a, pm, pk)
    if pk or pn:
        b = _pad2(b, pk, pn)
    acc = torch._int_mm(a.contiguous(), b.contiguous())
    if not isinstance(pm, int) or pm or pn:
        acc = acc[:M, :N]
    return acc


def int8_linear(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None = None,
                impl: str | None = None) -> torch.Tensor:
    """x [..., K] @ w [K, N] with both dynamically quantized to int8: one scale
    per row of x (over K) and one per column of w, the int32 product scaled
    by their outer product in float32, cast to ``out_dtype`` (default: the
    promoted dtype of x and w)."""
    out_dtype = out_dtype or torch.promote_types(x.dtype, w.dtype)
    xs = _absmax_scale(x, -1)  # [..., 1]
    ws = _absmax_scale(w, 0)  # [1, N]
    lead, K = x.shape[:-1], x.shape[-1]
    acc = int8_mm(_quantize(x, xs).reshape(-1, K), _quantize(w, ws), impl)
    scale = xs * ws  # [..., N], the reference's ls ⊗ rs, formed before the product
    return (acc.reshape(*lead, -1).float() * scale).to(out_dtype)


def _conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: str,
              impl: str) -> torch.Tensor:
    """int32 conv of int8 NHWC xq with int8 HWIO wq → NHWC."""
    from sgg_torch.kernels.conv import _im2col  # conv imports this module

    kh, kw, cin, cout = wq.shape
    if impl == "plain":
        xp = pad_nhwc(xq.double(), kh, kw, stride, padding)
        y = F.conv2d(xp.permute(0, 3, 1, 2), wq.double().permute(3, 2, 0, 1), stride=stride)
        return y.permute(0, 2, 3, 1).to(torch.int32)
    if kh == 1 and kw == 1:  # a 1x1 conv is a matmul on the subsampled input
        if stride != 1:
            xq = xq[:, ::stride, ::stride, :]
        B, H, W, _ = xq.shape
        acc = int8_mm(xq.reshape(B * H * W, cin), wq.reshape(cin, cout), impl)
        return acc.reshape(B, H, W, cout)
    cols, (B, Ho, Wo) = _im2col(xq, kh, kw, stride, padding)
    return int8_mm(cols, wq.reshape(kh * kw * cin, cout), impl).reshape(B, Ho, Wo, cout)


def conv2d_int8(
    x: torch.Tensor,  # [B, H, W, Cin]
    w: torch.Tensor,  # [kh, kw, Cin, Cout] (HWIO)
    bias: torch.Tensor | None = None,  # [Cout]
    scale: torch.Tensor | None = None,  # [Cout] folded-BN scale
    stride: int = 1,
    padding: str = "SAME",
    relu: bool = True,
    impl: str | None = None,
) -> torch.Tensor:
    """relu(scale · dequant(conv_s8(x, w)) + bias) in x's dtype, the epilogue
    in float32: one per-tensor scale for x, one per-Cout scale for w. SAME
    pads with quantized zeros, which are exact zeros."""
    xs = _absmax_scale(x, (0, 1, 2, 3))  # [1, 1, 1, 1]
    ws = _absmax_scale(w, (0, 1, 2))  # [1, 1, 1, Cout]
    acc = _conv_acc(_quantize(x, xs), _quantize(w, ws), stride, padding, impl or route(x))
    deq = xs.reshape(()) * ws.reshape(-1)  # [Cout]
    if scale is not None:
        deq = deq * scale.float()
    y = acc.float() * deq
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)
