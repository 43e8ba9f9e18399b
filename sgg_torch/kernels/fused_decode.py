"""Fused 3-step triple decode: the CUDA kernel and its plain PyTorch version.

Port of ``sgg/kernels/fused_decode.py``. ``fused_decode`` runs the whole
decode forward of the attention-LSTM generator (LSTM init from the mean
feature, hoisted feature projection, then per step additive attention, TF1
LSTM gates, deep output, masked vocab logits, ``softmax((logits + g) / tau)``
and, when ``hard``, the one-hot of its first maximum, fed back through the
embedding) in one launch of ``csrc/fused_decode.cu``. The Gumbel noise is an
input, so the result is comparable with the generator given the same noise.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs :func:`decode_plain`, a line-by-line PyTorch rendering of the Pallas
kernel with the same cast points (float32 accumulation; c, h, proj, hp, ctx,
dec, prev and y rounded to the compute dtype; float32 biases and mask).

Weights are the flat dict of :func:`decode_params_from_generator`: matrices
``[in, out]`` in the compute dtype, biases float32, all contiguous.
"""

from __future__ import annotations

import numpy as np
import torch

from sgg_torch.kernels import build

TRIPLE_LEN = 3
WEIGHT_NAMES = (
    "wf", "wh", "bh", "v", "wc", "bc", "wi", "bi", "k", "bk",
    "wd", "bd", "wv", "bv", "emb",
)
BIAS_NAMES = frozenset({"bh", "bc", "bi", "bk", "bd", "bv"})
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
ROW_TILES = (32, 16)  # the kernel's template instances

# Kernel launches in this process; the wrapper adds one per launch.
launches = 0


def decode_params_from_generator(
    sd: dict, dtype: torch.dtype = torch.float32, device=None
) -> dict[str, torch.Tensor]:
    """Port generator state_dict → the kernel's flat weights, ``[in, out]``
    matrices in ``dtype`` and float32 biases, contiguous on ``device``."""
    raw = {
        "wf": sd["attention.feat_proj.weight"].t(),   # [F, A]
        "wh": sd["attention.state_proj.weight"].t(),  # [H, A]
        "bh": sd["attention.state_proj.bias"],        # [A]
        "v": sd["attention.score.weight"][0],         # [A]
        "wc": sd["init_c.weight"].t(),                # [F, H]
        "bc": sd["init_c.bias"],                      # [H]
        "wi": sd["init_h.weight"].t(),                # [F, H]
        "bi": sd["init_h.bias"],                      # [H]
        "k": sd["cell.kernel"],                       # [F+E+Z+H, 4H]
        "bk": sd["cell.bias"],                        # [4H]
        "wd": sd["deep_out.weight"].t(),              # [H+F, E]
        "bd": sd["deep_out.bias"],                    # [E]
        "wv": sd["vocab_proj.weight"].t(),            # [E, V]
        "bv": sd["vocab_proj.bias"],                  # [V]
        "emb": sd["token_embedding"],                 # [V, E]
    }
    return cast_params(raw, dtype, device)


def cast_params(params: dict, dtype: torch.dtype, device=None) -> dict[str, torch.Tensor]:
    """Weights to ``dtype``, biases to float32, contiguous on ``device``."""
    out = {}
    for n in WEIGHT_NAMES:
        t = params[n]
        t = t if torch.is_tensor(t) else torch.from_numpy(np.array(t))
        t = t.to(device=device, dtype=torch.float32 if n in BIAS_NAMES else dtype)
        out[n] = t.contiguous()
    return out


def step_mask_bias(step_mask, device=None) -> torch.Tensor:
    """bool[3, V] legality mask → additive float32 bias (0 legal, -1e9 not)."""
    m = torch.as_tensor(step_mask, dtype=torch.bool, device=device)
    return torch.where(m, 0.0, -1e9).to(torch.float32)


def decode_plain(
    params: dict, feats: torch.Tensor, z: torch.Tensor, gumbel: torch.Tensor,
    tau: float = 1.0, mask_bias: torch.Tensor | None = None, hard: bool = True,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch → y [B, 3, V] in feats' dtype."""
    p = params
    dtype = feats.dtype
    f32 = torch.float32
    B, R, F = feats.shape
    E = p["emb"].shape[1]
    H = p["wc"].shape[1]
    V = p["wv"].shape[1]
    if mask_bias is None:
        mask_bias = torch.zeros(TRIPLE_LEN, V, dtype=f32, device=feats.device)

    def dot(a, w):  # products accumulate in float32
        return a.to(f32) @ w.to(f32)

    mean = feats.to(f32).mean(dim=1).to(dtype)
    c = torch.tanh(dot(mean, p["wc"]) + p["bc"]).to(dtype)
    h = torch.tanh(dot(mean, p["wi"]) + p["bi"]).to(dtype)
    proj = dot(feats.reshape(B * R, F), p["wf"]).to(dtype).reshape(B, R, -1)
    prev = torch.zeros(B, E, dtype=dtype, device=feats.device)
    iota_v = torch.arange(V, device=feats.device).expand(B, V)

    ys = []
    for t in range(TRIPLE_LEN):
        hp = (dot(h, p["wh"]) + p["bh"]).to(dtype)
        s = torch.tanh(proj + hp[:, None, :])  # [B, R, A] in dtype
        scores = (s.to(f32) * p["v"].to(f32)[None, None, :]).sum(dim=-1)
        m = scores.max(dim=-1, keepdim=True).values
        e = torch.exp(scores - m)
        alpha = e / e.sum(dim=-1, keepdim=True)
        ctx = (alpha[:, :, None] * feats.to(f32)).sum(dim=1).to(dtype)
        x = torch.cat([ctx, prev, z.to(dtype), h], dim=-1)
        gates = dot(x, p["k"]) + p["bk"]
        i, j, fg, o = torch.split(gates, H, dim=-1)
        cf = c.to(f32) * torch.sigmoid(fg + 1.0) + torch.sigmoid(i) * torch.tanh(j)
        c = cf.to(dtype)
        h = (torch.tanh(cf) * torch.sigmoid(o)).to(dtype)
        dec = torch.tanh(dot(torch.cat([h, ctx], dim=-1), p["wd"]) + p["bd"]).to(dtype)
        logits = dot(dec, p["wv"]) + p["bv"] + mask_bias[t][None, :]
        ly = (logits + gumbel[:, t, :]) / tau
        mly = ly.max(dim=-1, keepdim=True).values
        ey = torch.exp(ly - mly)
        y = ey / ey.sum(dim=-1, keepdim=True)  # [B, V] float32
        if hard:
            ymax = y.max(dim=-1, keepdim=True).values
            # Tie-break like argmax: smallest index among maxima.
            first = torch.where(y == ymax, iota_v, V).min(dim=-1, keepdim=True).values
            y = (iota_v == first).to(f32)
        y = y.to(dtype)
        prev = dot(y, p["emb"]).to(dtype)
        ys.append(y)
    return torch.stack(ys, dim=1)


def _check(params, feats, z, gumbel, mask_bias):
    if feats.dim() != 3:
        raise ValueError(f"feats must be [B, R, F], got {tuple(feats.shape)}")
    dtype = feats.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"feats dtype {dtype} not supported (float32, bfloat16)")
    B, R, F = feats.shape
    A = params["wf"].shape[1]
    H = params["wc"].shape[1]
    E = params["emb"].shape[1]
    V = params["wv"].shape[1]
    Z = z.shape[-1]
    want = {
        "wf": (F, A), "wh": (H, A), "bh": (A,), "v": (A,), "wc": (F, H),
        "bc": (H,), "wi": (F, H), "bi": (H,), "k": (F + E + Z + H, 4 * H),
        "bk": (4 * H,), "wd": (H + F, E), "bd": (E,), "wv": (E, V), "bv": (V,),
        "emb": (V, E),
    }
    named = [("feats", feats, dtype, (B, R, F)), ("z", z, dtype, (B, Z)),
             ("gumbel", gumbel, torch.float32, (B, TRIPLE_LEN, V)),
             ("mask_bias", mask_bias, torch.float32, (TRIPLE_LEN, V))]
    named += [(n, params[n], torch.float32 if n in BIAS_NAMES else dtype, want[n])
              for n in WEIGHT_NAMES]
    for name, t, dt, shape in named:
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on {feats.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return B, R, F, A, H, E, Z, V


def fused_decode(
    params: dict, feats: torch.Tensor, z: torch.Tensor, gumbel: torch.Tensor,
    tau: float = 1.0, mask_bias: torch.Tensor | None = None, hard: bool = True,
    row_tile: int | None = None,
) -> torch.Tensor:
    """One-launch 3-step decode → y [B, 3, V] in feats' dtype (one-hot when
    ``hard``; tokens are its argmax). CPU tensors take :func:`decode_plain`.

    ``row_tile`` overrides the feature rows the kernel stages at a time (the
    library's own choice for the widths otherwise): 32 or 16, and no more
    than that choice, or the wrapper raises. A check can so run the 16-row
    instance at widths where the library would pick 32."""
    global launches
    if feats.device.type == "cpu":
        return decode_plain(params, feats, z, gumbel, tau, mask_bias, hard)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_decode runs on cuda or cpu, not {feats.device}")
    if mask_bias is None:
        V = params["wv"].shape[1]
        mask_bias = torch.zeros(TRIPLE_LEN, V, dtype=torch.float32, device=feats.device)
    B, R, F, A, H, E, Z, V = _check(params, feats, z, gumbel, mask_bias)
    lib = build.load_library()
    # The kernel stages feature rows in shared memory; the library picks how
    # many per tile from the widths, and the launch takes that same number.
    fits = lib.sgg_fused_decode_row_tile(R, F, A, H, E, Z, V)
    if fits == 0:
        raise ValueError(
            f"fused_decode at R={R}, F={F}, A={A}, H={H}, E={E}, Z={Z}, V={V} needs more "
            f"than the {_SMEM_LIMIT} bytes of shared memory a Hopper block has, even "
            f"with 16-row feature tiles"
        )
    if row_tile is None:
        row_tile = fits
    elif row_tile not in ROW_TILES or row_tile > fits:
        raise ValueError(
            f"row_tile {row_tile}: the kernel takes 32 or 16 feature rows per tile, and "
            f"at most {fits} at these widths"
        )
    y = torch.empty(B, TRIPLE_LEN, V, dtype=feats.dtype, device=feats.device)
    proj = torch.empty(B, R, A, dtype=feats.dtype, device=feats.device)
    w = [params[n].data_ptr() for n in WEIGHT_NAMES]
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sgg_fused_decode(
            _DTYPE_CODES[feats.dtype], int(bool(hard)), row_tile, B, R, F, A, H, E, Z, V,
            feats.data_ptr(), z.data_ptr(), gumbel.data_ptr(),
            mask_bias.data_ptr(), float(tau), *w, proj.data_ptr(),
            y.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_decode kernel launch failed: CUDA error {err}")
    launches += 1
    return y
