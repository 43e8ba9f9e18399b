#!/usr/bin/env python3
"""Seeded-fault check of the kernels' gates and of the pipeline_v4 gather's
holds, on the card.

  python3 chip_fault_check.py [--only TEXT[,TEXT...]]

``--only`` keeps the faults whose label holds one of the texts, and the
baseline's holds that they reach (``--only TF32``: the CNN hold alone).

The bf16 flash kernels run the products that take p or ds (P·V in the
forward; ds·k in the dq kernel; dsᵀ·q_s and pᵀ·do in the dk/dv kernel) as
three bf16 products over an exact split p = hi + mid + lo. For each of those
four products and for two cuts of its split (hi only, which is p or ds
rounded to bf16; and hi + mid), this script copies the port (``sgg_torch/``)
into a temporary directory, cuts the split at that one product in the copy's
CUDA source, builds the copy's kernels with nvcc and holds the outputs of the
kernel that holds the product against the plain versions under
``chip_smoke.py``'s gates, at [32, 12, 196, 64] and [32, 12, 100, 64]:
  - the bf16 gate: within one bf16 ulp of plain plus 1e-4 x max, and at most
    1 % of the outputs differing;
  - the float32-result gate: the kernel's float32 result before the cast (its
    check-only entry) within ``flash_attention.F32_RESULT_TOL`` of the plain
    version in float32, as a relative L2 distance.
A fault is refused when either gate fails it.

Four conv_direct faults are seeded into the tiled instance of the copy's
``conv_direct.cu``: the halo's column test dropped (a tap at the left or right
edge reads the neighbouring row's pixel), its row test dropped (a tap at the
top or bottom edge reads the neighbouring image's row), the weight slice of
tap 1 offset by one channel slice, and bias added before scale. Each must be
refused at the four ResNet-50 3x3 shapes ([32,56,56,64]->64,
[32,28,28,128]->128, [32,14,14,256]->256, [32,7,7,512]->512, bf16) by
``chip_smoke.py``'s phase-4 gate: every output within one bf16 ulp of the
plain version plus 1e-4 x max, finite, of the plain version's shape and
dtype. x lies inside a buffer with one seeded image before it and one after,
so a fault that reads past the image reads data, not unmapped memory.

Four fused_matmul faults are seeded into the tiled instance of the copy's
``fused_matmul.cu``: the row guard dropped (rows of a past M read, not
zero-filled, and stored), the k guard dropped (k past K read from a and b,
not zero-filled), b's first K slice offset by one slice, and bias added
before scale. Each is held, through the planned launch of the tiled
instance, at the fifteen ResNet-50 1x1 shapes (B = 32, bf16), a ragged-M
shape ([777, 64] @ [64, 72]) and a ragged-K shape ([1024, 80] @ [80, 64]) to
``chip_smoke.py``'s phase-4 gate, and the seeded rows around the output must
come back untouched; a, b and the output each lie inside a buffer with 256
seeded rows before and after it, so a dropped guard reads and writes data,
not unmapped memory. A fault must be refused at every shape where it can
change an output: the row guard where M is not a multiple of the plan's
tile rows, the k guard where K is not a multiple of its slice, the other two
everywhere; elsewhere the verdict is reported.

Five fused_decode faults are seeded into the batched instance of the copy's
``fused_decode.cu``: c left unrounded; ctx and h rounded toward zero instead
of to nearest (both reach the products only as bf16 operands, so leaving
them unrounded cannot be written in this instance; a wrong rounding at the
same points is); the softmax over V summed over the block's own logits
columns only; and the tie rule taking the last index among the maxima. The
first four are held to ``chip_smoke.py``'s phase-3 gates at vg1k widths,
bf16, B = 64 and 37, on its inputs (soft y within 1e-2 of each row's
largest value, at most 0.5 % of y differing from plain, hard tokens
identical for at least 99 % of 8 draws, finite); the tie rule to its
exact-tie case (wv's and bv's column 197 a copy of column 5, the Gumbel
noise copied: every row and step must pick 5).

Two faults are seeded into the port's int8 balanced gather
(``sgg_torch/data/pipeline.py``, ``gather_super_batch``): the dequant cast to
the store's dtype before the scale multiply (two roundings, where the
reference casts the float32 product once), and the inverse CDF with ``>=`` in
place of ``>``. Each is held to ``chip_smoke.py``'s pipeline_v4 gather holds
(``gather_holds``) on a seeded float16 corpus of 2,048 images at pipeline_v4's
widths, on the card: the batch equal to the CPU's and to the reference's
formula written out in numpy, bit for bit, at draws that put ties on the
CDF's steps; dequantized values within half a scale step plus one float16
ulp of the source; draws moved toward the rarer predicates.

Two faults are seeded into the copy's JPEG loader
(``sgg_torch/native/jpeg_loader.cc``): the resize's source row shifted by
half a pixel (the fixed-point coordinate without its -0.5), and the channels
written as BGR. Each is held to ``chip_smoke.py``'s phase-21 (a) gates
(``loader_phase``): the fixture's JPEGs at 224 px against the reference
decoder's committed bytes, and every fixture JPEG at 224 and 64 px bit for
bit against the plain numpy resize of the loader's own decode before the
resize.

One fault is seeded into the fused stepper (``sgg_torch/data/pipeline.py``,
``FusedStepper._body``): the step counter that the captured step reads is
never advanced, so the graph reads stale draws and replays step k's draws
twice. It is held to ``chip_smoke.py``'s phase-20 hold (``fused_hold``) at
pipeline_v4's widths on a seeded int8 corpus of 1,024 images: 4 eager steps
against 2 dispatches of 2 on the card, every tensor of the state and the
last step's metrics bit for bit.

Three faults are seeded into the grounded recipe's stage 1: the MoE layer's
gates not renormalized over the kept experts, and its capacity one slot short
(``sgg_torch/models/moe.py``), each held to ``chip_smoke.py``'s phase-22 (c)
MoE hold (``moe_hold``: the card's ``moe_forward`` at ViT-B/16's width
against the plain float64 version written out per expert, at capacity
factors 1.25 and 0.5); and a pretrain step whose loss drops the spatial CE
(``sgg_torch/train/pretrain.py``), held to its pretrain hold
(``pretrain_hold``: a float32 VGG-19 step's loss against the loss written
out in float64 from the model's outputs) on the committed fixture's first
JPEGs at 224 px. A card-against-CPU hold alone cannot refuse them: both run
the same code.

Two faults are seeded into the deployment tier: the int8 route's zero padding
(``sgg_torch/kernels/quant.py``, ``_pad2``) filled with ones, which adds the
padded K columns' products to every sum where K is not a multiple of 8 (the
ResNet-50 stem, K = 147, and VGG-19's conv1_1, K = 27), held to
``chip_smoke.py``'s phase-23 (a) holds (``int8_holds``: ``torch._int_mm``
against the plain float64 sums bit for bit at every distinct int8 conv of
ResNet-50 and VGG-19 and the ViT-B/16 projections, 224 px, B = 32); and an
artifact whose weights are perturbed after the trace, before the file is
written (``sgg_torch/export.py``, ``save_artifact``), held to ``cli.export
--check`` on a vg1k workdir (K = 50, B = 32), which must exit 1.

Two faults are seeded into the data-parallel step
(``sgg_torch/train/step.py``): the generator's gradients left unreduced (its
``pmean`` dropped, so the ranks drift apart), and the rank dropped from the
noise's seed (every rank draws rank 0's noise). Each is held to
``chip_smoke.py``'s phase-24 holds (``dp_holds``) on the copy's train CLI at
``smoke`` widths over two ranks that share the card (gloo) and in a plain
process, 4 steps: the ranks' states equal bit for bit, their noise distinct,
rank 0's the plain run's.

One fault is seeded into the library conv that a trainable CNN runs
(``sgg_torch/kernels/conv_direct.py``, ``tf32_allowed``): cuDNN's TF32 left on
for float32 operands. It is held to ``chip_smoke.py``'s phase-29 (c) hold
(``cnn_hold``: a float32 VGG-19 ``train_encoder`` step at 224 px, B 4, on the
card and on the CPU, whose first critic update's critic and encoder gradients
must lie no farther from their float64 oracle on the card than ``c4_gate``
allows beside the CPU's).

The unmodified tree is held to
the same gates as a baseline (it must pass them), and a variant that is not a
fault is reported beside it: the hi, mid and lo products summed in one
accumulator carried inside the tensor core, the score products too (no fresh
sum per 16-deep step and no round-to-nearest add), at the two shapes and at
[32, 12, 576, 64]. Each copy builds and runs in its own process, all at once.
Exits 0 when the baseline passes and every fault is refused at each of its
shapes (both flash shapes; the four conv shapes; the matmul shapes it can
reach; the decode batches or the tie case, whichever can see it; the gather
and graph holds; the loader's gates; the MoE and pretrain holds; the int8
holds and the export check; the data-parallel holds; the CNN hold), 1
otherwise. The tree itself is not touched.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(32, 12, 196, 64), (32, 12, 100, 64)]
VARIANT_SHAPES = SHAPES + [(32, 12, 576, 64)]
CSRC = os.path.join("sgg_torch", "kernels", "csrc")
# (source, the tag that ends the line which splits, the kernel it sits in)
CONV_SHAPES = [((32, 56, 56, 64), 64), ((32, 28, 28, 128), 128), ((32, 14, 14, 256), 256),
               ((32, 7, 7, 512), 512)]
CONV_SRC = "conv_direct.cu"
# conv fault: (sound text, faulty text) in conv_direct.cu
CONV_FAULTS = {
    "halo column test dropped":
        ("      ok = ok && (unsigned)iw < (unsigned)W;  // halo: the column test\n", ""),
    "halo row test dropped":
        ("      ok = ok && (unsigned)ih < (unsigned)H;  // halo: the row test\n", ""),
    "tap 1's weight slice offset by one channel slice":
        ("const bf16* wk = w + ((long)p_tap * C + p_c0) * N + n0 + b_col;",
         "const bf16* wk = w + ((long)p_tap * C + p_c0 + (p_tap == 1 ? BK : 0)) * N + n0 + b_col;"),
    "bias added before scale":
        ("  return __fadd_rn(__fmul_rn(a, s), b);\n", "  return __fmul_rn(__fadd_rn(a, b), s);\n"),
}
MM_SRC = "fused_matmul.cu"
# fused_matmul's tiled instance, bf16, as (M, K, N, relu): the ResNet-50 1x1
# shapes (B = 32, 224 px), then a ragged-M shape and a ragged-K shape.
MM_SHAPES = [
    (100352, 64, 64, True), (100352, 256, 64, True), (100352, 64, 256, False),
    (100352, 256, 128, True), (25088, 512, 128, True), (25088, 128, 512, False),
    (25088, 256, 512, False), (25088, 512, 256, True), (6272, 1024, 256, True),
    (6272, 256, 1024, False), (6272, 512, 1024, False), (6272, 1024, 512, True),
    (1568, 2048, 512, True), (1568, 512, 2048, False), (1568, 1024, 2048, False),
    (777, 64, 72, True), (1024, 80, 64, False),
]
MM_GUARD = 256  # seeded rows before and after a, b and out; at least the tallest tile
# matmul fault: (sound text, faulty text, the shapes it can reach) in
# fused_matmul.cu. "M": where M is not a multiple of the plan's tile rows;
# "K": where K is not a multiple of its slice; "all": every shape.
MM_FAULTS = {
    "row guard dropped (rows past M read, not zero-filled, and stored)":
        ("  return m < M;\n", "  return true;\n", "M"),
    "k guard dropped (k past K read from A and B, not zero-filled)":
        ("  return k < K;\n", "  return true;\n", "K"),
    "b's first K slice offset by one slice":
        ("const bf16* b_src = b + (long)p_k0 * N + n0 + b_col;",
         "const bf16* b_src = b + (long)(p_k0 + (p_k0 == 0 ? BK : 0)) * N + n0 + b_col;", "all"),
    "bias added before scale":
        ("  return __fadd_rn(__fmul_rn(a, s), b);\n", "  return __fmul_rn(__fadd_rn(a, b), s);\n",
         "all"),
}
DECODE_SRC = "fused_decode.cu"
# decode fault: (sound text, faulty text, what can refuse it) in the batched
# instance of fused_decode.cu. "gates": phase 3's gates at vg1k widths,
# bf16, B = 64 and 37 (soft y within 1e-2 of the row max, at most 0.5 % of y
# differing from plain, hard tokens >= 99 % identical, finite); "tie": the
# exact-tie case. ctx and h reach the products only as bf16 operands, so
# leaving them unrounded cannot be written in this instance; their seeds
# round them toward zero instead of to nearest, a wrong rounding at the same
# points.
DECODE_FAULTS = {
    "ctx rounded toward zero, not to nearest":
        ("        const bf16 ctx = __float2bfloat16(s);  // ctx, rounded\n",
         "        const bf16 ctx = __float2bfloat16_rz(s);  // ctx, rounded\n", "gates"),
    "h rounded toward zero, not to nearest":
        ("        const bf16 h = __float2bfloat16(__fmul_rn(tanhf(cf), sigmoid(go)));  // h, rounded\n",
         "        const bf16 h = __float2bfloat16_rz(__fmul_rn(tanhf(cf), sigmoid(go)));  // h, rounded\n",
         "gates"),
    "c left unrounded":
        ("        *c = rnd<bf16>(cf);  // c, rounded\n", "        *c = cf;  // c, rounded\n", "gates"),
    "the softmax over V summed over the block's own columns only":
        ("      for (int n = tid; n < V; n += kThreads) se += expf(lr[n] - m);\n",
         "      for (int n = tid; n < V; n += kThreads)\n"
         "        if (n / kCols % nb == bid) se += expf(lr[n] - m);\n", "gates"),
    "the tie rule taking the last index among the maxima":
        ("  int first = V;\n  for (int n = threadIdx.x; n < V; n += kThreads)\n"
         "    if (expf(lr[n] - m) / se == ym) first = min(first, n);\n"
         "  return block_min_int(first, red);\n",
         "  int last = -1;\n  for (int n = threadIdx.x; n < V; n += kThreads)\n"
         "    if (expf(lr[n] - m) / se == ym) last = max(last, n);\n"
         "  return -block_min_int(-last, red);\n", "tie"),
}
DECODE_BATCHES = (64, 37)
GATHER_SRC = "sgg_torch/data/pipeline.py"
GATHER_IMAGES = 2048
# gather fault: (sound text, faulty text) in the port's int8 balanced gather.
GATHER_FAULTS = {
    "the dequant cast before the scale multiply":
        ("        x = (x.float() * store.scale[img][..., None]).to(store.store_dtype)\n",
         "        x = x.to(store.store_dtype) * store.scale[img][..., None].to(store.store_dtype)\n"),
    "the inverse CDF with >= in place of >":
        ("        tsel = (u[..., None] > store.cumw[img]).sum(-1)\n",
         "        tsel = (u[..., None] >= store.cumw[img]).sum(-1)\n"),
}
LOADER_SRC = "sgg_torch/native/jpeg_loader.cc"
# loader fault: (sound text, faulty text) in the port's JPEG loader's resize.
LOADER_FAULTS = {
    "the resize's source row shifted by half a pixel":
        ("    long fy = y * sy + (sy >> 1) - (1 << 15);\n",
         "    long fy = y * sy + (sy >> 1);\n"),
    "the channels written as BGR":
        ("        d[x * 3 + c] = static_cast<unsigned char>((top * (256 - wy) + bot * wy) "
         ">> 16);\n",
         "        d[x * 3 + 2 - c] = static_cast<unsigned char>((top * (256 - wy) + bot * wy) "
         ">> 16);\n"),
}
MOE_SRC = "sgg_torch/models/moe.py"
PRETRAIN_SRC = "sgg_torch/train/pretrain.py"
# phase-22 faults: (source, sound text, faulty text, the hold that must refuse it).
RECIPE_FAULTS = {
    "MoE gates not renormalized over the kept experts":
        (MOE_SRC,
         "        combine = combine + (gate / denom)[..., None, None] * (keep[..., None] * slot)\n",
         "        combine = combine + gate[..., None, None] * (keep[..., None] * slot)\n", "moe"),
    "the MoE capacity one slot short":
        (MOE_SRC,
         "    return max(1, math.ceil(top_k * seq_len * capacity_factor / num_experts))\n",
         "    return max(1, math.ceil(top_k * seq_len * capacity_factor / num_experts) - 1)\n",
         "moe"),
    "the pretrain step without the spatial CE":
        (PRETRAIN_SRC, "            loss = loss + spatial_weight * ce\n", "", "pretrain"),
}
QUANT_SRC = "sgg_torch/kernels/quant.py"
EXPORT_SRC = "sgg_torch/export.py"
# phase-23 faults: (source, sound text, faulty text, the hold that must refuse it).
DEPLOY_FAULTS = {
    "the int8 route padding K with a nonzero value":
        (QUANT_SRC, "    return F.pad(t, (0, cols, 0, rows))\n",
         "    return F.pad(t, (0, cols, 0, rows), value=1)\n", "int8"),
    "the artifact's weights perturbed after export":
        (EXPORT_SRC,
         "    torch.export.save(exported, path, extra_files={META_FILE: json.dumps(meta)})\n",
         "    with torch.no_grad():\n"
         "        for t_ in exported.state_dict.values():\n"
         "            if t_.is_floating_point():\n"
         "                t_.add_(0.01 * torch.randn_like(t_))\n"
         "    torch.export.save(exported, path, extra_files={META_FILE: json.dumps(meta)})\n",
         "export"),
}
STEP_SRC = "sgg_torch/train/step.py"
# phase-24 faults: (source, sound text, faulty text, the hold that must refuse it).
DP_FAULTS = {
    "the generator's gradients left unreduced":
        (STEP_SRC, "            state.g_tx.update(reduce(state.g_tx, g_grads))\n",
         "            state.g_tx.update(g_grads)\n", "dp"),
    "the rank dropped from the noise's seed":
        (STEP_SRC, "        seed = int(t.seed) * 1_000_003 + step + rank * RANK_SEED_STRIDE\n",
         "        seed = int(t.seed) * 1_000_003 + step\n", "dp"),
}
CONV_PY_SRC = "sgg_torch/kernels/conv_direct.py"
# phase-29 fault: (source, sound text, faulty text, the hold that must refuse it).
CNN_FAULTS = {
    "cuDNN's TF32 left on for float32 convs":
        (CONV_PY_SRC, "    return dtype in (torch.bfloat16, torch.float16)\n",
         "    return dtype in (torch.bfloat16, torch.float16, torch.float32)\n", "cnn"),
}
DP_STEPS = 4
GRAPH_IMAGES = 1024
# fused-stepper fault: (sound text, faulty text), the counter never advanced.
GRAPH_FAULTS = {
    "a stale step counter in the graph":
        ("        self._pos.add_(1)\n", ""),
}
SITES = [
    ("flash_attention.cu", "// p of P . V", "fwd"),
    ("flash_attention_bwd.cu", "// ds of dq", "dq"),
    ("flash_attention_bwd.cu", "// ds of dk", "dkv"),
    ("flash_attention_bwd.cu", "// p of dv", "dkv"),
]
# cut name: the split terms zeroed
CUTS = {"hi only": ("mid", "lo"), "hi + mid": ("lo",)}
# The variant: (source, sound text, variant text).
ONE_ACCUMULATOR = [
    ("flash_tile.cuh",
     "  float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n  mma_bf16(h, a, b);\n#pragma unroll\n"
     "  for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], h[i]);\n",
     "  mma_bf16(c, a, b);\n"),
    ("flash_tile.cuh",
     "  mma_rn(acc, a.hi, b);\n  mma_bf16(cor, a.mid, b);\n  mma_bf16(cor, a.lo, b);\n",
     "  mma_bf16(acc, a.hi, b);\n  mma_bf16(acc, a.mid, b);\n  mma_bf16(acc, a.lo, b);\n"),
]


def cut_site(text, tag, zeroed):
    """The source with the split on the line ending in ``tag`` cut: the named
    terms of its Split set to zero."""
    lines = [ln for ln in text.splitlines(keepends=True) if ln.rstrip().endswith(tag)]
    if len(lines) != 1:
        raise SystemExit(f"chip_fault_check: expected one line ending in {tag!r}, "
                         f"found {len(lines)}")
    m = re.fullmatch(r"(\s*)const Split (\w+) = (split_frag\([^;]*\));\s*" + re.escape(tag) + r"\n",
                     lines[0])
    if m is None:
        raise SystemExit(f"chip_fault_check: cannot read the split line {lines[0]!r}")
    ind, var, call = m.groups()
    zero = " ".join(f"{var}.{t}[z_] = 0u;" for t in zeroed)
    faulty = (f"{ind}Split {var} = {call};  // cut\n"
              f"{ind}for (int z_ = 0; z_ < 4; ++z_) {{ {zero} }}\n")
    return text.replace(lines[0], faulty)


def make_copy(tmp, name, edits):
    """Copy sgg_torch/ into tmp/name and apply edits: (source, function of
    its text)."""
    root = os.path.join(tmp, name)
    shutil.copytree(os.path.join(ROOT, "sgg_torch"), os.path.join(root, "sgg_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, edit in edits:
        path = os.path.join(root, src if src.startswith("sgg_torch/") else os.path.join(CSRC, src))
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(edit(text))
    return root


def replace_once(sound, variant):
    def edit(text):
        if text.count(sound) != 1:
            raise SystemExit(f"chip_fault_check: the source no longer has {sound.strip()!r}")
        return text.replace(sound, variant)
    return edit


def child(root, kernels, shapes):
    """Run in a copy: build, hold the named kernels to both gates, print one
    JSON line per (shape, output)."""
    sys.path.insert(0, root)
    import torch

    from sgg_torch.kernels import build
    from sgg_torch.kernels import conv_direct as cd
    from sgg_torch.kernels import flash_attention as fa
    from sgg_torch.kernels import flash_attention_bwd as fb

    if not fb.__file__.startswith(root):
        raise SystemExit(f"chip_fault_check: imported {fb.__file__}, not the copy")
    torch.backends.cuda.matmul.allow_tf32 = False
    if set(kernels) - {"loader", "moe", "pretrain", "int8", "export", "dp", "cnn"}:  # no kernel
        build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def bf16_gate(got, want):
        """(within one bf16 ulp + 1e-4 x max, and within that with at most
        1 % of outputs differing; share differing)."""
        w = want.float()
        diff = (got.float() - w).abs()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs())[1] - 8)
        ulp = torch.where(w == 0, torch.zeros_like(ulp), ulp)
        in_ulp = bool((diff <= ulp + 1e-4 * w.abs().max()).all())
        share = (diff > 0).float().mean().item()
        return in_ulp, in_ulp and share <= 1e-2, share

    if "conv" in kernels:
        for shape, cout in CONV_SHAPES:
            x_all = torch.randn(shape[0] + 2, *shape[1:], generator=gen, device=dev)
            x = x_all.to(torch.bfloat16)[1:-1]  # one guard image on each side
            w = (torch.randn(3, 3, shape[-1], cout, generator=gen, device=dev)
                 / (9 * shape[-1]) ** 0.5).to(torch.bfloat16)
            bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
            scale = 1.0 + 0.1 * torch.randn(cout, generator=gen, device=dev)
            got = cd.conv2d_direct(x, w, bias, scale, relu=True)
            torch.cuda.synchronize()
            want = cd.conv2d_direct_plain(x, w, bias, scale, relu=True)
            ok16 = (got.dtype == want.dtype and got.shape == want.shape
                    and bool(torch.isfinite(got.float()).all()) and bf16_gate(got, want)[0])
            print(json.dumps({"shape": list(shape) + [cout], "output": "conv",
                              "bf16_gate": ok16, "share": (got != want).float().mean().item(),
                              "f32_err": None, "tol": None, "f32_gate": True}), flush=True)

    if "decode" in kernels:
        decode_rows(root, dev)

    if "gather" in kernels:
        gather_rows(dev)

    if "graph" in kernels:
        graph_rows(dev)

    if "moe" in kernels or "pretrain" in kernels:
        recipe_rows(root, dev, kernels)

    if "int8" in kernels or "export" in kernels:
        deploy_rows(root, dev, kernels)
    if "cnn" in kernels:
        cnn_rows(root, dev)
    if "dp" in kernels:
        dp_rows(root)

    if "loader" in kernels:
        from sgg_torch.native import loader

        if not loader.__file__.startswith(root):
            raise SystemExit(f"chip_fault_check: imported {loader.__file__}, not the copy")
        loader_rows()

    if "mm" in kernels:
        from sgg_torch.kernels import matmul as mm

        lib, G = build.load_library(), MM_GUARD
        for M, K, N, relu in MM_SHAPES:
            a = torch.randn(M + 2 * G, K, generator=gen, device=dev).to(torch.bfloat16)[G:-G]
            b = (torch.randn(K + 2 * G, N, generator=gen, device=dev)
                 / K ** 0.5).to(torch.bfloat16)[G:-G]
            bias = 0.1 * torch.randn(N, generator=gen, device=dev)
            scale = 1.0 + 0.1 * torch.randn(N, generator=gen, device=dev)
            out_all = torch.randn(M + 2 * G, N, generator=gen, device=dev).to(torch.bfloat16)
            keep = out_all.clone()
            got = out_all[G:-G]
            p = mm.plan(M, K, N, torch.bfloat16, torch.bfloat16, mm.aligned(a), mm.aligned(b),
                        mm.sm_count(0))
            if p.instance != "tiled":
                raise SystemExit(f"chip_fault_check: [{M}, {K}, {N}] does not run tiled: {p}")
            # The planned launch, as the wrapper makes it, into an output with
            # seeded rows on each side, which must come back untouched.
            err = lib.sgg_fused_matmul_tiled(
                int(relu), M, N, K, a.data_ptr(), b.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), got.data_ptr(), p.bm, p.bn, p.bk, p.stages, p.threads, p.smem,
                *p.grid, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err != 0:
                raise SystemExit(f"chip_fault_check: tiled launch failed: CUDA error {err}")
            want = mm.fused_matmul_plain(a, b, bias, scale, relu=relu)
            guards = torch.equal(out_all[:G], keep[:G]) and torch.equal(out_all[-G:], keep[-G:])
            ok16 = (bool(torch.isfinite(got.float()).all()) and bf16_gate(got, want)[0]
                    and guards)
            print(json.dumps({"shape": [M, K, N], "output": f"mm {p.bm}x{p.bn}x{p.bk}",
                              "bf16_gate": ok16, "share": (got != want).float().mean().item(),
                              "f32_err": None, "tol": None, "f32_gate": True,
                              "guards": guards,
                              "reach": {"M": M % p.bm != 0, "K": K % p.bk != 0, "all": True}}),
                  flush=True)

    for shape in shapes:
        q, k, v, do = (torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = fa.flash_attention_with_lse(q, k, v)
        rows = []
        if "fwd" in kernels:
            rows.append(("o", o, fa.flash_attention_plain(q, k, v), fa.launch_f32_result(q, k, v),
                         fa.flash_attention_plain(q, k, v, cast=False), fa.F32_RESULT_TOL))
        D = fb.dstat(o, do).contiguous()
        if "dq" in kernels:
            rows.append(("dq", fb.launch_dq(q, k, v, do, lse, D), fb.dq_plain(q, k, v, do, lse, D),
                         fb.launch_dq_f32_result(q, k, v, do, lse, D),
                         fb.dq_plain(q, k, v, do, lse, D, cast=False), fa.F32_RESULT_TOL))
        if "dkv" in kernels:
            got, want = fb.launch_dkv(q, k, v, do, lse, D), fb.dkv_plain(q, k, v, do, lse, D)
            got32 = fb.launch_dkv_f32_result(q, k, v, do, lse, D)
            want32 = fb.dkv_plain(q, k, v, do, lse, D, cast=False)
            for i, name in enumerate(("dk", "dv")):
                rows.append((name, got[i], want[i], got32[i], want32[i], fa.F32_RESULT_TOL))
        torch.cuda.synchronize()
        for name, got, want, got32, want32, tol in rows:
            _, ok16, share = bf16_gate(got, want)
            err32 = fa.f32_result_error(got32, want32)
            print(json.dumps({"shape": list(shape), "output": name, "bf16_gate": ok16,
                              "share": share, "f32_err": err32, "tol": tol,
                              "f32_gate": err32 <= tol}), flush=True)


def gather_rows(dev):
    """chip_smoke.py's pipeline_v4 gather holds on the copy's pipeline, on a
    seeded corpus of GATHER_IMAGES images at pipeline_v4's widths (the trained
    run's vocab), its subset size and batch: the card against the CPU, bit
    for bit; against the reference's formula in numpy, bit for bit, at draws
    with ties at the steps of the CDF; dequantized values within half a
    scale step plus one float16 ulp; draws moved toward the rarer
    predicates. One JSON line."""
    import chip_smoke
    from sgg_torch.data import Vocab, pipeline

    vocab = Vocab.load(os.path.join(ROOT, "results", "run_v3_bal0.7_ckpt", "vocab.json"))
    feats, triples = chip_smoke.v4_corpus(vocab, GATHER_IMAGES, 0, dev)
    h = chip_smoke.gather_holds(pipeline, feats, triples, 0.7, chip_smoke.V4_BUDGET // 2, 256,
                                5, dev, 0)
    names = ("card_vs_cpu", "formula", "dequant", "tail")
    print(json.dumps({"shape": [GATHER_IMAGES, 196, 512, 256], "output": "gather",
                      "bf16_gate": all(h[k] for k in names), "share": h["share_differing"],
                      "f32_err": None, "tol": None, "f32_gate": True,
                      "holds": {k: h[k] for k in names}}), flush=True)


def graph_rows(dev):
    """chip_smoke.py's phase-20 hold on the copy's fused stepper at
    pipeline_v4's widths, on a seeded int8 corpus of GRAPH_IMAGES images
    with predicate balance: 4 eager steps against 2 dispatches of 2, bit for
    bit. One JSON line."""
    import chip_smoke
    from sgg_torch.config import get_config
    from sgg_torch.data import TripleDataset, Vocab

    vocab = Vocab.load(os.path.join(ROOT, "results", "run_v3_bal0.7_ckpt", "vocab.json"))
    feats, triples = chip_smoke.v4_corpus(vocab, GRAPH_IMAGES, 0, dev)
    ds = TripleDataset(feats, triples)
    ds.set_predicate_balance(0.7)
    cfg = get_config("pipeline_v4")
    cfg.model.vocab_size = len(vocab)
    h = chip_smoke.fused_hold(dev, cfg, ds, vocab, 4, 2, int8=True)
    ok = h["equal"] and h["metrics_equal"] and h["graph"]
    print(json.dumps({"shape": [GRAPH_IMAGES, 196, 512, 256], "output": "graph",
                      "bf16_gate": ok, "share": len(h["differ"]) / h["tensors"],
                      "f32_err": None, "tol": None, "f32_gate": True,
                      "holds": {"tensors": h["equal"], "metrics": h["metrics_equal"]}}),
          flush=True)


def recipe_rows(root, dev, kernels):
    """chip_smoke.py's phase-22 (c) holds on the copy: ``moe_hold`` (the MoE
    layer on the card against the CPU and against the plain float64 version
    at ViT-B/16's width) and ``pretrain_hold`` (a float32 VGG-19 pretrain step
    with the spatial task, card against CPU, and its loss against the plain
    float64 loss) on the committed fixture's first JPEGs at 224 px. One JSON
    line per hold."""
    import chip_smoke
    from sgg_torch.models import moe

    if not moe.__file__.startswith(root):
        raise SystemExit(f"chip_fault_check: imported {moe.__file__}, not the copy")
    if "moe" in kernels:
        ok = chip_smoke.moe_hold(dev)["ok"]
        print(json.dumps({"shape": [8, 196, 768], "output": "moe", "bf16_gate": ok,
                          "share": 0.0, "f32_err": None, "tol": None, "f32_gate": True}),
              flush=True)
    if "pretrain" in kernels:
        store = chip_smoke.recipe_store(chip_smoke.FIXTURE, chip_smoke.GR_HOLD_BATCH, 224)
        h = chip_smoke.pretrain_hold(dev, store)
        print(json.dumps({"shape": [chip_smoke.GR_HOLD_BATCH, 224, 224, 3], "output": "pretrain",
                          "bf16_gate": h["ok"], "share": 0.0, "f32_err": None, "tol": None,
                          "f32_gate": True, "holds": {"loss": h["card"]["loss"],
                                                      "plain": h["plain_loss"]}}), flush=True)


def cnn_rows(root, dev):
    """``chip_smoke.cnn_hold`` on the copy (phase 29 (c)): one JSON line."""
    import chip_smoke
    from sgg_torch.kernels import conv_direct

    if not conv_direct.__file__.startswith(root):
        raise SystemExit(f"chip_fault_check: imported {conv_direct.__file__}, not the copy")
    ok, nums = chip_smoke.cnn_hold(dev)
    print(json.dumps({"shape": [chip_smoke.P29_HOLD_BATCH, 224, 224, 3], "output": "cnn",
                      "bf16_gate": ok, "share": 0.0, "f32_err": None, "tol": None,
                      "f32_gate": True, "holds": {"grads": nums["grads"], "bad": nums["bad"]}}),
          flush=True)


def deploy_rows(root, dev, kernels):
    """chip_smoke.py's phase-23 holds on the copy: ``int8_holds`` (the card's
    int8 route against its plain float64 version, bit for bit, at every
    distinct int8 conv of ResNet-50 and VGG-19 and the ViT-B/16 projections,
    224 px, B = 32) and ``cli.export --check`` on a vg1k workdir (the trained
    run's config and vocab, a seeded generator; K = 50, B = 32), which must
    exit 0. One JSON line per hold."""
    import torch

    import chip_smoke
    from sgg_torch import export

    if not export.__file__.startswith(root):
        raise SystemExit(f"chip_fault_check: imported {export.__file__}, not the copy")
    if "int8" in kernels:
        shapes = {n: chip_smoke.int8_shapes(n, 224, 32) for n in ("resnet50", "vgg19", "vit_b16")}
        try:
            rows = chip_smoke.int8_holds(dev, "fault check", shapes, lambda fn: float("nan"))
            ok, holds = True, {"shapes": len(rows)}
        except AssertionError as e:
            ok, holds = False, {"error": str(e)}
        print(json.dumps({"shape": [32, 224, 224, 3], "output": "int8", "bf16_gate": ok,
                          "share": 0.0, "f32_err": None, "tol": None, "f32_gate": True,
                          "holds": holds}), flush=True)
    if "export" in kernels:
        from sgg_torch.cli import export as export_cli
        from sgg_torch.config import Config
        from sgg_torch.data import Vocab
        from sgg_torch.train.checkpoint import save_generator
        from sgg_torch.train.state import make_generator

        run = os.path.join(ROOT, "results", "run_v3_bal0.7_ckpt")
        with open(os.path.join(run, "config.json")) as f:
            cfg = Config.from_dict(json.load(f))
        vocab = Vocab.load(os.path.join(run, "vocab.json"))
        cfg.model.vocab_size = len(vocab)
        with tempfile.TemporaryDirectory() as wd:
            cfg.workdir = wd
            with open(os.path.join(wd, "config.json"), "w") as f:
                f.write(cfg.to_json())
            vocab.save(os.path.join(wd, "vocab.json"))
            torch.manual_seed(0)
            save_generator(wd, make_generator(cfg).state_dict(), step=1)
            rc = export_cli.main(["--workdir", wd, "--check", "--num-samples", "50",
                                  "--batch-size", "32"])
        print(json.dumps({"shape": [32, 50, 3], "output": "export --check", "bf16_gate": rc == 0,
                          "share": 0.0, "f32_err": None, "tol": None, "f32_gate": True,
                          "holds": {"rc": rc}}), flush=True)


def dp_rows(root):
    """chip_smoke.py's phase-24 holds (``dp_holds``) on the copy: its train
    CLI over two ranks that share the card (gloo, ``dp_launch``) and in a
    plain process, ``--config smoke`` for DP_STEPS steps: the ranks' states
    equal bit for bit, their noise distinct, rank 0's the plain run's. One
    JSON line."""
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        recs = {}
        for label, n in (("ranks", 2), ("plain", None)):
            argv = ["--config", "smoke", "--workdir", os.path.join(tmp, f"wd_{label}"),
                    "--steps", str(DP_STEPS), "--set", "train.log_every=1"]
            recs[label], _ = chip_smoke.dp_launch(os.path.join(tmp, label), argv, n, root=root)
        ok, bad = chip_smoke.dp_holds(recs["ranks"], recs["plain"][0])
    print(json.dumps({"shape": [2, 8, 9, 16], "output": "dp", "bf16_gate": ok, "share": 0.0,
                      "f32_err": None, "tol": None, "f32_gate": True,
                      "holds": {"failed": bad}}), flush=True)


def loader_rows():
    """chip_smoke.py's phase-21 (a) gates on the copy's JPEG loader: the
    fixture's JPEGs against the reference decoder's committed bytes, and the
    resize and the batch bit for bit against the plain resize of the
    loader's own decode. One JSON line."""
    import chip_smoke

    try:
        r = chip_smoke.loader_phase()
        ok, holds = True, {"route": r["route"], "mean": r["mean"], "max": r["max"]}
    except AssertionError as e:
        ok, holds = False, {"error": str(e)}
    print(json.dumps({"shape": [32, 224, 224, 3], "output": "loader", "bf16_gate": ok,
                      "share": 0.0,
                      "f32_err": None, "tol": None, "f32_gate": True, "holds": holds}),
          flush=True)


def decode_rows(root, dev):
    """The batched fused_decode at vg1k widths, bf16, under chip_smoke.py's
    phase-3 gates, on its inputs (the trained run's config and vocab,
    seeded weights and features, the same draws), and its exact-tie case;
    one JSON line per batch size and one for the tie."""
    import torch

    from sgg_torch.config import Config
    from sgg_torch.data import Vocab
    from sgg_torch.kernels import fused_decode as fd
    from sgg_torch.models.generator import AttentionLSTMGenerator
    from sgg_torch.utils.gumbel import sample_gumbel

    run = os.path.join(ROOT, "results", "run_v3_bal0.7_ckpt")
    with open(os.path.join(run, "config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    vocab = Vocab.load(os.path.join(run, "vocab.json"))
    cfg.model.vocab_size = len(vocab)
    R, F, Z, V = cfg.data.regions, cfg.data.feat_dim, cfg.model.noise_dim, len(vocab)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.manual_seed(0)
    sd = AttentionLSTMGenerator.from_config(cfg).state_dict()
    mb = fd.step_mask_bias(vocab.step_mask(), dev)
    feats_all = torch.randn(max(DECODE_BATCHES), R, F, generator=gen, device=dev)
    params = fd.decode_params_from_generator(sd, torch.bfloat16, dev)

    def draws(B):
        return (torch.randn(B, Z, generator=gen, device=dev).to(torch.bfloat16),
                sample_gumbel((B, 3, V), gen, device=dev))

    for B in DECODE_BATCHES:  # the float32 cases' draws, as chip_smoke.py takes them
        for _ in range(9):
            draws(B)
    for B in DECODE_BATCHES:
        feats = feats_all[:B].to(torch.bfloat16).contiguous()
        z, g = draws(B)
        y = fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=False)
        torch.cuda.synchronize()
        want = fd.decode_plain(params, feats, z, g, mask_bias=mb, hard=False).float()
        diff = (y.float() - want).abs()
        rel = (diff.amax(-1) / want.abs().amax(-1)).max().item()
        share = (diff > 0).float().mean().item()
        same = total = 0
        for _ in range(8):
            z, g = draws(B)
            yh = fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=True)
            torch.cuda.synchronize()
            wh = fd.decode_plain(params, feats, z, g, mask_bias=mb, hard=True)
            same += (yh.argmax(-1) == wh.argmax(-1)).sum().item()
            total += B * 3
        ok = (rel <= 1e-2 and share <= 5e-3 and same / total >= 0.99
              and bool(torch.isfinite(y.float()).all()))
        print(json.dumps({"shape": [B, R, F, V], "output": "decode y", "bf16_gate": ok,
                          "share": share, "f32_err": None, "tol": None, "f32_gate": True,
                          "reach": {"gates": True, "tie": False}}), flush=True)
    B = max(DECODE_BATCHES)
    feats = feats_all[:B].to(torch.bfloat16).contiguous()
    z, g = draws(B)
    n1, n2 = 5, 5 + 32 * 6
    tied = dict(params, wv=params["wv"].clone(), bv=params["bv"].clone())
    tied["wv"][:, n2] = tied["wv"][:, n1]
    tied["bv"][[n1, n2]] = 100.0
    g[:, :, n2] = g[:, :, n1]
    yk = fd.fused_decode(tied, feats, z, g, hard=True)
    torch.cuda.synchronize()
    ok = bool((yk.argmax(-1) == n1).all())
    print(json.dumps({"shape": [B, n1, n2, V], "output": "decode tie", "bf16_gate": ok,
                      "share": (yk.argmax(-1) != n1).float().mean().item(), "f32_err": None,
                      "tol": None, "f32_gate": True, "reach": {"gates": False, "tie": True}}),
          flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        _, _, root, kernels, shapes = sys.argv
        child(root, kernels.split(","), json.loads(shapes))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_fault_check: CUDA is not available; this script needs the card")
    only = sys.argv[2].split(",") if len(sys.argv) > 2 and sys.argv[1] == "--only" else None
    runs = [("sound", [],
             "fwd,dq,dkv,conv,mm,decode,gather,graph,loader,moe,pretrain,int8,export,dp,cnn",
             VARIANT_SHAPES),
            ("one accumulator", [(s, replace_once(a, b)) for s, a, b in ONE_ACCUMULATOR],
             "fwd,dq,dkv", VARIANT_SHAPES)]
    for src, tag, kernel in SITES:
        for cut, zeroed in CUTS.items():
            runs.append((f"{cut} at {tag[3:]}",
                         [(src, lambda t, tag=tag, z=zeroed: cut_site(t, tag, z))], kernel, SHAPES))
    for label, (sound, faulty) in CONV_FAULTS.items():
        runs.append((label, [(CONV_SRC, replace_once(sound, faulty))], "conv", []))
    for label, (sound, faulty, _) in MM_FAULTS.items():
        runs.append((label, [(MM_SRC, replace_once(sound, faulty))], "mm", []))
    for label, (sound, faulty, _) in DECODE_FAULTS.items():
        runs.append((label, [(DECODE_SRC, replace_once(sound, faulty))], "decode", []))
    for label, (sound, faulty) in GATHER_FAULTS.items():
        runs.append((label, [(GATHER_SRC, replace_once(sound, faulty))], "gather", []))
    for label, (sound, faulty) in GRAPH_FAULTS.items():
        runs.append((label, [(GATHER_SRC, replace_once(sound, faulty))], "graph", []))
    for label, (sound, faulty) in LOADER_FAULTS.items():
        runs.append((label, [(LOADER_SRC, replace_once(sound, faulty))], "loader", []))
    for label, (src, sound, faulty, hold) in dict(RECIPE_FAULTS, **DEPLOY_FAULTS,
                                                  **DP_FAULTS, **CNN_FAULTS).items():
        runs.append((label, [(src, replace_once(sound, faulty))], hold, []))
    if only:
        runs = [r for r in runs[2:] if any(t in r[0] for t in only)]
        reach = sorted({k for r in runs for k in r[2].split(",")})
        runs.insert(0, ("sound", [], ",".join(reach), VARIANT_SHAPES))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, (label, edits, kernels, shapes) in enumerate(runs):
            root = make_copy(tmp, f"copy{i}", edits)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", root, kernels,
                 json.dumps(shapes)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate()[0] for p in procs]
    ok = True
    for (label, _, _, _), proc, out in zip(runs, procs, outs):
        rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not rows:
            print(f"[chip_fault_check] {label}: the run failed ({proc.returncode}):\n{out}",
                  flush=True)
            ok = False
            continue
        for r in rows:
            f32 = ("" if r["f32_err"] is None else f", float32 result rel L2 "
                   f"{r['f32_err']:.3e} (<= {r['tol']:.2e}: {r['f32_gate']})")
            guards = "" if "guards" not in r else f", rows around out untouched {r['guards']}"
            guards += "" if "holds" not in r else f", holds {r['holds']}"
            print(f"[chip_fault_check] {label}, {r['shape']} {r['output']}: share of bf16 "
                  f"outputs differing {r['share']:.3e} (bf16 gate {r['bf16_gate']}){f32}"
                  f"{guards}", flush=True)
        # A kernel passes at a shape when every output it gives passes both
        # gates. A matmul fault is held only where it can change an output,
        # a decode fault only by the check that can see it.
        faults = dict(MM_FAULTS, **DECODE_FAULTS)
        reach = faults[label][2] if label in faults else "all"
        for shape in sorted({tuple(r["shape"]) for r in rows}, key=lambda t: -t[2]):
            at = [r for r in rows if tuple(r["shape"]) == shape]
            passes = all(r["bf16_gate"] and r["f32_gate"] for r in at)
            if label == "sound":
                verdict, good = ("passes" if passes else "FAILS"), passes
            elif label == "one accumulator":
                verdict, good = f"reported: the gates {'pass' if passes else 'refuse'} it", True
            elif not all(r.get("reach", {}).get(reach, True) for r in at):
                verdict, good = (f"reported: cannot reach this shape; the gates "
                                 f"{'pass' if passes else 'refuse'} it"), True
            else:
                verdict, good = ("refused" if not passes else "PASSES THE GATES"), not passes
            ok = ok and good
            print(f"[chip_fault_check] {label}, {list(shape)}: {verdict}", flush=True)
    print(f"[chip_fault_check] {'every fault is refused' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
