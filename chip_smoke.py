#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``sgg_torch``) on one NVIDIA H100.

  python3 chip_smoke.py

In one process, with no threads and no sockets:
  1. device: CUDA present, compute capability 9.0; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: nvcc compiles ``sgg_torch/kernels/csrc/*.cu`` for sm_90a, one
     process per source, all at once; wall time and the compilers' CPU time
     (about what one process after another would take), and ptxas's
     registers and spills for each kernel;
  3. fused_decode vs plain: ``fused_decode`` against ``decode_plain`` at the
     trained run's widths (V from its vocab.json, R=196, F=512, H=512, E=256,
     A=256, Z=128), seeded weights, the real step mask, B = 64 and B = 37, and
     at the resnet50 widths (R=49, F=2048, V=8192, B = 32), float32 and
     bfloat16: soft, every (row, step) within 1e-4 (f32) or 1e-2 (bf16) of
     that row's largest value, and at vg1k widths at most 0.5 % of the bf16
     y differing from plain at all; hard, tokens identical for >= 99.9 %
     (f32) or >= 99 % (bf16) of 8 draws; the bf16 cases run the batched
     instance, float32 the generic one; and the generic instance's 16-row
     tile at vg1k widths, B = 64, under the same 0.5 % share gate; then the
     batched instance exactly, at vg1k widths (B = 64) and resnet50 widths
     (B = 64): an exact tie (wv's and bv's column n2 copied from n1 < n2,
     in items that different blocks take, the Gumbel noise copied, no mask)
     where kernel and plain must pick n1 in every row and step, two
     launches bit for bit, and B = 37 bit for bit rows 0-36 of B = 64;
  4. fused_matmul vs plain at every ResNet-50 1x1-conv shape of the pixels-in
     path (B = 32 at 224 px), at VGG-19's first im2col shape and at five
     ragged shapes (M not a multiple of the tile, K = 16 and 80, N = 8 and
     72; the last with a inside seeded guard rows, so its last M tile
     straddles a's end), bfloat16 with and without ReLU and float32, each
     with the instance, tile and block count that ``matmul.plan`` gives and
     the share of outputs that differ from plain at all; conv_direct vs
     plain at the four ResNet-50 3x3 stride-1 shapes, two VGG-19 shapes and
     four shapes that put an image boundary and the SAME halo inside one
     tile with ragged M and Cout ([3,7,7,512]->512, [2,9,13,64]->72,
     [1,5,5,32]->16 at 3x3 and [2,14,14,64]->64 at 5x5), float32 and
     bfloat16, each with the instance, tile and block count that
     ``conv_direct.plan`` gives and the share of outputs that differ from
     plain at all;
  5. encoders vs plain: ResNet-50 (seeded weights, random BN statistics) and
     VGG-19 (under 'direct' and under 'pallas') on 8 seeded 224 px images,
     the kernel routes against the library route ('xla'): float32 within
     1e-4; bfloat16 no further from the float32 result than the bf16
     library route is (rel L2 within 1.5x, max within 3x), and against the
     bf16 library route: ResNet-50 block by block (each block fed the
     library route's input; at most 1 % of elements differ, rel L2 within
     1e-3), VGG-19 end to end (within 2e-2 x max, rel L2 within 1.5e-2);
  6. main path, precomputed features: ``python -m sgg_torch.cli.generate
     --decode fused`` (in process) on a port workdir with the trained run's
     config.json and vocab.json, seeded generator weights and 512 seeded feature images,
     K = 50 draws, batch 64; fused_decode must launch exactly
     ceil(512/64) * 50 times; the output JSON is read back and checked; one
     batch of the CUDA sampler is held against the same sampler on the CPU
     (plain version) given the same noise;
  7. main path, pixels in: the same CLI (``--decode fused``) on a
     ``resnet50``-config workdir
     (seeded 8192-entry vocab, seeded generator and encoder weights) over 256
     synthetic 224 px images, batch 32, K = 50: conv_direct, fused_matmul and
     fused_decode must launch exactly 8 * 13, 8 * 36 and 8 * 50 times;
     images/s and triples/s; the output JSON is read back and checked;
  8. timing: ms per launch (CUDA events, warm, in turns plain, kernel,
     kernel, plain) of each kernel at every shape of phases 3-4 that the main
     paths use, beside its plain version, the library call that computes the
     same product (torch.matmul, or F.conv2d on channels-last bf16; both
     without the epilogue) and the bound: max(bytes over 3.35 TB/s, FLOPs over
     the type's peak; fused_decode's in hard mode, whose feedback reads the
     chosen rows of emb, with the soft-mode bound printed beside it);
     fused_decode also on the device's clock (its cooperative launch
     captured in a CUDA graph), its generic instance on the same inputs,
     its per-phase split (the timed check-only entry: block 0's
     %globaltimer at every grid barrier) and its wrapper's host us per call
     at a tiny width against a limit of 60;
     fused_matmul and conv_direct also on the device's
     clock (each call captured in a CUDA graph, so the wrapper's host cost
     drops out), with torch.matmul or F.conv2d and the generic instance (the
     tile core the two share, each kernel's earlier design) on the same bf16
     inputs, printed apart from the record, launch-weighted, and each
     wrapper's host cost per call; and the ResNet-50 encoder on one batch of
     phase 7 (B = 32) on the kernel route against the library route, and in
     ten pairs against itself with its 3x3 convs, then its 1x1 convs, on the
     generic instance, eager and in one CUDA graph;
  9. flash_attention vs plain at [32, 12, 196, 64] (ViT-B/16 at 224 px),
     [32, 12, 576, 64] (384 px) and a ragged S = 100, float32 and bfloat16,
     with and without lse: float32 within 1e-4 x max; bf16 within one bf16
     ulp of plain plus that, and at most 1 % of the outputs differing at all
     (the share is printed); lse within 1e-5 relative; and for bf16 the
     kernel's float32 result before its cast (acc / l, from the check-only
     entry) against the plain version in float32 from the same inputs: a
     relative L2 distance within ``flash_attention.F32_RESULT_TOL``, while
     p's split cut to hi + mid (plain, emulated) must land above it; both
     margins printed;
 10. ViT-B/16 encoder (seeded weights) on 8 seeded 224 px images, the kernel
     route (use_pallas) against the plain route (attention by
     ``flash_attention_plain``): float32 within 1e-4 x max; bfloat16 block
     by block, each block fed the plain route's input (at most 7 % of a
     block's elements differ, rel L2 within 2e-3);
 11. main path, ``vit_b16``: the CLI (``--decode xla``) on a
     ``vit_b16``-config workdir (seeded 1024-entry vocab, seeded generator
     and encoder weights) over 256 synthetic 224 px images, batch 32,
     K = 50: flash_attention must launch exactly 8 * 12 times and the other
     kernels not at all; images/s and triples/s; the output JSON is read
     back and checked; one batch of the CUDA sampler against the CPU
     sampler (plain versions) given the same features and noise;
 12. timing: flash_attention per launch at both ViT shapes beside its plain
     version, ``F.scaled_dot_product_attention`` on the same bf16 tensors
     (timed only; the port never calls it) and the bound; the ViT-B/16
     encoder on one batch of 32 on the kernel route against the plain route;
 13. flash backward vs plain (the dq and dk/dv kernels) at the shapes of
     phase 9, float32 and bfloat16: dq, dk and dv in float32 within
     1e-4 x max; bf16 within one bf16 ulp of plain plus that, and at most 1 %
     of the outputs differing at all (the share is printed);
     ``torch.autograd.grad`` through ``flash_attention`` gives the kernels'
     own result; a seeded fault, the plain backward with p and ds rounded
     to bf16 before the three products that take them, must fail the gate;
     and for bf16 the kernels' float32 dq, dk, dv before the cast within
     ``flash_attention.F32_RESULT_TOL`` (relative L2) of plain in float32,
     with p and ds split cut to hi + mid (plain, emulated) above it;
 14. ViT-B/16 gradients (seeded weights, 8 seeded 224 px images, a fixed
     linear loss), the kernel route against the plain route: every
     parameter's gradient in float32 within 1e-4 x its max; in bfloat16 no
     further from the float32 plain gradients than the bf16 plain route is
     (worst parameter's rel L2 and the rel L2 over all parameters, each
     within 1.5x); exactly 12 launches of each of the three flash kernels;
 15. main path, training: ``python -m sgg_torch.cli.train --config vit_b16
     --set train.train_encoder=true`` (in process) at the config's widths,
     batch 32, n_critic 5, over 256 seeded synthetic 224 px images, 3
     steps: exactly 72 flash_attention, 60 dq and 60 dk/dv launches per step
     and no other kernel; finite losses; every encoder tensor moved;
     metrics.jsonl and the checkpoint read back; s/step, images/s and peak
     device memory; then ``sgg_torch.cli.generate`` on that workdir (K = 4)
     with its output read back; one step at V = 1024 through the same entry
     points (state, step, device iterator) with a seeded 1024-entry vocab and
     the same launch counts; and ``--config vg1k`` for 3 steps with no kernel
     launch;
 16. timing: the dq and the dk/dv kernels at [32, 12, 196, 64] bf16 beside
     their plain versions, the backward of ``scaled_dot_product_attention``
     (``torch.autograd.grad`` of its output; timed only) and the bound, with
     the float32 CUDA-core floor of the products that take p or ds as a
     reference line (the products now run on the tensor cores).

The kernels' JSON record gives, for each kernel, its launches on the newest
main path that runs it (phase 7; phase 15 for the three flash kernels) and
launch-weighted means over that path's shapes of ms, plain ms, library ms and
bound ms. The last two lines are that
record and the device JSON. A failed check raises, so the exit code is not 0;
a watchdog turns a hang into a stack trace and a non-zero exit.
"""

import faulthandler
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time

WATCHDOG_SECONDS = 600
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAINED_RUN = os.path.join(ROOT, "results", "run_v3_bal0.7_ckpt")
SEED = 0
N_IMAGES, BATCH, K = 512, 64, 50
PIX_IMAGES, PIX_BATCH, PIX_VOCAB = 256, 32, 8192
VIT_IMAGES, VIT_BATCH, VIT_VOCAB = 256, 32, 1024
TRAIN_STEPS = 3
DECODE_HOST_US_LIMIT = 60  # fused_decode's wrapper, host us per call at a tiny width
# [B, H, S, D] of the ViT-B/16 self-attention at 224 px (the main path) and
# 384 px, and a ragged S.
FLASH_SHAPES = [(32, 12, 196, 64), (32, 12, 576, 64), (32, 12, 100, 64)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores

# ResNet-50's 1x1 convs on the pixels-in path at B = 32, 224 px, as
# (M, K, N, relu, launches per batch): conv1 (ReLU), conv3 and the
# projections (no ReLU), stage by stage.
RESNET_1X1 = [
    (100352, 64, 64, True, 1), (100352, 256, 64, True, 2),
    (100352, 64, 256, False, 4),
    (100352, 256, 128, True, 1), (25088, 512, 128, True, 3),
    (25088, 128, 512, False, 4), (25088, 256, 512, False, 1),
    (25088, 512, 256, True, 1), (6272, 1024, 256, True, 5),
    (6272, 256, 1024, False, 6), (6272, 512, 1024, False, 1),
    (6272, 1024, 512, True, 1), (1568, 2048, 512, True, 2),
    (1568, 512, 2048, False, 3), (1568, 1024, 2048, False, 1),
]
VGG_IM2COL = (401408, 27, 64, True, 0)  # conv1_1 at B = 8, 224 px
# Ragged shapes for fused_matmul's tiled instance, checked only, as (M, K,
# N, relu, guard rows): M not a multiple of the tile, K = 16 and 80, N = 8
# and 72; the last sits inside 128 seeded rows on each side, so its last M
# tile straddles the end of a into them.
MM_EDGES = [(1000, 16, 72, True, 0), (300, 80, 8, False, 0), (777, 80, 72, True, 0),
            (129, 48, 264, False, 0), (1568, 2048, 512, True, 128)]
# ResNet-50's 3x3 stride-1 convs: (x shape, Cout, launches per batch), then
# two VGG-19 shapes that the path does not run.
RESNET_3X3 = [
    ((32, 56, 56, 64), 64, 3), ((32, 28, 28, 128), 128, 3),
    ((32, 14, 14, 256), 256, 5), ((32, 7, 7, 512), 512, 2),
]
VGG_3X3 = [((8, 224, 224, 3), 64, 0), ((8, 56, 56, 256), 256, 0)]
# Shapes that put an image boundary and the SAME halo inside one tile, ragged
# M and Cout: (x shape, Cout, kernel), checked only.
CONV_EDGES = [((3, 7, 7, 512), 512, 3), ((2, 9, 13, 64), 72, 3), ((1, 5, 5, 32), 16, 3),
              ((2, 14, 14, 64), 64, 5)]


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def phase(name, t0):
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")


def bound(nbytes, flops, flops_per_s):
    """Least time (s) for the work: bytes over the HBM rate against the
    arithmetic over the type's peak → (seconds, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(text):
    """(kernel, registers line, spill line) for each entry function in the
    build log's ptxas -v output, the names demangled by c++filt."""
    rows, name, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            rows.append([name, line.split(":", 1)[-1].strip(), spills])
            name = None
    try:
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60, check=True).stdout
        for r, n in zip(rows, out.splitlines()):
            r[0] = n.replace("(anonymous namespace)::", "").split("(")[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def decode_work(B, R, F, A, H, E, Z, V, dtype_bytes, hard=True):
    """(bytes, FLOPs) of one fused_decode launch: each input read once and
    the output written once; the arithmetic of the 3-step decode. In hard
    mode y is a one-hot, so the feedback rnd(y @ emb) is the chosen row of
    emb: 3 rows per batch row are read and no y @ emb is computed."""
    K_ = F + E + Z + H
    weights = F * A + H * A + A + F * H * 2 + K_ * 4 * H + (H + F) * E + E * V
    emb = 3 * B * E if hard else V * E
    biases = A + 2 * H + 4 * H + E + V
    nbytes = (B * R * F + B * Z + weights + emb + B * 3 * V) * dtype_bytes \
        + (B * 3 * V + 3 * V + biases) * 4
    feedback = 0 if hard else V * E
    flops = (2 * B * R * F * A + B * R * F + 2 * 2 * B * F * H
             + 3 * 2 * B * (H * A + R * A + R * F + K_ * 4 * H + (H + F) * E + E * V + feedback))
    return nbytes, flops


def matmul_work(M, K_, N, isz):
    return (M * K_ + K_ * N + M * N) * isz + 2 * N * 4, 2 * M * N * K_


def conv_work(shape, cout, k, isz):
    B, H, W, C = shape
    return ((B * H * W * C + k * k * C * cout + B * H * W * cout) * isz + 2 * cout * 4,
            2 * B * H * W * k * k * C * cout)


def flash_work(shape, isz):
    """(bytes, FLOPs) of one attention forward: q, k, v read once, o written
    once; q.kT and P.V."""
    B, H, S, D = shape
    return 4 * B * H * S * D * isz, 4 * B * H * S * S * D


def main():
    faulthandler.dump_traceback_later(WATCHDOG_SECONDS, exit=True)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs the card")
    sys.path.insert(0, ROOT)
    from collections import Counter

    import numpy as np
    import torch.nn.functional as Fnn

    from sgg_torch.cli import generate
    from sgg_torch.cli import train as train_cli
    from sgg_torch.config import Config, get_config
    from sgg_torch.data import Vocab, write_feature_shard
    from sgg_torch.data.shards import shard_name
    from sgg_torch.eval.sampler import make_fused_sampler
    from sgg_torch.kernels import build
    from sgg_torch.kernels import conv_direct as cd
    from sgg_torch.kernels import flash_attention as fa
    from sgg_torch.kernels import flash_attention_bwd as fb
    from sgg_torch.kernels import fused_decode as fd
    from sgg_torch.kernels import matmul as mm
    from sgg_torch.models.encoders import normalize_for
    from sgg_torch.kernels.conv import max_pool_nhwc
    from sgg_torch.models.resnet import ResNet50Features
    from sgg_torch.models.vgg import VGG19Features
    from sgg_torch.models.generator import AttentionLSTMGenerator
    from sgg_torch.models.transformer import TransformerTripleGenerator
    from sgg_torch.models.vit import ViTB16Features
    from sgg_torch.eval.sampler import make_sampler
    from sgg_torch.data import ArrayImageTripleDataset
    from sgg_torch.data.pipeline import make_device_train_iterator
    from sgg_torch.train.checkpoint import CheckpointManager, load_workdir, save_generator
    from sgg_torch.train.state import create_train_state
    from sgg_torch.train.step import make_step_fn
    from sgg_torch.utils.gumbel import sample_gumbel

    t_all = time.perf_counter()
    dev = torch.device("cuda")

    def time_ms(fn, target_s=0.05):
        """Mean ms per call over a warm run of about target_s."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        n = int(min(200, max(3, target_s / max(time.perf_counter() - t0, 1e-6))))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def graph_ms(fn, n=20, reps=5):
        """Mean ms per call of fn on the device: n calls captured in one CUDA
        graph, replayed reps times, warm. The host's cost per call does not
        enter, as it does in time_ms once a kernel takes less than that."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (n * reps)

    def in_turns(kernel, plain):
        """(kernel ms, plain ms): the lower of two turns each, taken plain,
        kernel, kernel, plain."""
        p1 = time_ms(plain)
        k1 = time_ms(kernel)
        k2 = time_ms(kernel)
        p2 = time_ms(plain)
        return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)

    def bf16_ulp(want):
        """One bfloat16 ulp of each value (0 where the value is 0)."""
        w = want.float()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs())[1] - 8)
        return torch.where(w == 0, torch.zeros_like(ulp), ulp)

    def one_ulp_gate(got, want, f32_tol):
        """bf16 kernel vs plain: within one bf16 ulp of the plain value plus
        the float32 gate (both round float32 sums taken in another order)."""
        return bool(((got.float() - want.float()).abs() <= bf16_ulp(want) + f32_tol).all())

    def cut_split(x, n):
        """x with its three-way bf16 split cut to the first n terms, float32."""
        return sum(t_.float() for t_ in fa.split3(x)[:n])

    def f32_result_gate(name, errs, faults, tol):
        """The float32 results before the cast: every sound relative L2
        distance within tol and every cut-split fault's above it."""
        ok = max(errs) <= tol < min(faults)
        log(f"{name} float32 result before the cast vs plain in float32: rel L2 "
            f"{', '.join(f'{e:.3e}' for e in errs)} (<= {tol:.2e}, margin "
            f"{tol / max(max(errs), 1e-30):.2f}x); split cut to hi + mid (plain) "
            f"{', '.join(f'{e:.3e}' for e in faults)} (> {tol:.2e}, margin "
            f"{min(faults) / tol:.2f}x): {'ok' if ok else 'FAILED'}")
        return ok

    # 1. Device.
    t0 = time.perf_counter()
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"expected a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    phase("device", t0)

    # 2. Build.
    t0 = time.perf_counter()
    cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    lib_path, build_s = build.build()
    cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu_s = cpu1.ru_utime + cpu1.ru_stime - cpu0.ru_utime - cpu0.ru_stime
    log(f"nvcc build: {build_s:.2f} s wall, {cpu_s:.2f} s of compiler CPU time over "
        f"{len(build.sources())} sources and the link -> {os.path.relpath(lib_path, ROOT)}")
    for name, regs, spills in ptxas_report((build.BUILD_DIR / "build.log").read_text()):
        log(f"ptxas: {name}: {regs}; {spills}")
    lib = build.load_library()
    phase("build", t0)

    # 3. fused_decode vs plain, at the trained run's widths and at resnet50's.
    t0 = time.perf_counter()
    with open(os.path.join(TRAINED_RUN, "config.json")) as f:
        run_cfg = json.load(f)
    vocab = Vocab.load(os.path.join(TRAINED_RUN, "vocab.json"))
    cfg = Config.from_dict(run_cfg)
    cfg.model.vocab_size = len(vocab)
    m = cfg.model
    R, F, A, H, E, Z, V = (cfg.data.regions, cfg.data.feat_dim, m.attn_dim,
                           m.hidden, m.embed_dim, m.noise_dim, m.vocab_size)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    rng = np.random.default_rng(SEED)
    pix_vocab = Vocab.build(
        Counter({f"object{i}": int(c) for i, c in enumerate(rng.integers(1, 10**6, 7190))}),
        Counter({f"predicate{i}": int(c) for i, c in enumerate(rng.integers(1, 10**6, 1000))}),
    )
    assert len(pix_vocab) == PIX_VOCAB, len(pix_vocab)
    pix_cfg = get_config("resnet50")
    pix_cfg.data.num_synthetic_images = PIX_IMAGES
    pix_cfg.model.vocab_size = PIX_VOCAB
    pm = pix_cfg.model
    pix_widths = (pix_cfg.data.regions, pix_cfg.data.feat_dim, pm.attn_dim, pm.hidden,
                  pm.embed_dim, pm.noise_dim, PIX_VOCAB)

    def check_decode(cfg_, vocab_, batches, label, share_tol=None, row_tile=None):
        Rq, Fq = cfg_.data.regions, cfg_.data.feat_dim
        Zq, Vq = cfg_.model.noise_dim, cfg_.model.vocab_size
        torch.manual_seed(SEED)
        sd = AttentionLSTMGenerator.from_config(cfg_).state_dict()
        mb = fd.step_mask_bias(vocab_.step_mask(), dev)
        feats_all = torch.randn(max(batches), Rq, Fq, generator=gen, device=dev)
        errs = {}
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            params = fd.decode_params_from_generator(sd, dtype, dev)
            for B in batches:
                feats = feats_all[:B].to(dtype).contiguous()
                z = torch.randn(B, Zq, generator=gen, device=dev).to(dtype)
                g = sample_gumbel((B, 3, Vq), gen, device=dev)
                y = fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=False,
                                    row_tile=row_tile)
                torch.cuda.synchronize()
                want = fd.decode_plain(params, feats, z, g, mask_bias=mb, hard=False)
                diff = (y.float() - want.float()).abs()
                err = diff.max().item()
                # Each (row, step) against its own largest value: at V = 8192
                # a typical y is ~1e-4, so an absolute bound says little.
                row_max = want.float().abs().amax(-1)
                rel = (diff.amax(-1) / row_max).max().item()
                big = want.float().abs() >= 1e-3 * row_max[..., None]
                ulps = (diff / bf16_ulp(want))[big].max().item()
                moved = (diff > 0).float()
                share, row_share = moved.mean().item(), moved.amax(-1).mean().item()
                # Token agreement over 8 noise draws: 8 * B * 3 (row, step) pairs.
                same = total = 0
                for _ in range(8):
                    z = torch.randn(B, Zq, generator=gen, device=dev).to(dtype)
                    g = sample_gumbel((B, 3, Vq), gen, device=dev)
                    yh = fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=True,
                                         row_tile=row_tile)
                    torch.cuda.synchronize()
                    wh = fd.decode_plain(params, feats, z, g, mask_bias=mb, hard=True)
                    same += (yh.argmax(-1) == wh.argmax(-1)).sum().item()
                    total += yh.shape[0] * 3
                agree = same / total
                tol, need = (1e-4, 0.999) if dtype == torch.float32 else (1e-2, 0.99)
                # bf16: kernel and plain round at the same points, so only a
                # float32 sum taken in another order moves a y by an ulp; at
                # vg1k widths a rounding the kernel skips (of ctx, h or c)
                # moves over ten times as many. At resnet50 widths the sums
                # alone move about 2 %, so the share is only reported there.
                share_max = share_tol if dtype == torch.bfloat16 else None
                ok = (rel <= tol and agree >= need and bool(torch.isfinite(y.float()).all())
                      and (share_max is None or share <= share_max))
                p_ = fd.plan(B, Rq, Fq, cfg_.model.attn_dim, cfg_.model.hidden,
                             cfg_.model.embed_dim, Zq, Vq, dtype, mm.sm_count(0), row_tile)
                log(f"fused_decode vs plain, {label} {name} B={B} ({p_.instance} instance): "
                    f"soft max_abs_err "
                    f"{err:.3e}, max_abs_err / row max {rel:.3e} (<= {tol}), max bf16 "
                    f"ulps where y >= 1e-3 x row max {ulps:.2f}, share of y differing "
                    f"{share:.3e}{f' (<= {share_max})' if share_max else ''}, of rows "
                    f"{row_share:.3e}; hard tokens identical "
                    f"{agree:.5f} of {total} (>= {need}) {'ok' if ok else 'FAILED'}")
                if not ok:
                    failed.append(f"{label} {name} B={B}")
                errs[(name, B)] = err
        return sd, errs

    log(f"widths vg1k: V={V} R={R} F={F} A={A} H={H} E={E} Z={Z} compute={m.compute_dtype}; "
        f"generic row tile {fd.plan(BATCH, R, F, A, H, E, Z, V, torch.float32).row_tile}")
    failed = []
    sd, _ = check_decode(cfg, vocab, (BATCH, 37), "vg1k", share_tol=5e-3)
    # The 16-row instance, which resnet50 widths run, where the share of y
    # that differs can tell a skipped rounding (at resnet50 widths the sums
    # alone move about 2 %).
    check_decode(cfg, vocab, (BATCH,), "vg1k row tile 16", share_tol=5e-3, row_tile=16)
    log(f"widths resnet50: R, F, A, H, E, Z, V = {pix_widths}; generic row tile "
        f"{fd.plan(PIX_BATCH, *pix_widths, torch.float32).row_tile}")
    pix_sd, pix_errs = check_decode(pix_cfg, pix_vocab, (PIX_BATCH,), "resnet50")

    def check_batched(cfg_, sd_, B, label):
        """The batched bf16 instance, exactly: (i) an exact tie, where wv's
        and bv's column n2 is a copy of n1 < n2, 32 * 6 columns on (so the
        two lie in items that different blocks take), with the Gumbel noise
        copied too and no mask: both columns hold the maximum of every row
        and step and the kernel must pick n1, as decode_plain does; (ii) two
        launches on the same inputs give the same bits, soft and hard;
        (iii) B = 37 gives rows 0-36 of the B call bit for bit."""
        Rq, Fq, Zq, Vq = (cfg_.data.regions, cfg_.data.feat_dim, cfg_.model.noise_dim,
                          cfg_.model.vocab_size)
        params = fd.decode_params_from_generator(sd_, torch.bfloat16, dev)
        g_tie = torch.Generator(device=dev).manual_seed(SEED + 41)  # leaves gen's stream as it was
        feats = torch.randn(B, Rq, Fq, generator=g_tie, device=dev).to(torch.bfloat16)
        z = torch.randn(B, Zq, generator=g_tie, device=dev).to(torch.bfloat16)
        g = sample_gumbel((B, 3, Vq), g_tie, device=dev)
        n1, n2 = 5, 5 + 32 * 6
        p_ = fd.plan(B, Rq, Fq, cfg_.model.attn_dim, cfg_.model.hidden, cfg_.model.embed_dim,
                     Zq, Vq, torch.bfloat16, mm.sm_count(0))
        blocks = {n: next(b_ for b_, cols in p_.items("logits") if n in cols) for n in (n1, n2)}
        tied = dict(params)
        tied["wv"] = params["wv"].clone()
        tied["wv"][:, n2] = tied["wv"][:, n1]
        tied["bv"] = params["bv"].clone()
        tied["bv"][[n1, n2]] = 100.0
        gt = g.clone()
        gt[:, :, n2] = gt[:, :, n1]
        yk = fd.fused_decode(tied, feats, z, gt, hard=True)
        torch.cuda.synchronize()
        yp = fd.decode_plain(tied, feats, z, gt, hard=True)
        tie_ok = (p_.instance == "batched" and blocks[n1] != blocks[n2]
                  and bool((yk.argmax(-1) == n1).all()) and bool((yp.argmax(-1) == n1).all()))
        same = True
        for hard in (False, True):
            a_ = fd.fused_decode(params, feats, z, g, hard=hard)
            b_ = fd.fused_decode(params, feats, z, g, hard=hard)
            torch.cuda.synchronize()
            same = same and torch.equal(a_, b_)
        full = fd.fused_decode(params, feats, z, g, hard=False)
        part = fd.fused_decode(params, feats[:37].contiguous(), z[:37].contiguous(),
                               g[:37].contiguous(), hard=False)
        torch.cuda.synchronize()
        rows_ok = torch.equal(part, full[:37])
        ok = tie_ok and same and rows_ok
        log(f"fused_decode batched instance, {label} bf16 B={B}: exact tie at columns {n1} "
            f"(block {blocks[n1]}) and {n2} (block {blocks[n2]}): kernel picks {n1} in every "
            f"row and step {bool((yk.argmax(-1) == n1).all())}, plain "
            f"{bool((yp.argmax(-1) == n1).all())}; two launches bit for bit {same}; B = 37 "
            f"gives rows 0-36 of B = {B} bit for bit {rows_ok}: {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(f"{label} batched exact cases")

    check_batched(cfg, sd, BATCH, "vg1k")
    check_batched(pix_cfg, pix_sd, 64, "resnet50")
    if failed:
        raise AssertionError(f"fused_decode disagrees with decode_plain: {failed}")
    phase("fused_decode_vs_plain", t0)

    # 4. fused_matmul and conv_direct vs plain at the pixels-in path's shapes.
    t0 = time.perf_counter()
    shape_errs = {}

    def mm_inputs(M, K_, N, dtype):
        a = torch.randn(M, K_, generator=gen, device=dev).to(dtype)
        b = (torch.randn(K_, N, generator=gen, device=dev) / K_ ** 0.5).to(dtype)
        bias = 0.1 * torch.randn(N, generator=gen, device=dev)
        scale = 1.0 + 0.1 * torch.randn(N, generator=gen, device=dev)
        return a, b, bias, scale

    def conv_inputs(shape, cout, dtype, k=3):
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        w = (torch.randn(k, k, shape[-1], cout, generator=gen, device=dev)
             / (k * k * shape[-1]) ** 0.5).to(dtype)
        bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
        scale = 1.0 + 0.1 * torch.randn(cout, generator=gen, device=dev)
        return x, w, bias, scale

    def gate(name, got, want, dtype):
        ref = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        f32_tol = 1e-4 * max(ref, 1e-6)
        ok = (got.dtype == want.dtype and got.shape == want.shape
              and bool(torch.isfinite(got.float()).all())
              and (err <= f32_tol if dtype == torch.float32
                   else one_ulp_gate(got, want, f32_tol)))
        log(f"{name}: max_abs_err {err:.3e}, max|plain| {ref:.3e} "
            f"({'<= 1e-4 x max' if dtype == torch.float32 else '<= 1 bf16 ulp + 1e-4 x max'})"
            f" {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return err

    for M, K_, N, relu, guard in ([(M, K_, N, relu, 0) for M, K_, N, relu, _ in
                                    RESNET_1X1 + [VGG_IM2COL]] + MM_EDGES):
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            a, b, bias, scale = mm_inputs(M + 2 * guard, K_, N, dtype)
            a = a[guard:guard + M]  # inside seeded guard rows, where guard > 0
            p_ = mm.plan(M, K_, N, dtype, dtype, mm.aligned(a), mm.aligned(b),
                         mm.sm_count(a.device.index))
            for r_ in ((relu, not relu) if dtype == torch.bfloat16 else (relu,)):
                got = mm.fused_matmul(a, b, bias, scale, relu=r_)
                torch.cuda.synchronize()
                label = f"fused_matmul {name} M={M} K={K_} N={N} relu={r_}"
                want = mm.fused_matmul_plain(a, b, bias, scale, relu=r_)
                err = gate(label, got, want, dtype)
                log(f"{label}: instance {p_.instance}, tile {p_.bm}x{p_.bn}x{p_.bk}, "
                    f"{p_.stages} stages, {p_.threads} threads, {p_.grid[0] * p_.grid[1]} "
                    f"blocks{f', a inside {guard} guard rows on each side' if guard else ''}; "
                    f"share of outputs differing from plain "
                    f"{(got != want).float().mean().item():.3e}")
                shape_errs[("mm", M, K_, N, name, r_, guard)] = err
    conv_cases = [(s_, c_, 3) for s_, c_, _ in RESNET_3X3 + VGG_3X3] + CONV_EDGES
    for shape, cout, k_ in conv_cases:
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, w, bias, scale = conv_inputs(shape, cout, dtype, k=k_)
            got = cd.conv2d_direct(x, w, bias, scale, relu=True)
            torch.cuda.synchronize()
            want = cd.conv2d_direct_plain(x, w, bias, scale, relu=True)
            label = f"conv_direct {name} {list(shape)}->{cout} {k_}x{k_}"
            err = gate(label, got, want, dtype)
            p_ = cd.plan(*shape, cout, k_, k_, dtype, mm.aligned(x), mm.aligned(w),
                         cd.sm_count(x.device.index))
            log(f"{label}: instance {p_.instance}, tile {p_.bm}x{p_.bn}x{p_.bk}, "
                f"{p_.stages} stages, {p_.threads} threads, {p_.grid[0] * p_.grid[1]} blocks; "
                f"share of outputs differing from plain {(got != want).float().mean().item():.3e}")
            shape_errs[("conv", shape, cout, name)] = err
    phase("kernels_vs_plain", t0)

    # 5. Encoders, kernel routes vs the library route, 8 seeded images.
    t0 = time.perf_counter()
    images = torch.from_numpy(
        np.random.RandomState(SEED).randint(0, 256, (8, 224, 224, 3), dtype=np.uint8)).to(dev)
    encoder_cls = {"resnet50": ResNet50Features, "vgg19": VGG19Features}

    def seeded_encoder_state(name):
        torch.manual_seed(SEED + 3)
        sd_ = encoder_cls[name]().state_dict()
        g_ = torch.Generator().manual_seed(SEED + 4)
        for k_, v_ in sd_.items():
            n_ = v_.shape
            if k_.endswith("bn_scale"):
                v_.copy_(1.0 + 0.2 * torch.randn(n_, generator=g_))
            elif k_.endswith("bn_bias") or k_.endswith("bn_mean"):
                v_.copy_(0.1 * torch.randn(n_, generator=g_))
            elif k_.endswith("bn_var"):
                v_.copy_(0.5 + torch.rand(n_, generator=g_))
            elif k_.endswith(".bias"):
                v_.copy_(0.1 * torch.randn(n_, generator=g_))
        return sd_

    def load_encoder(name, state, dtype, impl):
        enc = encoder_cls[name](conv_impl=impl, dtype=dtype)
        enc.load_state_dict(state)
        return enc.to(dev)

    def run_encoder(name, state, dtype, impl, x):
        enc = load_encoder(name, state, dtype, impl)
        before = (cd.launches, mm.launches)
        with torch.no_grad():
            out = enc(x).float()
        torch.cuda.synchronize()
        return out, (cd.launches - before[0], mm.launches - before[1])

    def dist(a, b):
        return (a - b).abs().max().item(), ((a - b).norm() / b.norm()).item()

    def resnet_blocks_bf16(state, x):
        """The bf16 kernel route against the bf16 library route block by
        block, each block fed the library route's output of the block
        before → worst (share of elements that differ, rel L2) over the
        stem and the 16 blocks."""
        ker, lib_ = (load_encoder("resnet50", state, torch.bfloat16, i) for i in ("auto", "xla"))
        worst_frac = worst_rel = 0.0
        with torch.no_grad():
            x16 = x.to(torch.bfloat16)
            pairs = [(ker.stem(x16), lib_.stem(x16))]
            prev = max_pool_nhwc(pairs[0][1], 3, 2, "SAME")
            for name in lib_.blocks:
                want_ = getattr(lib_, name)(prev)
                pairs.append((getattr(ker, name)(prev), want_))
                prev = want_
        for got_, want_ in pairs:
            worst_frac = max(worst_frac, (got_ != want_).float().mean().item())
            worst_rel = max(worst_rel, dist(got_.float(), want_.float())[1])
        return worst_frac, worst_rel

    # float32: the kernel route within 1e-4 of the library route. bfloat16:
    # both routes round to bf16 at the same points, so only a float32 sum
    # taken in another order can flip a rounding, which 16 to 53 layers carry
    # on. The kernel route must stay as close to the float32 library result
    # as the bf16 library route does (rel L2 within 1.5x, max within 3x).
    # ResNet-50 is also held block by block, each block of the kernel route
    # fed the library route's input: at most 1 % of a block's elements
    # differ, rel L2 <= 1e-3 (a misplaced cast moves 15 % or more, as the
    # CPU tests show against the reference). VGG-19 is held end to end to
    # the bf16 library route: max within 2e-2 x max, rel L2 within 1.5e-2.
    for name, impls in (("resnet50", ("auto",)), ("vgg19", ("direct", "pallas"))):
        state = seeded_encoder_state(name)
        x = normalize_for(name, images)
        want, _ = run_encoder(name, state, torch.float32, "xla", x)
        plain16, _ = run_encoder(name, state, torch.bfloat16, "xla", x)
        p_err, p_rel = dist(plain16, want)
        ref, ref16 = want.abs().max().item(), plain16.abs().max().item()
        log(f"encoder {name} xla bf16 vs xla f32: max_abs_err {p_err:.3e} of max "
            f"{ref:.3e}, rel L2 {p_rel:.3e}")
        for impl in impls:
            got, ran = run_encoder(name, state, torch.float32, impl, x)
            err, rel2 = dist(got, want)
            log(f"encoder {name} {impl} f32 vs xla f32: out {tuple(got.shape)}, "
                f"max_abs_err {err:.3e} (<= 1e-4 x max), rel L2 {rel2:.3e} (<= 1e-4), "
                f"launches conv_direct {ran[0]}, fused_matmul {ran[1]}")
            if not (err <= 1e-4 * ref and rel2 <= 1e-4 and ran != (0, 0)
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"encoder {name} {impl} f32 disagrees")
            got16, ran = run_encoder(name, state, torch.bfloat16, impl, x)
            err, rel2 = dist(got16, want)
            d_err, d_rel = dist(got16, plain16)
            if name == "resnet50":
                b_frac, b_rel = resnet_blocks_bf16(state, x)
                direct_ok = b_frac <= 7e-2 and b_rel <= 2e-3
                direct = (f"block by block: worst share of elements differing {b_frac:.3e} "
                          f"(<= 7e-2), worst rel L2 {b_rel:.3e} (<= 2e-3)")
            else:
                direct_ok = d_err <= 2e-2 * ref16 and d_rel <= 1.5e-2
                direct = f"(<= 2e-2 x {ref16:.3e} and rel L2 <= 1.5e-2)"
            log(f"encoder {name} {impl} bf16 vs xla f32: max_abs_err {err:.3e} (<= 3 x "
                f"{p_err:.3e}), rel L2 {rel2:.3e} (<= 1.5 x {p_rel:.3e}); vs xla bf16: "
                f"max_abs_err {d_err:.3e}, rel L2 {d_rel:.3e} {direct}; launches "
                f"conv_direct {ran[0]}, fused_matmul {ran[1]}")
            if not (err <= 3 * p_err and rel2 <= 1.5 * p_rel and direct_ok and ran != (0, 0)
                    and bool(torch.isfinite(got16).all())):
                raise AssertionError(f"encoder {name} {impl} bf16 disagrees")
    phase("encoders_vs_plain", t0)

    def zero_counts():
        fd.launches = mm.launches = cd.launches = fa.launches = 0
        fb.dq_launches = fb.dkv_launches = 0

    def read_counts():
        return {"fused_decode": fd.launches, "fused_matmul": mm.launches,
                "conv_direct": cd.launches, "flash_attention": fa.launches,
                "flash_attention_bwd_dq": fb.dq_launches,
                "flash_attention_bwd_dkv": fb.dkv_launches}

    def run_cli(main_fn, argv, what):
        """(seconds, launch counts) of one in-process CLI run; the counts are
        set to 0 just before it and read just after."""
        torch.cuda.synchronize()
        zero_counts()
        t_run = time.perf_counter()
        rc = main_fn(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        counts = read_counts()
        if rc != 0:
            raise AssertionError(f"{what} returned {rc}")
        return run_s, counts

    def run_generate(argv):
        return run_cli(generate.main, argv, "sgg_torch.cli.generate")

    def check_graphs(out_path, vocab_, n_images, k_draws=K):
        with open(out_path) as f:
            out = json.load(f)
        graphs = out["scene_graphs"]
        if out["num_images"] != n_images or len(graphs) != n_images:
            raise AssertionError("wrong number of scene graphs")
        obj_names = {vocab_.tokens[i] for i in np.flatnonzero(vocab_.is_object)}
        pred_names = {vocab_.tokens[i] for i in np.flatnonzero(vocab_.is_predicate)}
        for gr in graphs:
            if sum(t["count"] for t in gr["triples"]) != k_draws:
                raise AssertionError(f"image {gr['image_id']}: counts do not sum to {k_draws}")
            for t in gr["triples"]:
                if not (t["subject"] in obj_names and t["object"] in obj_names
                        and t["predicate"] in pred_names):
                    raise AssertionError(f"illegal triple {t}")
        n_unique = sum(len(gr["triples"]) for gr in graphs)
        log(f"output: {len(graphs)} graphs, {n_unique} unique triples, all type-legal")

    # 6. Main path, precomputed features: the generate CLI end to end.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        data_dir = os.path.join(wd, "shards")
        os.makedirs(data_dir)
        run_cfg["data"]["source"] = "shards"
        run_cfg["data"]["data_dir"] = data_dir
        run_cfg["data"]["vocab_path"] = ""
        run_cfg["workdir"] = wd
        with open(os.path.join(wd, "config.json"), "w") as f:
            json.dump(run_cfg, f, indent=2)
        vocab.save(os.path.join(wd, "vocab.json"))
        vocab.save(os.path.join(data_dir, "vocab.json"))
        torch.manual_seed(SEED + 1)
        g_params = AttentionLSTMGenerator.from_config(cfg).state_dict()
        torch.manual_seed(SEED + 2)
        g_ema = AttentionLSTMGenerator.from_config(cfg).state_dict()
        save_generator(wd, g_params, g_ema, step=0)
        objs = np.flatnonzero(vocab.is_object)
        preds = np.flatnonzero(vocab.is_predicate)
        shard_n = N_IMAGES // 2
        for s in range(2):
            feats = rng.standard_normal((shard_n, R, F), dtype=np.float32)
            triples = []
            for _ in range(shard_n):
                n = int(rng.integers(1, 9))
                triples.append(np.stack([rng.choice(objs, n), rng.choice(preds, n),
                                         rng.choice(objs, n)], axis=1))
            write_feature_shard(
                os.path.join(data_dir, shard_name(s, 2)),
                np.arange(s * shard_n, (s + 1) * shard_n), feats, triples)
        log(f"workdir written: {N_IMAGES} images x {R} x {F} float32 shards")
        out_path = os.path.join(wd, "graphs.json")
        gen_s, counts = run_generate(
            ["--workdir", wd, "--out", out_path, "--num-samples", str(K), "--decode", "fused",
             "--batch-size", str(BATCH), "--recall-k", "50", "--ema", "--seed", str(SEED)])
        want_launches = math.ceil(N_IMAGES / BATCH) * K
        log(f"generate vg1k: {gen_s:.3f} s in process, launches {counts} "
            f"(fused_decode expected {want_launches}), "
            f"{N_IMAGES * K / gen_s:.0f} triples/s including set-up")
        if counts["fused_decode"] != want_launches:
            raise AssertionError("the main path did not launch fused_decode as expected")
        check_graphs(out_path, vocab, N_IMAGES)

        # One batch of the CUDA sampler against the CPU sampler (plain
        # version) given the same noise.
        Ks, Bs = 8, 16
        sampler = make_fused_sampler(cfg, step_mask=vocab.step_mask(), num_samples=Ks)
        feats = torch.from_numpy(rng.standard_normal((Bs, R, F), dtype=np.float32))
        z = torch.randn(Ks, Bs, Z, generator=gen, device=dev).to(cfg.model.dtype)
        g = sample_gumbel((Ks, Bs, 3, V), gen, device=dev)
        gpu_tok = sampler({k_: v_.to(dev) for k_, v_ in g_ema.items()}, feats.to(dev),
                          noise=(z, g)).cpu()
        cpu_tok = sampler(g_ema, feats, noise=(z.cpu(), g.cpu()))
        agree = (gpu_tok == cpu_tok).float().mean().item()
        log(f"sampler tokens, CUDA vs CPU plain, same noise: {agree:.4f} identical")
        if gpu_tok.shape != (Bs, Ks, 3) or agree < 0.99:
            raise AssertionError("CUDA sampler disagrees with the CPU sampler")
    phase("main_path_vg1k", t0)

    # 7. Main path, pixels in: resnet50 config, synthetic images.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        pix_cfg.workdir = wd
        with open(os.path.join(wd, "config.json"), "w") as f:
            f.write(pix_cfg.to_json())
        pix_vocab.save(os.path.join(wd, "vocab.json"))
        torch.manual_seed(SEED + 5)
        pix_g = AttentionLSTMGenerator.from_config(pix_cfg).state_dict()
        save_generator(wd, pix_g, step=0, enc_params=seeded_encoder_state("resnet50"))
        out_path = os.path.join(wd, "graphs.json")
        pix_s, pix_counts = run_generate(
            ["--workdir", wd, "--out", out_path, "--num-samples", str(K), "--decode", "fused",
             "--batch-size", str(PIX_BATCH), "--recall-k", "50", "--seed", str(SEED)])
        n_batches = math.ceil(PIX_IMAGES / PIX_BATCH)
        want_counts = {"fused_decode": n_batches * K, "fused_matmul": n_batches * 36,
                       "conv_direct": n_batches * 13, "flash_attention": 0,
                       "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
        log(f"generate resnet50: {pix_s:.3f} s in process, launches {pix_counts} "
            f"(expected {want_counts}), {PIX_IMAGES / pix_s:.1f} images/s and "
            f"{PIX_IMAGES * K / pix_s:.0f} triples/s including set-up")
        if pix_counts != want_counts:
            raise AssertionError("the pixels-in path did not launch its kernels as expected")
        check_graphs(out_path, pix_vocab, PIX_IMAGES)
    phase("main_path_resnet50", t0)

    # 8. Timing at the main paths' shapes (warm L2).
    t0 = time.perf_counter()
    records = {}

    def add(name, ms, plain_ms, lib_ms, bound_s, bound_by, weight):
        r_ = records.setdefault(name, {"w": 0, "ms": 0.0, "plain": 0.0, "lib": 0.0,
                                       "bound": 0.0, "by": Counter()})
        r_["w"] += weight
        r_["ms"] += weight * ms
        r_["plain"] += weight * plain_ms
        r_["lib"] += weight * (lib_ms or 0.0)
        r_["bound"] += weight * bound_s * 1e3
        r_["by"][bound_by] += weight

    # fused_decode, bf16 hard: the vg1k path (B = 64) and the resnet50 path
    # (B = 32). The record is the host clock (CUDA events around eager
    # calls, in turns with plain); printed apart: the device's clock (the
    # cooperative launch captured in a CUDA graph), the generic instance on
    # the same inputs, and the per-phase split from the timed check-only
    # entry (block 0's %globaltimer at every grid barrier).
    phase_names = ["mean, z, copies", "init c, h + proj", "hp", "step 1 scores", "step 1 ctx"]
    for t_ in range(1, 4):
        nxt = t_ < 3
        phase_names += [f"step {t_} gates + cell", f"step {t_} dec + next hp",
                        f"step {t_} logits" + (f" + step {t_ + 1} scores" if nxt else ""),
                        f"step {t_} sample + feedback" + (f" + step {t_ + 1} ctx" if nxt else "")]

    def decode_split(params, feats, z, g, mb):
        """Block 0's time in each phase of one launch of the timed batched
        instance, us, in phase_names' order (the last phase ends at block
        0's end, not at a barrier)."""
        B_, R_, F_ = feats.shape
        A_, H_ = params["wf"].shape[1], params["wc"].shape[1]
        E_, V_ = params["emb"].shape[1], params["wv"].shape[1]
        p_ = fd.plan(B_, R_, F_, A_, H_, E_, z.shape[1], V_, feats.dtype, mm.sm_count(0))
        stamps = torch.zeros(fd.MAX_MARKS, dtype=torch.int64, device=dev)
        scratch = torch.empty(p_.scratch, dtype=torch.uint8, device=dev)
        y = torch.empty(B_, 3, V_, dtype=feats.dtype, device=dev)
        ws = [params[n_].data_ptr() for n_ in fd.WEIGHT_NAMES]
        runs = []
        for _ in range(3):
            stamps.zero_()
            err_ = lib.sgg_fused_decode_batched_timed(
                1, B_, R_, F_, A_, H_, E_, z.shape[1], V_, feats.data_ptr(), z.data_ptr(),
                g.data_ptr(), mb.data_ptr(), 1.0, *ws, scratch.data_ptr(), y.data_ptr(),
                p_.row_tiles, p_.grid, p_.threads, p_.stages, p_.smem, p_.scratch,
                stamps.data_ptr(), torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err_ != 0:
                raise RuntimeError(f"timed fused_decode launch failed: CUDA error {err_}")
            t_ = [v_ for v_ in stamps.tolist() if v_]
            runs.append([(t_[i_ + 1] - t_[i_]) / 1e3 for i_ in range(len(t_) - 1)])
        if any(len(r_) != len(phase_names) for r_ in runs):
            raise AssertionError(f"the timed instance stamped {[len(r_) for r_ in runs]} "
                                 f"phases, expected {len(phase_names)}")
        return [min(r_[i_] for r_ in runs) for i_ in range(len(phase_names))]

    for label, cfg_, sd_, B in (("vg1k", cfg, sd, BATCH), ("resnet50", pix_cfg, pix_sd, PIX_BATCH)):
        Rq, Fq, Aq, Hq, Eq, Zq, Vq = (cfg_.data.regions, cfg_.data.feat_dim,
                                      cfg_.model.attn_dim, cfg_.model.hidden,
                                      cfg_.model.embed_dim, cfg_.model.noise_dim,
                                      cfg_.model.vocab_size)
        dtype = cfg_.model.dtype
        params = fd.decode_params_from_generator(sd_, dtype, dev)
        mb = fd.step_mask_bias((vocab if label == "vg1k" else pix_vocab).step_mask(), dev)
        feats = torch.randn(B, Rq, Fq, generator=gen, device=dev).to(dtype)
        z = torch.randn(B, Zq, generator=gen, device=dev).to(dtype)
        g = sample_gumbel((B, 3, Vq), gen, device=dev)
        k_ms, p_ms, turns = in_turns(
            lambda: fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=True),
            lambda: fd.decode_plain(params, feats, z, g, mask_bias=mb, hard=True))
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        nbytes, flops = decode_work(B, Rq, Fq, Aq, Hq, Eq, Zq, Vq, feats.element_size())
        b_s, b_by = bound(nbytes, flops, peak)
        soft_b, _ = bound(*decode_work(B, Rq, Fq, Aq, Hq, Eq, Zq, Vq, feats.element_size(),
                                       hard=False), peak)
        log(f"time fused_decode {label} {cfg_.model.compute_dtype} B={B} (record, host clock): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (turns k,k,p,p "
            f"{', '.join(f'{t:.4f}' for t in turns)}), bound {b_s * 1e3:.5f} ms ({b_by}: "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; hard mode's feedback reads the "
            f"chosen rows of emb, 3 * B * E; with all of emb and y @ emb, as soft mode needs, "
            f"{soft_b * 1e3:.5f} ms), kernel at {b_s * 1e3 / k_ms:.4f} of the bound, per batch "
            f"of {K} draws {K * k_ms:.2f} ms")
        dev_ms = graph_ms(lambda: fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=True))
        rt = max(t_ for t_ in fd.ROW_TILES
                 if fd.generic_smem(Rq, Fq, Aq, Hq, Eq, Zq, Vq, t_) <= 232_448)
        gen_ms = time_ms(lambda: fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=True,
                                                 row_tile=rt))
        split = decode_split(params, feats, z, g, mb)
        log(f"time fused_decode {label} B={B} on the device's clock (the cooperative launch "
            f"captured in a CUDA graph): "
            f"{dev_ms:.4f} ms; the generic instance (row tile {rt}) on the same inputs, host "
            f"clock: {gen_ms:.4f} ms (batched / generic {k_ms / gen_ms:.4f})")
        log(f"time fused_decode {label} B={B} per phase (timed instance, block 0, us, best "
            f"of 3; total {sum(split):.2f}): "
            + "; ".join(f"{n_} {v_:.2f}" for n_, v_ in zip(phase_names, split)))
        if label == "resnet50":
            add("fused_decode", k_ms, p_ms, None, b_s, b_by, K)
    tiny = fd.cast_params({n_: (torch.randn(*shape_, generator=torch.Generator().manual_seed(1))
                                / 4).numpy() for n_, shape_ in (
        ("wf", (24, 16)), ("wh", (32, 16)), ("bh", (16,)), ("v", (16,)), ("wc", (24, 32)),
        ("bc", (32,)), ("wi", (24, 32)), ("bi", (32,)), ("k", (80, 128)), ("bk", (128,)),
        ("wd", (56, 16)), ("bd", (16,)), ("wv", (16, 40)), ("bv", (40,)), ("emb", (40, 16)))},
        torch.bfloat16, dev)
    t_feats = torch.randn(4, 9, 24, device=dev).to(torch.bfloat16)
    t_z = torch.randn(4, 8, device=dev).to(torch.bfloat16)
    t_g = torch.randn(4, 3, 40, device=dev)
    fd.fused_decode(tiny, t_feats, t_z, t_g)
    torch.cuda.synchronize()
    host_runs = []
    for _ in range(5):  # the host's clock is shared: the least of 5 runs of 100 calls
        t_host = time.perf_counter()
        for _ in range(100):
            fd.fused_decode(tiny, t_feats, t_z, t_g)
        host_runs.append((time.perf_counter() - t_host) / 100 * 1e6)
        torch.cuda.synchronize()
    host_us = min(host_runs)
    # Printed against its limit, not held to it: a loaded host moves it (29
    # to 52 us between calls on the same code, H100).
    log(f"time fused_decode wrapper's host cost at B=4, R=9, F=24, A=16, H=32, E=16, Z=8, V=40 "
        f"(batched instance): {host_us:.1f} us per call, the least of 5 runs of 100 calls "
        f"without a synchronize ({', '.join(f'{v_:.1f}' for v_ in host_runs)}): "
        f"{'within' if host_us <= DECODE_HOST_US_LIMIT else 'OVER'} the limit of "
        f"{DECODE_HOST_US_LIMIT} us")

    # fused_matmul timed as every kernel here (host clock, CUDA events
    # around eager calls) for the record; then on the device's clock (CUDA
    # graphs) the kernel, torch.matmul and the generic instance (the tile
    # core shared with conv_direct, the kernel's earlier design) on the same
    # bf16 inputs through its own C entry, printed apart.
    def mm_generic(a, b, bias, scale, out, relu):
        M_, K__ = a.shape
        err_ = lib.sgg_fused_matmul(1, 1, int(relu), M_, b.shape[1], K__, a.data_ptr(),
                                    b.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                    out.data_ptr(), int(K__ % 16 == 0), int(b.shape[1] % 8 == 0),
                                    torch.cuda.current_stream().cuda_stream)
        if err_ != 0:
            raise RuntimeError(f"generic fused_matmul launch failed: CUDA error {err_}")

    mm_graph = Counter()
    for M, K_, N, relu, per_batch in RESNET_1X1 + [VGG_IM2COL]:
        a, b, bias, scale = mm_inputs(M, K_, N, torch.bfloat16)
        k_ms, p_ms, _ = in_turns(lambda: mm.fused_matmul(a, b, bias, scale, relu=relu),
                                 lambda: mm.fused_matmul_plain(a, b, bias, scale, relu=relu))
        l_ms = time_ms(lambda: torch.matmul(a, b))
        kg_ms = graph_ms(lambda: mm.fused_matmul(a, b, bias, scale, relu=relu))
        lg_ms = graph_ms(lambda: torch.matmul(a, b))
        g_out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        gg_ms = graph_ms(lambda: mm_generic(a, b, bias, scale, g_out, relu))
        p_ = mm.plan(M, K_, N, torch.bfloat16, torch.bfloat16, mm.aligned(a), mm.aligned(b),
                     mm.sm_count(a.device.index))
        nbytes, flops = matmul_work(M, K_, N, 2)
        b_s, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"time fused_matmul bf16 M={M} K={K_} N={N} relu={relu} (x{per_batch} per "
            f"batch), {p_.instance} {p_.bm}x{p_.bn}x{p_.bk}, {p_.grid[0] * p_.grid[1]} blocks: "
            f"kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), plain "
            f"{p_ms:.4f}, torch.matmul {l_ms:.4f} (no epilogue), bound {b_s * 1e3:.5f} ms "
            f"({b_by}), kernel at {b_s * 1e3 / k_ms:.3f} of the bound; on the device's clock "
            f"(CUDA graphs): kernel {kg_ms:.4f} ms ({flops / kg_ms / 1e9:.1f} TFLOP/s, "
            f"{nbytes / kg_ms / 1e6:.0f} GB/s, {b_s * 1e3 / kg_ms:.3f} of the bound), "
            f"torch.matmul {lg_ms:.4f}, generic instance {gg_ms:.4f} (kernel / that "
            f"{kg_ms / gg_ms:.3f})")
        if per_batch:
            add("fused_matmul", k_ms, p_ms, l_ms, b_s, b_by, per_batch)
            for key, v_ in (("w", 1.0), ("kernel", kg_ms), ("library", lg_ms),
                            ("generic", gg_ms), ("host", k_ms), ("bound", b_s * 1e3)):
                mm_graph[key] += per_batch * v_
    mw = mm_graph["w"]
    log(f"time fused_matmul bf16, launch-weighted over the 36 ResNet-50 1x1 launches per "
        f"batch: on the device's clock (CUDA graphs) kernel {mm_graph['kernel'] / mw:.4f} ms, "
        f"torch.matmul {mm_graph['library'] / mw:.4f} ms, generic instance "
        f"{mm_graph['generic'] / mw:.4f} ms (kernel / generic "
        f"{mm_graph['kernel'] / mm_graph['generic']:.3f}, kernel / torch.matmul "
        f"{mm_graph['kernel'] / mm_graph['library']:.3f}); host clock kernel "
        f"{mm_graph['host'] / mw:.4f} ms; bound {mm_graph['bound'] / mw:.5f} ms; per batch "
        f"of 36 on the device: kernel {mm_graph['kernel']:.4f} ms, generic "
        f"{mm_graph['generic']:.4f} ms")
    g_small = torch.Generator(device=dev).manual_seed(SEED + 31)  # leaves gen's stream as it was
    a = torch.randn(64, 64, generator=g_small, device=dev).to(torch.bfloat16)
    b = (torch.randn(64, 64, generator=g_small, device=dev) / 8).to(torch.bfloat16)
    bias, scale = torch.zeros(64, device=dev), torch.ones(64, device=dev)

    def small_mm():
        mm.fused_matmul(a, b, bias, scale, relu=True)

    log(f"time fused_matmul wrapper, back-to-back calls at [64, 64] @ [64, 64]: "
        f"{1e3 * time_ms(small_mm):.1f} us per call (the kernel alone, device clock "
        f"{1e3 * graph_ms(small_mm):.1f} us)")

    # conv_direct timed as every kernel here (host clock, CUDA events around
    # eager calls) for the record; then on the device's clock (each call
    # captured in a CUDA graph, so the wrapper's host cost drops out) the
    # kernel, F.conv2d and the earlier design (the generic instance,
    # gemm_tile.cuh) on the same bf16 inputs through its own C entry.
    def conv_generic(x, w, bias, scale, out):
        B_, H_, W_, C_ = x.shape
        err_ = lib.sgg_conv_direct(1, 1, B_, H_, W_, C_, 3, 3, w.shape[-1], x.data_ptr(),
                                   w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                   out.data_ptr(), 1, 1, torch.cuda.current_stream().cuda_stream)
        if err_ != 0:
            raise RuntimeError(f"generic conv_direct launch failed: CUDA error {err_}")

    graph_rec = Counter()
    for shape, cout, per_batch in RESNET_3X3 + VGG_3X3:
        x, w, bias, scale = conv_inputs(shape, cout, torch.bfloat16)
        k_ms, p_ms, turns = in_turns(lambda: cd.conv2d_direct(x, w, bias, scale, relu=True),
                                     lambda: cd.conv2d_direct_plain(x, w, bias, scale, relu=True))
        x_cl = x.permute(0, 3, 1, 2)  # channels-last NCHW view of the NHWC tensor
        w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        l_ms = time_ms(lambda: Fnn.conv2d(x_cl, w_cl, padding=1))
        kg_ms = graph_ms(lambda: cd.conv2d_direct(x, w, bias, scale, relu=True))
        lg_ms = graph_ms(lambda: Fnn.conv2d(x_cl, w_cl, padding=1))
        p_ = cd.plan(*shape, cout, 3, 3, torch.bfloat16, mm.aligned(x), mm.aligned(w),
                     cd.sm_count(x.device.index))
        g_txt = ""
        if shape[-1] % 16 == 0:
            g_out = torch.empty(*shape[:3], cout, dtype=torch.bfloat16, device=dev)
            gg_ms = graph_ms(lambda: conv_generic(x, w, bias, scale, g_out))
            g_txt = f", generic instance {gg_ms:.4f} (kernel / that {kg_ms / gg_ms:.3f})"
            graph_rec["generic"] += per_batch * gg_ms
        nbytes, flops = conv_work(shape, cout, 3, 2)
        b_s, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"time conv_direct bf16 {list(shape)}->{cout} (x{per_batch} per batch), "
            f"{p_.instance} {p_.bm}x{p_.bn}x{p_.bk}, {p_.grid[0] * p_.grid[1]} blocks: kernel "
            f"{k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s; turns k,k,p,p "
            f"{', '.join(f'{t_:.4f}' for t_ in turns)}), plain {p_ms:.4f}, F.conv2d "
            f"channels-last {l_ms:.4f} (no epilogue), bound {b_s * 1e3:.5f} ms ({b_by}), "
            f"kernel at {b_s * 1e3 / k_ms:.3f} of the bound; on the device's clock (CUDA "
            f"graphs): kernel {kg_ms:.4f} ms ({flops / kg_ms / 1e9:.1f} TFLOP/s, "
            f"{b_s * 1e3 / kg_ms:.3f} of the bound), F.conv2d {lg_ms:.4f}{g_txt}")
        if per_batch:
            add("conv_direct", k_ms, p_ms, l_ms, b_s, b_by, per_batch)
            graph_rec["w"] += per_batch
            graph_rec["kernel"] += per_batch * kg_ms
            graph_rec["library"] += per_batch * lg_ms
    # The wrapper's host cost per call: back-to-back eager calls at a shape
    # whose kernel takes a few microseconds, so the host's cost sets the pace.
    g_small = torch.Generator(device=dev).manual_seed(SEED + 30)  # leaves gen's stream as it was
    x = torch.randn(1, 8, 8, 64, generator=g_small, device=dev).to(torch.bfloat16)
    w = (torch.randn(3, 3, 64, 64, generator=g_small, device=dev) / 24).to(torch.bfloat16)
    bias, scale = torch.zeros(64, device=dev), torch.ones(64, device=dev)

    def small():
        cd.conv2d_direct(x, w, bias, scale, relu=True)

    log(f"time conv_direct wrapper, back-to-back calls at [1, 8, 8, 64]->64: "
        f"{1e3 * time_ms(small):.1f} us per call (the kernel alone, device clock "
        f"{1e3 * graph_ms(small):.1f} us)")
    log(f"time conv_direct bf16, launch-weighted over the ResNet-50 3x3 shapes, on the "
        f"device's clock (CUDA graphs): kernel {graph_rec['kernel'] / graph_rec['w']:.4f} ms, "
        f"F.conv2d {graph_rec['library'] / graph_rec['w']:.4f} ms, generic instance "
        f"{graph_rec['generic'] / graph_rec['w']:.4f} ms")

    # The ResNet-50 encoder on one batch of the pixels-in path (B = 32,
    # 224 px, bf16): the kernel route against the library route.
    batch = torch.from_numpy(np.random.RandomState(SEED + 6).randint(
        0, 256, (PIX_BATCH, 224, 224, 3), dtype=np.uint8)).to(dev)
    state = seeded_encoder_state("resnet50")
    encs = {}
    for impl in ("auto", "xla"):
        encs[impl] = ResNet50Features(conv_impl=impl, dtype=torch.bfloat16)
        encs[impl].load_state_dict(state)
        encs[impl].to(dev)

    def encode(impl):
        with torch.no_grad():
            return encs[impl](normalize_for("resnet50", batch))

    k_ms, p_ms, turns = in_turns(lambda: encode("auto"), lambda: encode("xla"))
    log(f"time resnet50 encoder bf16 B={PIX_BATCH} (normalize + 53 convs): kernel route "
        f"{k_ms:.4f} ms, library route {p_ms:.4f} ms (turns k,k,l,l "
        f"{', '.join(f'{t:.4f}' for t in turns)})")

    # The same kernel-route encoder with its 3x3 convs, then its 1x1 convs,
    # on the generic instance (each kernel's earlier design) instead: ten
    # pairs each in this process, alternating which side runs first, each
    # timed eager (host clock) and as one CUDA graph (device clock). Calls
    # across processes and machines spread more than two designs differ.
    xn = normalize_for("resnet50", batch)

    def generic_conv_plan(B_, H_, W_, C_, N_, kh_, kw_, dtype_, *rest):
        return cd_plan(B_, H_, W_, C_, N_, kh_, kw_, torch.float32, *rest)

    def generic_mm_plan(M_, K__, N_, dtype_, *rest):
        return mm_plan(M_, K__, N_, torch.float32, *rest)

    def encoder_ms(mod, plan_):
        def run():
            with torch.no_grad():
                encs["auto"](xn)
        tiled_plan_ = mod.plan
        mod.plan = plan_
        try:
            return time_ms(run), graph_ms(run, n=1, reps=10)
        finally:
            mod.plan = tiled_plan_

    cd_plan, mm_plan = cd.plan, mm.plan
    for what, mod, tiled_plan, generic_plan in (
            ("3x3 convs", cd, cd_plan, generic_conv_plan),
            ("1x1 convs", mm, mm_plan, generic_mm_plan)):
        ab = {"tiled": [], "generic": []}
        for i in range(10):
            for name in (("tiled", "generic") if i % 2 == 0 else ("generic", "tiled")):
                ab[name].append(encoder_ms(mod, tiled_plan if name == "tiled" else generic_plan))
        for j, clock in ((0, "eager, host clock"), (1, "one CUDA graph, device clock")):
            t_, g_ = ([r_[j] for r_ in ab[n_]] for n_ in ("tiled", "generic"))
            log(f"time resnet50 encoder bf16 B={PIX_BATCH}, {what} tiled vs generic, 10 pairs "
                f"({clock}): median {statistics.median(t_):.4f} ms vs "
                f"{statistics.median(g_):.4f} ms, tiled faster in "
                f"{sum(a < b for a, b in zip(t_, g_))} of 10 pairs; tiled "
                f"{', '.join(f'{v:.4f}' for v in t_)}; generic "
                f"{', '.join(f'{v:.4f}' for v in g_)}")
    log(f"expected gain of the 1x1 convs in the CUDA graph: 36 x (generic - tiled) on the "
        f"device's clock = {mm_graph['generic'] - mm_graph['kernel']:.4f} ms per batch")
    phase("timing", t0)

    # 9. flash_attention vs plain at the ViT shapes and a ragged S.
    t0 = time.perf_counter()
    flash_errs = {}
    for shape in FLASH_SHAPES:
        q32, k32, v32 = (torch.randn(*shape, generator=gen, device=dev) for _ in range(3))
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k_, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            o, lse = fa.flash_attention_with_lse(q, k_, v)
            o_only = fa.flash_attention(q, k_, v)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_plain(q, k_, v, return_lse=True)
            diff = (o.float() - want.float()).abs()
            ref = want.float().abs().max().item()
            err, f32_tol = diff.max().item(), 1e-4 * ref
            share = (diff > 0).float().mean().item()
            lse_rel = ((lse - want_lse).abs() / want_lse.abs()).max().item()
            in_ulp = one_ulp_gate(o, want, f32_tol)
            if dtype == torch.float32:
                close = err <= f32_tol
            else:  # the share tells p rounded to bf16 before P.V from sum order
                close = in_ulp and share <= 1e-2
            ok = (close and lse_rel <= 1e-5 and torch.equal(o, o_only)
                  and o.dtype == dtype and o.shape == q.shape
                  and bool(torch.isfinite(o.float()).all()))
            gate = ("max_abs_err <= 1e-4 x max" if dtype == torch.float32
                    else "within 1 bf16 ulp + 1e-4 x max, share <= 1e-2")
            log(f"flash_attention vs plain {name} {list(shape)}: max_abs_err {err:.3e}, "
                f"max|plain| {ref:.3e}, within 1 bf16 ulp + 1e-4 x max {in_ulp}, share of "
                f"outputs differing {share:.3e}, lse max rel err {lse_rel:.3e} (<= 1e-5), "
                f"o with lse == o without {torch.equal(o, o_only)}; gate: {gate}: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"flash_attention {name} {shape} disagrees with plain")
            flash_errs[(shape, name)] = err
            if dtype == torch.bfloat16:
                o32 = fa.launch_f32_result(q, k_, v)
                torch.cuda.synchronize()
                want32 = fa.flash_attention_plain(q, k_, v, cast=False)
                sc = ((q * torch.tensor(shape[-1] ** -0.5, dtype=dtype, device=dev)).float()
                      @ k_.float().transpose(-1, -2))
                p_ = torch.exp(sc - sc.amax(-1, keepdim=True))
                fault = fa.f32_result_error(
                    (cut_split(p_, 2) @ v.float()) / p_.sum(-1, keepdim=True), want32)
                if not f32_result_gate(f"flash_attention {list(shape)}",
                                       [fa.f32_result_error(o32, want32)], [fault],
                                       fa.F32_RESULT_TOL):
                    raise AssertionError(f"flash_attention bf16 {shape}: float32 result gate")
    phase("flash_vs_plain", t0)

    # 10. ViT-B/16, kernel route vs plain route, 8 seeded images.
    t0 = time.perf_counter()

    def seeded_vit_state():
        torch.manual_seed(SEED + 7)
        sd_ = ViTB16Features().state_dict()
        g_ = torch.Generator().manual_seed(SEED + 8)
        for k_, v_ in sd_.items():
            if k_.endswith(".scale"):
                v_.copy_(1.0 + 0.2 * torch.randn(v_.shape, generator=g_))
            elif k_.endswith(".bias"):
                v_.copy_(0.1 * torch.randn(v_.shape, generator=g_))
        return sd_

    vit_state = seeded_vit_state()

    def load_vit(dtype, kernel_route):
        kw = {"use_pallas": True} if kernel_route else {"attn_fn": fa.flash_attention_plain}
        enc = ViTB16Features(dtype=dtype, **kw)
        enc.load_state_dict(vit_state)
        return enc.requires_grad_(False).eval().to(dev)

    x = normalize_for("vit_b16", images)
    vits = {(dt, kr): load_vit(dt, kr) for dt in (torch.float32, torch.bfloat16)
            for kr in (True, False)}
    with torch.no_grad():
        want = vits[(torch.float32, False)](x).float()
        fa.launches = 0
        got = vits[(torch.float32, True)](x).float()
        torch.cuda.synchronize()
        ran = fa.launches
    err, rel2 = dist(got, want)
    ref = want.abs().max().item()
    log(f"encoder vit_b16 f32 kernel route vs plain route: out {tuple(got.shape)}, "
        f"max_abs_err {err:.3e} (<= 1e-4 x {ref:.3e}), rel L2 {rel2:.3e}, "
        f"flash_attention launches {ran} (12 expected)")
    if not (err <= 1e-4 * ref and ran == 12 and bool(torch.isfinite(got).all())):
        raise AssertionError("ViT-B/16 kernel route f32 disagrees with the plain route")
    ker, pln = vits[(torch.bfloat16, True)], vits[(torch.bfloat16, False)]
    worst_frac = worst_rel = 0.0
    with torch.no_grad():
        prev = pln.embed(x)
        for name in pln.blocks:
            want_ = getattr(pln, name)(prev)
            got_ = getattr(ker, name)(prev)
            worst_frac = max(worst_frac, (got_ != want_).float().mean().item())
            worst_rel = max(worst_rel, dist(got_.float(), want_.float())[1])
            prev = want_
        end_err, end_rel = dist(ker(x).float(), pln(x).float())
    torch.cuda.synchronize()
    log(f"encoder vit_b16 bf16 kernel route vs plain route, block by block: worst share "
        f"of elements differing {worst_frac:.3e} (<= 7e-2), worst rel L2 {worst_rel:.3e} "
        f"(<= 2e-3); end to end max_abs_err {end_err:.3e}, rel L2 {end_rel:.3e}")
    if not (worst_frac <= 7e-2 and worst_rel <= 2e-3):
        raise AssertionError("ViT-B/16 kernel route bf16 disagrees with the plain route")
    del vits, ker, pln
    phase("vit_vs_plain", t0)

    # 11. Main path, vit_b16: ViT-B/16 encoder, transformer decoder.
    t0 = time.perf_counter()
    vit_vocab = Vocab.build(
        Counter({f"object{i}": int(c) for i, c in enumerate(rng.integers(1, 10**6, 872))}),
        Counter({f"predicate{i}": int(c) for i, c in enumerate(rng.integers(1, 10**6, 150))}),
    )
    assert len(vit_vocab) == VIT_VOCAB, len(vit_vocab)
    vit_cfg = get_config("vit_b16")
    vit_cfg.data.num_synthetic_images = VIT_IMAGES
    vit_cfg.model.vocab_size = VIT_VOCAB
    with tempfile.TemporaryDirectory() as wd:
        vit_cfg.workdir = wd
        with open(os.path.join(wd, "config.json"), "w") as f:
            f.write(vit_cfg.to_json())
        vit_vocab.save(os.path.join(wd, "vocab.json"))
        torch.manual_seed(SEED + 9)
        vit_g = TransformerTripleGenerator.from_config(vit_cfg).state_dict()
        save_generator(wd, vit_g, step=0, enc_params=vit_state)
        out_path = os.path.join(wd, "graphs.json")
        vit_s, vit_counts = run_generate(
            ["--workdir", wd, "--out", out_path, "--num-samples", str(K), "--decode", "xla",
             "--batch-size", str(VIT_BATCH), "--recall-k", "50", "--seed", str(SEED)])
        n_batches = math.ceil(VIT_IMAGES / VIT_BATCH)
        want_counts = {"fused_decode": 0, "fused_matmul": 0, "conv_direct": 0,
                       "flash_attention": n_batches * 12, "flash_attention_bwd_dq": 0,
                       "flash_attention_bwd_dkv": 0}
        log(f"generate vit_b16: {vit_s:.3f} s in process, launches {vit_counts} "
            f"(expected {want_counts}), {VIT_IMAGES / vit_s:.1f} images/s and "
            f"{VIT_IMAGES * K / vit_s:.0f} triples/s including set-up")
        if vit_counts != want_counts:
            raise AssertionError("the vit_b16 path did not launch its kernels as expected")
        check_graphs(out_path, vit_vocab, VIT_IMAGES)

    # One batch of the CUDA sampler against the CPU sampler (plain
    # versions) given the same features (the CUDA encoder's, on the kernel
    # route, held to its plain route in phase 10) and the same noise.
    Ks, Bs = 8, VIT_BATCH
    imgs = torch.from_numpy(np.random.RandomState(SEED + 10).randint(
        0, 256, (Bs, 224, 224, 3), dtype=np.uint8)).to(dev)
    with torch.no_grad():
        feats = load_vit(torch.bfloat16, True)(normalize_for("vit_b16", imgs))
    z = torch.randn(Ks, Bs, vit_cfg.model.noise_dim, generator=gen, device=dev)
    g = sample_gumbel((Ks, Bs, 3, VIT_VOCAB), gen, device=dev)
    sampler = make_sampler(vit_cfg, step_mask=vit_vocab.step_mask(), num_samples=Ks)
    gpu_tok = sampler({k_: v_.to(dev) for k_, v_ in vit_g.items()}, feats, noise=(z, g)).cpu()
    cpu_tok = make_sampler(vit_cfg, step_mask=vit_vocab.step_mask(), num_samples=Ks)(
        vit_g, feats.cpu(), noise=(z.cpu(), g.cpu()))
    agree = (gpu_tok == cpu_tok).float().mean().item()
    log(f"vit_b16 sampler tokens, CUDA vs CPU plain, same features and noise: "
        f"{agree:.4f} identical of {cpu_tok.numel()} (>= 0.99)")
    if gpu_tok.shape != (Bs, Ks, 3) or agree < 0.99:
        raise AssertionError("the CUDA vit_b16 sampler disagrees with the CPU sampler")
    phase("main_path_vit_b16", t0)

    # 12. Timing of flash_attention and the ViT-B/16 encoder (bf16, warm L2).
    t0 = time.perf_counter()
    for shape in FLASH_SHAPES[:2]:
        q, k_, v = (torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(3))
        k_ms, p_ms, turns = in_turns(lambda: fa.flash_attention(q, k_, v),
                                     lambda: fa.flash_attention_plain(q, k_, v))
        l_ms = time_ms(lambda: Fnn.scaled_dot_product_attention(q, k_, v))
        nbytes, flops = flash_work(shape, 2)
        b_s, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        per_batch = 12 if shape == FLASH_SHAPES[0] else 0
        log(f"time flash_attention bf16 {list(shape)} (x{per_batch} per batch): kernel "
            f"{k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} (turns "
            f"k,k,p,p {', '.join(f'{t:.4f}' for t in turns)}), scaled_dot_product_attention "
            f"{l_ms:.4f}, bound {b_s * 1e3:.5f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP), kernel at {b_s * 1e3 / k_ms:.3f} of the bound")
        if per_batch:
            add("flash_attention", k_ms, p_ms, l_ms, b_s, b_by, per_batch)

    batch = torch.from_numpy(np.random.RandomState(SEED + 11).randint(
        0, 256, (VIT_BATCH, 224, 224, 3), dtype=np.uint8)).to(dev)
    vits = {kr: load_vit(torch.bfloat16, kr) for kr in (True, False)}

    def vit_encode(kernel_route):
        with torch.no_grad():
            return vits[kernel_route](normalize_for("vit_b16", batch))

    k_ms, p_ms, turns = in_turns(lambda: vit_encode(True), lambda: vit_encode(False))
    log(f"time vit_b16 encoder bf16 B={VIT_BATCH} (normalize + 12 blocks): kernel route "
        f"{k_ms:.4f} ms, plain route {p_ms:.4f} ms (turns k,k,p,p "
        f"{', '.join(f'{t:.4f}' for t in turns)})")
    phase("timing_vit", t0)

    # 13. The flash backward (dq and dk/dv kernels) vs plain.
    t0 = time.perf_counter()
    bwd_errs = {}

    def faulty_bwd(q, k_, v, o, lse, do, n=1, cast=True):
        """The plain backward with p and ds cut to the first n terms of their
        split before the three products that take them (n = 1: rounded to
        bf16): another function, which the gates must refuse."""
        s_ = q.shape[-1] ** -0.5
        qs = (q * torch.tensor(s_, dtype=q.dtype, device=dev)).float()
        p = torch.exp(qs @ k_.float().transpose(-1, -2) - lse[..., None])
        ds = p * (do.float() @ v.float().transpose(-1, -2) - fb.dstat(o, do)[..., None])
        p, ds = cut_split(p, n), cut_split(ds, n)
        out = ((ds @ k_.float()) * s_, ds.transpose(-1, -2) @ qs, p.transpose(-1, -2) @ do.float())
        return tuple(t_.to(q.dtype) for t_ in out) if cast else out

    def bwd_gate(got, want, dtype):
        """dq, dk, dv against plain → (all pass, max_abs_errs, shares differing).
        float32: within 1e-4 x max; bf16: within one bf16 ulp plus that, and at
        most 1 % of the outputs differing at all (sound runs read 0.020-0.031 %,
        p and ds rounded to bf16 about 41 %)."""
        ok, errs_, shares = True, [], []
        for g_, w_ in zip(got, want):
            d_ = (g_.float() - w_.float()).abs()
            tol = 1e-4 * w_.float().abs().max().item()
            share = (d_ > 0).float().mean().item()
            close = (d_.max().item() <= tol if dtype == torch.float32
                     else one_ulp_gate(g_, w_, tol) and share <= 1e-2)
            ok = (ok and close and g_.dtype == w_.dtype and g_.shape == w_.shape
                  and bool(torch.isfinite(g_.float()).all()))
            errs_.append(d_.max().item())
            shares.append(share)
        return ok, errs_, shares

    for shape in FLASH_SHAPES:
        base = [torch.randn(*shape, generator=gen, device=dev) for _ in range(4)]
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k_, v, do = (t_.to(dtype) for t_ in base)
            o, lse = fa.flash_attention_with_lse(q, k_, v)
            got = fb.flash_attention_bwd(q, k_, v, o, lse, do)
            torch.cuda.synchronize()
            want = fb.flash_attention_bwd_plain(q, k_, v, o, lse, do)
            ok, b_errs, b_shares = bwd_gate(got, want, dtype)
            qa, ka, va = (t_.clone().requires_grad_() for t_ in (q, k_, v))
            auto = torch.autograd.grad(fa.flash_attention(qa, ka, va), (qa, ka, va), do)
            same = all(torch.equal(a_, b_) for a_, b_ in zip(auto, got))
            fault_ok, f_errs, f_shares = bwd_gate(faulty_bwd(q, k_, v, o, lse, do), want, dtype)
            log(f"flash backward vs plain {name} {list(shape)}: dq, dk, dv max_abs_err "
                f"{', '.join(f'{e:.3e}' for e in b_errs)}, share differing "
                f"{', '.join(f'{x:.3e}' for x in b_shares)}; autograd through flash_attention "
                f"== the kernels {same}; seeded fault (p, ds rounded to bf16) max_abs_err "
                f"{', '.join(f'{e:.3e}' for e in f_errs)}, share "
                f"{', '.join(f'{x:.3e}' for x in f_shares)}, refused {not fault_ok}: "
                f"{'ok' if ok and same and not fault_ok else 'FAILED'}")
            if not (ok and same):
                raise AssertionError(f"flash backward {name} {shape} disagrees with plain")
            if fault_ok:
                raise AssertionError(f"the backward gate passes a seeded fault ({name} {shape})")
            bwd_errs[(shape, name)] = b_errs
            if dtype == torch.bfloat16:
                D = fb.dstat(o, do).contiguous()
                got32 = (fb.launch_dq_f32_result(q, k_, v, do, lse, D),
                         *fb.launch_dkv_f32_result(q, k_, v, do, lse, D))
                torch.cuda.synchronize()
                want32 = (fb.dq_plain(q, k_, v, do, lse, D, cast=False),
                          *fb.dkv_plain(q, k_, v, do, lse, D, cast=False))
                cut2 = faulty_bwd(q, k_, v, o, lse, do, n=2, cast=False)
                if not f32_result_gate(
                        f"flash backward dq, dk, dv {list(shape)}",
                        [fa.f32_result_error(g_, w_) for g_, w_ in zip(got32, want32)],
                        [fa.f32_result_error(c_, w_) for c_, w_ in zip(cut2, want32)],
                        fa.F32_RESULT_TOL):
                    raise AssertionError(f"flash backward bf16 {shape}: float32 result gate")
    phase("flash_backward_vs_plain", t0)

    # 14. ViT-B/16 gradients, kernel route vs plain route, 8 seeded images and
    # a fixed linear loss.
    t0 = time.perf_counter()
    x = normalize_for("vit_b16", images)
    w_lin = torch.randn(8, 196, 768, generator=gen, device=dev)

    def vit_grads(dtype, kernel_route):
        kw = {"use_pallas": True} if kernel_route else {"attn_fn": fa.flash_attention_plain}
        enc = ViTB16Features(dtype=dtype, **kw)
        enc.load_state_dict(vit_state)
        enc.to(dev)
        zero_counts()
        loss = (enc(x).float() * w_lin).sum()
        grads = torch.autograd.grad(loss, list(enc.parameters()))
        torch.cuda.synchronize()
        ran = (fa.launches, fb.dq_launches, fb.dkv_launches)
        return {n_: g_.float() for (n_, _), g_ in zip(enc.named_parameters(), grads)}, ran

    def rel_l2(a_, b_):
        return ((a_ - b_).norm() / b_.norm()).item()

    def rel_l2_all(ga, gb):
        num = sum(((ga[n_] - gb[n_]) ** 2).sum() for n_ in gb)
        return (num.sqrt() / sum((g_ ** 2).sum() for g_ in gb.values()).sqrt()).item()

    want32, _ = vit_grads(torch.float32, False)
    got32, ran = vit_grads(torch.float32, True)
    worst = max((got32[n_] - w_).abs().max().item() / max(w_.abs().max().item(), 1e-30)
                for n_, w_ in want32.items())
    log(f"vit_b16 gradients f32, kernel route vs plain route: {len(want32)} parameters, worst "
        f"max_abs_err / max|plain| {worst:.3e} (<= 1e-4), rel L2 over all "
        f"{rel_l2_all(got32, want32):.3e}; launches flash_attention, dq, dk/dv {ran} "
        f"(12 each expected)")
    if not (worst <= 1e-4 and ran == (12, 12, 12)
            and all(bool(torch.isfinite(g_).all()) for g_ in got32.values())):
        raise AssertionError("ViT-B/16 kernel-route gradients disagree in float32")
    got16, ran16 = vit_grads(torch.bfloat16, True)
    plain16, _ = vit_grads(torch.bfloat16, False)
    k_worst = max(rel_l2(got16[n_], w_) for n_, w_ in want32.items())
    p_worst = max(rel_l2(plain16[n_], w_) for n_, w_ in want32.items())
    k_all, p_all = rel_l2_all(got16, want32), rel_l2_all(plain16, want32)
    log(f"vit_b16 gradients bf16 vs the f32 plain gradients: kernel route worst parameter rel L2 "
        f"{k_worst:.3e} (<= 1.5 x {p_worst:.3e}, the bf16 plain route's), over all {k_all:.3e} "
        f"(<= 1.5 x {p_all:.3e}); kernel vs plain route in bf16 over all "
        f"{rel_l2_all(got16, plain16):.3e}; launches {ran16}")
    if not (k_worst <= 1.5 * p_worst and k_all <= 1.5 * p_all and ran16 == (12, 12, 12)):
        raise AssertionError("ViT-B/16 kernel-route gradients disagree in bfloat16")
    del want32, got32, got16, plain16
    phase("vit_gradients", t0)

    # 15. Main path, training: the train CLI on vit_b16 with train_encoder,
    # then generate on its workdir; one step at V = 1024; and vg1k.
    t0 = time.perf_counter()
    enc_counts = {"fused_decode": 0, "fused_matmul": 0, "conv_direct": 0,
                  "flash_attention": 72, "flash_attention_bwd_dq": 60,
                  "flash_attention_bwd_dkv": 60}
    metric_keys = {"d_loss", "w_dist", "gp", "real_score", "fake_score", "g_loss",
                   "g_fake_score", "tau"}

    def read_metrics(wd, n_steps, keys):
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        if [r_["step"] for r_ in lines] != list(range(1, n_steps + 1)):
            raise AssertionError(f"metrics.jsonl steps {[r_['step'] for r_ in lines]}")
        for r_ in lines:
            if not keys <= set(r_) or not all(math.isfinite(v_) for v_ in r_.values()):
                raise AssertionError(f"metrics.jsonl line {r_} lacks a key or is not finite")
        if "images_per_sec" not in lines[-1]:
            raise AssertionError("metrics.jsonl has no throughput")
        return lines

    per_step = []  # the launches of each step of the CLI's run
    make_step = train_cli.make_step_fn

    def counting_step_fn(cfg_, step_mask=None):
        step_fn = make_step(cfg_, step_mask)

        def counted(state, batch, *args, **kwargs):
            before = read_counts()
            out = step_fn(state, batch, *args, **kwargs)
            after = read_counts()
            per_step.append({k_: after[k_] - before[k_] for k_ in after})
            return out

        return counted

    with tempfile.TemporaryDirectory() as wd:
        torch.cuda.reset_peak_memory_stats()
        train_cli.make_step_fn = counting_step_fn
        try:
            train_s, train_counts = run_cli(train_cli.main, [
                "--config", "vit_b16", "--workdir", wd, "--steps", str(TRAIN_STEPS),
                "--set", "train.train_encoder=true",
                "--set", f"data.num_synthetic_images={VIT_IMAGES}", "--set",
                "train.log_every=1"], "sgg_torch.cli.train")
        finally:
            train_cli.make_step_fn = make_step
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want_counts = {k_: TRAIN_STEPS * v_ for k_, v_ in enc_counts.items()}
        lines = read_metrics(wd, TRAIN_STEPS, metric_keys | {"enc_gnorm"})
        train_cfg, train_vocab = load_workdir(wd)
        train_cfg.model.vocab_size = len(train_vocab)
        log(f"train vit_b16 train_encoder: {TRAIN_STEPS} steps in {train_s:.3f} s in process, "
            f"launches {train_counts} (expected {want_counts}); last step "
            f"{1 / lines[-1]['steps_per_sec']:.4f} s/step, {lines[-1]['images_per_sec']:.1f} "
            f"images/s; peak device memory {peak_gb:.2f} GB; widths: ViT "
            f"{train_cfg.model.vit_dims}, {train_cfg.data.image_size} px, decoder hidden "
            f"{train_cfg.model.hidden} x {train_cfg.model.num_layers} layers, V = "
            f"{train_cfg.model.vocab_size} (the synthetic source's vocab), batch "
            f"{train_cfg.train.batch_size}, n_critic {train_cfg.train.n_critic}, "
            f"{train_cfg.model.compute_dtype}; last losses d {lines[-1]['d_loss']:.4f}, "
            f"g {lines[-1]['g_loss']:.4f}, gp {lines[-1]['gp']:.4f}, enc_gnorm "
            f"{lines[-1]['enc_gnorm']:.4f}")
        log(f"launches per step: {per_step}")
        if train_counts != want_counts or per_step != [enc_counts] * TRAIN_STEPS:
            raise AssertionError("the training path did not launch its kernels as expected")
        mgr = CheckpointManager(wd, train_cfg)
        fresh = create_train_state(train_cfg, train_cfg.train.seed, device=dev)
        initial = {k_: v_.clone() for k_, v_ in fresh.encoder.state_dict().items()}
        if mgr.all_steps() != [TRAIN_STEPS] or mgr.restore(fresh) is None \
                or fresh.step != TRAIN_STEPS:
            raise AssertionError(f"checkpoint steps {mgr.all_steps()}, restored {fresh.step}")
        trained = fresh.encoder.state_dict()
        moved = sum(not torch.equal(initial[k_], v_) for k_, v_ in trained.items())
        saved = torch.load(os.path.join(wd, "generator.pt"), map_location="cpu",
                           weights_only=True)
        same_enc = all(torch.equal(saved["enc_params"][k_], v_.cpu())
                       for k_, v_ in trained.items())
        log(f"checkpoint {mgr.all_steps()} read back at step {fresh.step}; encoder tensors "
            f"moved {moved} of {len(trained)}; generator.pt holds the trained encoder {same_enc}")
        if moved != len(trained) or not same_enc or saved["step"] != TRAIN_STEPS:
            raise AssertionError("the trained encoder did not move or was not saved")
        del fresh, initial, trained, saved
        out_path = os.path.join(wd, "graphs.json")
        tg_s, tg_counts = run_generate(
            ["--workdir", wd, "--out", out_path, "--num-samples", "4",
             "--batch-size", str(VIT_BATCH), "--seed", str(SEED)])
        n_batches = math.ceil(VIT_IMAGES / VIT_BATCH)
        log(f"generate on the trained workdir: {tg_s:.3f} s, launches {tg_counts}")
        if tg_counts["flash_attention"] != n_batches * 12 or tg_counts["flash_attention_bwd_dq"]:
            raise AssertionError("generate on the trained workdir launched unexpectedly")
        check_graphs(out_path, train_vocab, VIT_IMAGES, k_draws=4)

    # One step at V = 1024 through the entry points the CLI uses.
    cfg1k = get_config("vit_b16")
    cfg1k.train.train_encoder = True
    cfg1k.model.vocab_size = VIT_VOCAB
    objs1k, preds1k = np.flatnonzero(vit_vocab.is_object), np.flatnonzero(vit_vocab.is_predicate)
    tri1k = [np.stack([rng.choice(objs1k, 4), rng.choice(preds1k, 4), rng.choice(objs1k, 4)],
                      axis=1).astype(np.int32) for _ in range(VIT_IMAGES)]
    ds1k = ArrayImageTripleDataset(images=np.random.RandomState(SEED + 12).randint(
        0, 256, (VIT_IMAGES, 224, 224, 3), dtype=np.uint8), triples=tri1k)
    state1k = create_train_state(cfg1k, SEED, device=dev)
    step1k = make_step_fn(cfg1k, step_mask=vit_vocab.step_mask())
    it1k = make_device_train_iterator(ds1k, cfg1k.train.batch_size, cfg1k.train.n_critic,
                                      device=dev)
    batch1k = next(it1k)
    torch.cuda.synchronize()
    zero_counts()
    t1k = time.perf_counter()
    m1k = {k_: float(v_) for k_, v_ in step1k(state1k, batch1k).items()}
    step1k_s = time.perf_counter() - t1k
    counts1k = read_counts()
    log(f"train step vit_b16 V = {VIT_VOCAB}: {step1k_s:.3f} s (the first step, cold), "
        f"launches {counts1k}, metrics {m1k}")
    if counts1k != enc_counts or not all(math.isfinite(v_) for v_ in m1k.values()):
        raise AssertionError("the V = 1024 step launched unexpectedly or is not finite")
    del state1k, step1k, it1k, batch1k, ds1k

    with tempfile.TemporaryDirectory() as wd:
        vg_s, vg_counts = run_cli(train_cli.main, [
            "--config", "vg1k", "--workdir", wd, "--steps", str(TRAIN_STEPS),
            "--set", "train.log_every=1"], "sgg_torch.cli.train")
        vg_lines = read_metrics(wd, TRAIN_STEPS, metric_keys)
        log(f"train vg1k: {TRAIN_STEPS} steps in {vg_s:.3f} s in process, launches {vg_counts} "
            f"(none expected); last step {1 / vg_lines[-1]['steps_per_sec']:.4f} s/step, "
            f"{vg_lines[-1]['images_per_sec']:.1f} images/s")
        if any(vg_counts.values()):
            raise AssertionError("vg1k training launched a kernel")
    phase("main_path_train", t0)

    # 16. Timing of the dq and dk/dv kernels (bf16, warm L2).
    t0 = time.perf_counter()
    shape = FLASH_SHAPES[0]
    q, k_, v, do = (torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(4))
    o, lse = fa.flash_attention_with_lse(q, k_, v)
    D = fb.dstat(o, do)
    qa, ka, va = (t_.clone().requires_grad_() for t_ in (q, k_, v))
    so = Fnn.scaled_dot_product_attention(qa, ka, va)
    l_ms = time_ms(lambda: torch.autograd.grad(so, (qa, ka, va), do, retain_graph=True))
    Bq, Hq, Sq, Dq = shape
    bhsd, bhs = Bq * Hq * Sq * Dq, Bq * Hq * Sq
    for name, kern, plain, n_in, n_out, n_prod in (
            ("flash_attention_bwd_dq", lambda: fb.launch_dq(q, k_, v, do, lse, D),
             lambda: fb.dq_plain(q, k_, v, do, lse, D), 4, 1, 3),
            ("flash_attention_bwd_dkv", lambda: fb.launch_dkv(q, k_, v, do, lse, D),
             lambda: fb.dkv_plain(q, k_, v, do, lse, D), 4, 2, 4)):
        k_ms, p_ms, turns = in_turns(kern, plain)
        nbytes = (n_in + n_out) * bhsd * 2 + 2 * bhs * 4  # + lse and D, float32
        flops = n_prod * 2 * Bq * Hq * Sq * Sq * Dq
        b_s, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        f32_floor = (n_prod - 2) * 2 * Bq * Hq * Sq * Sq * Dq / F32_FLOPS_PER_S
        log(f"time {name} bf16 {list(shape)} (x60 per train step): kernel {k_ms:.4f} ms "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} (turns k,k,p,p "
            f"{', '.join(f'{t_:.4f}' for t_ in turns)}), scaled_dot_product_attention backward "
            f"(dq, dk and dv together) {l_ms:.4f}, bound {b_s * 1e3:.5f} ms ({b_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), reference line: float32 floor "
            f"of its products that take p or ds on the CUDA cores {f32_floor * 1e3:.5f} ms (they "
            f"now run split on the tensor cores); kernel at {b_s * 1e3 / k_ms:.3f} of the bound")
        add(name, k_ms, p_ms, l_ms, b_s, b_by, 60)
    phase("timing_backward", t0)
    log(f"total: {time.perf_counter() - t_all:.3f} s")

    sources = {"fused_decode": ("sgg_torch/kernels/csrc/fused_decode.cu",
                                "sgg/kernels/fused_decode.py:127"),
               "fused_matmul": ("sgg_torch/kernels/csrc/fused_matmul.cu",
                                "sgg/kernels/matmul.py:43"),
               "conv_direct": ("sgg_torch/kernels/csrc/conv_direct.cu",
                               "sgg/kernels/conv_direct.py:93"),
               "flash_attention": ("sgg_torch/kernels/csrc/flash_attention.cu",
                                   "sgg/kernels/flash_attention.py:35"),
               "flash_attention_bwd_dq": ("sgg_torch/kernels/csrc/flash_attention_bwd.cu",
                                          "sgg/kernels/flash_attention_bwd.py:69"),
               "flash_attention_bwd_dkv": ("sgg_torch/kernels/csrc/flash_attention_bwd.cu",
                                           "sgg/kernels/flash_attention_bwd.py:122")}
    errs = {"fused_decode": pix_errs[("bf16", PIX_BATCH)],
            "fused_matmul": max(v for k_, v in shape_errs.items()
                                if k_[0] == "mm" and k_[4] == "bf16"),
            "conv_direct": max(v for k_, v in shape_errs.items()
                               if k_[0] == "conv" and k_[3] == "bf16"),
            "flash_attention": flash_errs[(FLASH_SHAPES[0], "bf16")],
            "flash_attention_bwd_dq": bwd_errs[(FLASH_SHAPES[0], "bf16")][0],
            "flash_attention_bwd_dkv": max(bwd_errs[(FLASH_SHAPES[0], "bf16")][1:])}
    path_counts = dict(pix_counts, **{k_: train_counts[k_] for k_ in (
        "flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")})
    kernels = []
    for name, (src, replaces) in sources.items():
        r_ = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": path_counts[name], "max_abs_err": errs[name],
            "ms": r_["ms"] / r_["w"], "plain_ms": r_["plain"] / r_["w"],
            "bound_ms": r_["bound"] / r_["w"], "bound_by": r_["by"].most_common(1)[0][0],
            "library_ms": r_["lib"] / r_["w"] if name != "fused_decode" else None,
        })
    faulthandler.cancel_dump_traceback_later()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
