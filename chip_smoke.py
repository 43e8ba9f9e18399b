#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``sgg_torch``) on one NVIDIA H100.

  python3 chip_smoke.py

In one process, with no threads and no sockets:
  1. device: CUDA present, compute capability 9.0; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: nvcc compiles ``sgg_torch/kernels/csrc/*.cu`` for sm_90a;
  3. kernel vs plain: ``fused_decode`` against ``decode_plain`` on the card
     at the trained run's widths (V from its vocab.json, R=196, F=512,
     H=512, E=256, A=256, Z=128), seeded weights, the real step mask,
     B = 64 and B = 37, float32 and bfloat16, soft and hard;
  4. main path: ``python -m sgg_torch.cli.generate`` (in process) on a port
     workdir with the trained run's config.json and vocab.json, seeded
     generator weights and 512 seeded feature images, K = 50 draws, batch 64;
     the launch count must be exactly ceil(512/64) * 50; the output JSON is
     read back and checked; one batch of the CUDA sampler is held against the
     same sampler on the CPU (plain version) given the same noise;
  5. timing: ms per launch (CUDA events) of the kernel and of its plain
     version at the main path's shapes, beside the bound.

The last two lines are the kernels' JSON record and the device JSON. A
failed check raises, so the exit code is not 0; a watchdog turns a hang into
a stack trace and a non-zero exit.
"""

import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import time

WATCHDOG_SECONDS = 600
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAINED_RUN = os.path.join(ROOT, "results", "run_v3_bal0.7_ckpt")
SEED = 0
N_IMAGES, BATCH, K = 512, 64, 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def phase(name, t0):
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")


def decode_bound(B, R, F, A, H, E, Z, V, dtype_bytes, flops_per_s):
    """Least time (s) one fused_decode launch could take: each input read
    once and the output written once over the HBM rate, against the
    arithmetic over the peak rate for the compute type."""
    K = F + E + Z + H
    weights = F * A + H * A + A + F * H * 2 + K * 4 * H + (H + F) * E + E * V + V * E
    biases = A + 2 * H + 4 * H + E + V
    nbytes = (B * R * F + B * Z + weights + B * 3 * V) * dtype_bytes \
        + (B * 3 * V + 3 * V + biases) * 4
    flops = (2 * B * R * F * A + B * R * F + 2 * 2 * B * F * H
             + 3 * 2 * B * (H * A + R * A + R * F + K * 4 * H + (H + F) * E + E * V + V * E))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def main():
    faulthandler.dump_traceback_later(WATCHDOG_SECONDS, exit=True)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs the card")
    sys.path.insert(0, ROOT)
    import numpy as np

    from sgg_torch.cli import generate
    from sgg_torch.config import Config
    from sgg_torch.data import Vocab, write_feature_shard
    from sgg_torch.data.shards import shard_name
    from sgg_torch.eval.sampler import make_fused_sampler
    from sgg_torch.kernels import build
    from sgg_torch.kernels import fused_decode as fd
    from sgg_torch.models.generator import AttentionLSTMGenerator
    from sgg_torch.train.checkpoint import save_generator
    from sgg_torch.utils.gumbel import sample_gumbel

    t_all = time.perf_counter()
    dev = torch.device("cuda")

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
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full float32
    torch.backends.cudnn.allow_tf32 = False
    phase("device", t0)

    # 2. Build.
    t0 = time.perf_counter()
    lib_path, build_s = build.build()
    log(f"nvcc build: {build_s:.2f} s -> {os.path.relpath(lib_path, ROOT)}")
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"ptxas: {line.strip()}")
    build.load_library()
    phase("build", t0)

    # 3. Kernel vs plain on the card at the trained run's widths.
    t0 = time.perf_counter()
    with open(os.path.join(TRAINED_RUN, "config.json")) as f:
        run_cfg = json.load(f)
    vocab = Vocab.load(os.path.join(TRAINED_RUN, "vocab.json"))
    cfg = Config.from_dict(run_cfg)
    cfg.model.vocab_size = len(vocab)
    m = cfg.model
    R, F, A, H, E, Z, V = (cfg.data.regions, cfg.data.feat_dim, m.attn_dim,
                           m.hidden, m.embed_dim, m.noise_dim, m.vocab_size)
    log(f"widths: V={V} R={R} F={F} A={A} H={H} E={E} Z={Z} compute={m.compute_dtype}")
    torch.manual_seed(SEED)
    sd = AttentionLSTMGenerator.from_config(cfg).state_dict()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mask_bias = fd.step_mask_bias(vocab.step_mask(), dev)
    feats64 = torch.randn(BATCH, R, F, generator=gen, device=dev)
    errs = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        params = fd.decode_params_from_generator(sd, dtype, dev)
        for B in (BATCH, 37):
            feats = feats64[:B].to(dtype).contiguous()
            z = torch.randn(B, Z, generator=gen, device=dev).to(dtype)
            g = sample_gumbel((B, 3, V), gen, device=dev)
            y = fd.fused_decode(params, feats, z, g, mask_bias=mask_bias, hard=False)
            torch.cuda.synchronize()
            want = fd.decode_plain(params, feats, z, g, mask_bias=mask_bias, hard=False)
            err = (y.float() - want.float()).abs().max().item()
            # Token agreement over 8 noise draws: 8 * B * 3 (row, step) pairs.
            same = total = 0
            for _ in range(8):
                z = torch.randn(B, Z, generator=gen, device=dev).to(dtype)
                g = sample_gumbel((B, 3, V), gen, device=dev)
                yh = fd.fused_decode(params, feats, z, g, mask_bias=mask_bias, hard=True)
                torch.cuda.synchronize()
                wh = fd.decode_plain(params, feats, z, g, mask_bias=mask_bias, hard=True)
                same += (yh.argmax(-1) == wh.argmax(-1)).sum().item()
                total += yh.shape[0] * 3
            agree = same / total
            tol, need = (1e-4, 0.999) if dtype == torch.float32 else (2e-2, 0.99)
            log(f"kernel vs plain {name} B={B}: soft max_abs_err {err:.3e} (<= {tol}), "
                f"hard tokens identical {agree:.5f} of {total} (>= {need})")
            if not (err <= tol and agree >= need and torch.isfinite(y.float()).all()):
                raise AssertionError(f"fused_decode disagrees with decode_plain ({name}, B={B})")
            errs[(name, B)] = err
    phase("kernel_vs_plain", t0)

    # 4. Main path: the generate CLI end to end, in process.
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
        rng = np.random.default_rng(SEED)
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
        argv = ["--workdir", wd, "--out", out_path, "--num-samples", str(K),
                "--batch-size", str(BATCH), "--recall-k", "50", "--ema",
                "--seed", str(SEED)]
        torch.cuda.synchronize()
        fd.launches = 0
        t_gen = time.perf_counter()
        rc = generate.main(argv)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t_gen
        main_launches = fd.launches
        if rc != 0:
            raise AssertionError(f"sgg_torch.cli.generate returned {rc}")
        want_launches = math.ceil(N_IMAGES / BATCH) * K
        log(f"generate: {gen_s:.3f} s in process, fused_decode launches "
            f"{main_launches} (expected {want_launches}), "
            f"{N_IMAGES * K / gen_s:.0f} triples/s including set-up")
        if main_launches != want_launches:
            raise AssertionError("the main path did not launch fused_decode as expected")
        with open(out_path) as f:
            out = json.load(f)
        graphs = out["scene_graphs"]
        if out["num_images"] != N_IMAGES or len(graphs) != N_IMAGES:
            raise AssertionError("wrong number of scene graphs")
        obj_names = {vocab.tokens[i] for i in objs}
        pred_names = {vocab.tokens[i] for i in preds}
        for gr in graphs:
            if sum(t["count"] for t in gr["triples"]) != K:
                raise AssertionError(f"image {gr['image_id']}: counts do not sum to {K}")
            for t in gr["triples"]:
                if not (t["subject"] in obj_names and t["object"] in obj_names
                        and t["predicate"] in pred_names):
                    raise AssertionError(f"illegal triple {t}")
        n_unique = sum(len(gr["triples"]) for gr in graphs)
        log(f"output: {len(graphs)} graphs, {n_unique} unique triples, all type-legal")

        # One batch of the CUDA sampler against the CPU sampler (plain
        # version) given the same noise.
        Ks, Bs = 8, 16
        sampler = make_fused_sampler(cfg, step_mask=vocab.step_mask(), num_samples=Ks)
        feats = torch.from_numpy(rng.standard_normal((Bs, R, F), dtype=np.float32))
        z = torch.randn(Ks, Bs, Z, generator=gen, device=dev).to(cfg.model.dtype)
        g = sample_gumbel((Ks, Bs, 3, V), gen, device=dev)
        gpu_tok = sampler({k: v.to(dev) for k, v in g_ema.items()}, feats.to(dev),
                          noise=(z, g)).cpu()
        cpu_tok = sampler(g_ema, feats, noise=(z.cpu(), g.cpu()))
        agree = (gpu_tok == cpu_tok).float().mean().item()
        log(f"sampler tokens, CUDA vs CPU plain, same noise: {agree:.4f} identical")
        if gpu_tok.shape != (Bs, Ks, 3) or agree < 0.99:
            raise AssertionError("CUDA sampler disagrees with the CPU sampler")
    phase("main_path", t0)

    # 5. Timing at the main path's shapes (bf16, B=64, hard, warm L2: the
    #    sampler reuses weights and the batch's features across its K draws).
    t0 = time.perf_counter()
    dtype = cfg.model.dtype
    params = fd.decode_params_from_generator(sd, dtype, dev)
    feats = feats64.to(dtype).contiguous()
    z = torch.randn(BATCH, Z, generator=gen, device=dev).to(dtype)
    g = sample_gumbel((BATCH, 3, V), gen, device=dev)

    def time_ms(fn, n):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    run_kernel = lambda: fd.fused_decode(params, feats, z, g, mask_bias=mask_bias, hard=True)  # noqa: E731
    run_plain = lambda: fd.decode_plain(params, feats, z, g, mask_bias=mask_bias, hard=True)  # noqa: E731
    plain_ms_a = time_ms(run_plain, 20)
    kernel_ms_a = time_ms(run_kernel, 100)
    kernel_ms_b = time_ms(run_kernel, 100)
    plain_ms_b = time_ms(run_plain, 20)
    kernel_ms = min(kernel_ms_a, kernel_ms_b)
    plain_ms = min(plain_ms_a, plain_ms_b)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    bound_s, bound_by, nbytes, flops = decode_bound(
        BATCH, R, F, A, H, E, Z, V, feats.element_size(), peak)
    log(f"fused_decode {m.compute_dtype} B={BATCH}: kernel {kernel_ms_a:.4f} / "
        f"{kernel_ms_b:.4f} ms per launch, plain {plain_ms_a:.4f} / {plain_ms_b:.4f} ms")
    log(f"bound: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP -> "
        f"{bound_s * 1e3:.5f} ms ({bound_by}); kernel at "
        f"{bound_s * 1e3 / kernel_ms:.4f} of the bound; per batch of {K} draws "
        f"{K * kernel_ms:.3f} ms vs bound {K * bound_s * 1e3:.4f} ms")
    phase("timing", t0)
    log(f"total: {time.perf_counter() - t_all:.3f} s")

    record = {"kernels": [{
        "name": "fused_decode",
        "route": "cuda",
        "source": "sgg_torch/kernels/csrc/fused_decode.cu",
        "replaces": "sgg/kernels/fused_decode.py:127",
        "launches": main_launches,
        "max_abs_err": errs[("bf16", BATCH)],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    faulthandler.cancel_dump_traceback_later()
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
