"""``export`` entry point, from ``sgg/cli/export.py``: package a trained
port workdir's sampler as one artifact (``sgg_torch.export``), a file that a
serving host loads and calls with torch alone, with no model code.

  python -m sgg_torch.cli.export --workdir /runs/vg1k --out model.pt2 --check
  python -m sgg_torch.cli.export --workdir /runs/r50 --with-encoder --quant int8 --check

``--check`` reloads the file on ``--device`` and compares its tokens with the
live sampler's (``make_sampler``; with ``--with-encoder`` after the workdir's
encoder on the library route, quantized alike) for the same inputs and the
same noise, drawn from ``--seed``; any difference exits 1. ``--platforms``
takes ``cpu`` and ``cuda`` (one artifact carries both); ``tpu`` is refused.
It runs on CUDA unless ``--device cpu`` is given, and raises if CUDA is not
there; the program is traced on the CPU either way.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from sgg_torch.cli.common import add_device_arg, resolve_device
from sgg_torch.train.checkpoint import load_workdir, restore_weights


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True, help="trained run directory")
    p.add_argument("--out", default=None, help="artifact path (default: workdir/model.pt2)")
    p.add_argument("--batch-size", type=int, default=32,
                   help="traced batch (requests pad to it, like serve); 0 = a symbolic "
                        "batch (any batch at call time)")
    p.add_argument("--num-samples", type=int, default=50,
                   help="noise draws per image baked into the program")
    p.add_argument("--temperature", type=float, default=None,
                   help="sampling temperature: tokens ~ softmax(logits / T) (default 1.0)")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma-separated devices the artifact is for (cpu, cuda)")
    p.add_argument("--with-encoder", action="store_true",
                   help="encoder configs: bake the encoder into the artifact — pixels in, "
                        "scene graphs out")
    p.add_argument("--quant", default=None, choices=["none", "int8"],
                   help="with --with-encoder: PTQ mode of the baked encoder (overrides "
                        "cfg.model.quant)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and require tokens bit-identical to the live "
                        "sampler's for the same noise")
    p.add_argument("--ema", action="store_true",
                   help="bake the EMA generator weights (a run trained with "
                        "train.ema_decay > 0)")
    p.add_argument("--avg-last", type=int, default=0, metavar="N",
                   help="bake the mean of the last N retained checkpoints' generator "
                        "weights; composes with --ema")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from sgg_torch.export import (
        artifact_noise,
        check_platforms,
        export_sampler,
        load_artifact,
        save_artifact,
    )

    platforms = tuple(s.strip() for s in args.platforms.split(",") if s.strip())
    try:
        check_platforms(platforms)
    except ValueError as e:
        print(f"[sgg.export] {e}", file=sys.stderr)
        return 2
    cfg, vocab = load_workdir(args.workdir)
    cfg.model.vocab_size = len(vocab)
    restored = restore_weights(args.workdir, cfg, args.avg_last, torch.device("cpu"))
    if restored is None:
        print(f"[sgg.export] no checkpoint in {args.workdir}", file=sys.stderr)
        return 1
    step, g_params, g_ema, enc_params, _ = restored
    if args.ema:
        if g_ema is None:
            print("[sgg.export] --ema: checkpoint has no EMA weights "
                  "(train with train.ema_decay > 0)", file=sys.stderr)
            return 1
        g_params = g_ema
    quant = ""
    if args.with_encoder:
        if cfg.model.encoder == "precomputed" or enc_params is None:
            print("[sgg.export] --with-encoder needs an encoder config", file=sys.stderr)
            return 1
        quant = cfg.model.quant if args.quant is None else (
            "" if args.quant == "none" else args.quant)
    else:
        enc_params = None
    exported, meta = export_sampler(
        cfg, vocab, g_params, enc_params=enc_params, quant=quant,
        batch_size=args.batch_size, num_samples=args.num_samples,
        temperature=args.temperature, platforms=platforms,
    )
    meta["step"] = int(step)
    out = args.out or os.path.join(args.workdir, "model.pt2")
    save_artifact(out, exported, meta)
    print(f"[sgg.export] step {int(step)} → {out} ({os.path.getsize(out) / 1e6:.1f} MB, "
          f"platforms={list(platforms)}, batch={args.batch_size}, k={args.num_samples}, "
          f"input={meta['input']}, quant={meta['quant'] or 'none'})", flush=True)

    if args.check:
        from sgg_torch.eval.sampler import make_sampler
        from sgg_torch.models.encoders import make_image_encoder

        call, meta2 = load_artifact(out, device)
        r = np.random.RandomState(args.seed)
        check_b = args.batch_size or 4  # a symbolic batch takes any size
        if meta2["input"] == "images":
            s = cfg.data.image_size
            x = torch.from_numpy(r.randint(0, 256, (check_b, s, s, 3)).astype(np.uint8))
            cfg.model.use_pallas = False  # the artifact's encoder route
            feats = make_image_encoder(cfg, enc_params, device, quant=quant)(x.to(device))
        else:
            x = torch.from_numpy(r.randn(check_b, cfg.data.regions, cfg.data.feat_dim)
                                 .astype(np.float32)).to(cfg.model.dtype)
            feats = x.to(device)
        z, gumbel = artifact_noise(meta2, check_b,
                                   torch.Generator(device).manual_seed(args.seed), device)
        got = call(x, z, gumbel).cpu().numpy()
        live = make_sampler(cfg, step_mask=vocab.step_mask(), num_samples=args.num_samples,
                            tau=args.temperature)
        want = live({k: v.to(device) for k, v in g_params.items()}, feats,
                    noise=(z, gumbel)).cpu().numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            n_diff = int((got != want).sum()) if got.shape == want.shape else -1
            print(f"[sgg.export] CHECK FAILED: artifact tokens differ from the live "
                  f"sampler's ({n_diff} of {want.size})", file=sys.stderr)
            return 1
        if meta2["vocab_tokens"] != list(vocab.tokens):
            print("[sgg.export] CHECK FAILED: the artifact's vocab differs", file=sys.stderr)
            return 1
        print(f"[sgg.export] check ok: {got.shape} tokens bit-identical on {device}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
