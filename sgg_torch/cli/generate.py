"""Sample scene graphs from a port workdir, optionally scoring recall@k.

Port of ``sgg/cli/generate.py``: read the workdir (config, vocab, generator
weights), draw K noise samples per test image, dedupe and rank the triples by
frequency, write the scene graphs as JSON.

  python -m sgg_torch.cli.generate --workdir W --num-samples 50 \\
      --batch-size 64 --recall-k 50 [--decode xla|fused] [--ema] [--device cpu]

``--decode xla`` (the default, as in the reference) runs the generator's own
forward per draw, for either decoder (``model.decoder`` ``lstm`` or
``transformer``); ``--decode fused`` runs one ``fused_decode`` launch per
draw and batch, attention-LSTM only.

Pixels-in configs (``model.encoder`` ``vgg19``, ``resnet50`` or ``vit_b16``,
e.g. the named configs ``resnet50`` and ``vit_b16``) run the workdir's
encoder weights on each batch of uint8 images first (normalization, then the
backbone in the compute dtype), and the features stay on the device for the
sampler. The encoder's kernel route comes from ``model.use_pallas``: when
set, ``'auto'`` (the CUDA conv kernels; for the ViT the CUDA flash
attention), else the library conv and the unfused attention. The ViT is
built from ``data.image_size`` and ``model.vit_dims``. The images come from
the ``synthetic`` source (in memory) or the ``vg`` source (the JPEGs of
``data.data_dir/images``, decoded per batch by the native loader; ``--split
test`` takes the held-out ids).

``--temperature``, ``--top-k``/``--top-p`` and ``--rank freq_logp|logp``
(which samples with per-draw log-probabilities) take the generator-forward
sampler; ``--decode fused`` refuses them, as the reference does. ``--avg-last
N`` samples from the mean of the generator's weights over the last N
retained checkpoints (with ``--ema``, of their EMA).

``--quant int8`` (or ``model.quant=int8`` in the workdir's config) runs the
encoder's dynamic int8 PTQ (``sgg_torch.kernels.quant``): the CNN convs and
the ViT's projections sum s8×s8 products into int32 (``torch._int_mm`` on the
card), the ViT's attention stays on its route; ``--quant none`` forces the
float encoder. A precomputed-feature workdir has no encoder to quantize and
refuses ``--quant int8``.

It runs on CUDA unless ``--device cpu`` is given, and raises if CUDA is not
there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from sgg_torch.cli.common import add_device_arg, load_dataset, resolve_device
from sgg_torch.config import Config
from sgg_torch.data.extract import load_batch
from sgg_torch.eval.recall import corpus_recall
from sgg_torch.eval.sampler import (
    assemble_scene_graphs,
    device_put_features,
    make_fused_sampler,
    make_indexed_sampler,
    make_sampler,
)
from sgg_torch.kernels.build import load_library
from sgg_torch.models.encoders import make_image_encoder
from sgg_torch.train.checkpoint import load_workdir, restore_weights


def make_batch_features(cfg: Config, ds, enc_params: dict | None, device: torch.device,
                        quant: str | None = None):
    """indices → features [n, R, F] on ``device``, as ``sgg.cli.common``'s
    (``sgg/cli/common.py:224-262``).

    Precomputed configs index the dataset's feature array; pixels-in configs
    run the encoder (weights ``enc_params``, a port state_dict; ``quant``
    overrides ``model.quant``: '' float, 'int8' PTQ) on the batch's uint8
    images (in memory, or decoded from a path-backed dataset's JPEGs by
    ``load_batch``) and return its output in the compute dtype, without a
    round trip through the host."""
    if cfg.model.encoder == "precomputed":
        return lambda idx: torch.from_numpy(ds.features[idx]).to(device)
    encode = make_image_encoder(cfg, enc_params, device, quant=quant)

    def images(idx) -> np.ndarray:
        if hasattr(ds, "images"):  # in-memory uint8 images
            return ds.images[idx]
        return load_batch([ds.paths[int(i)] for i in idx], ds.image_size)

    return lambda idx: encode(torch.from_numpy(images(idx)).to(device))


def _refusal(args) -> str | None:
    if args.decode != "fused":
        return None
    if args.top_k or args.top_p is not None:
        return ("--top-k/--top-p filter the sampling distribution, which the fused kernel "
                "does not implement; use --decode xla")
    if args.rank != "freq":
        return ("--rank freq_logp/logp needs per-draw log-probs, which the fused kernel "
                "does not emit; use --decode xla")
    if args.temperature is not None and args.temperature != 1.0:
        return "the fused kernel samples at temperature 1.0 only; use --decode xla"
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True, help="run directory")
    p.add_argument("--out", default=None, help="output JSON path (default: workdir/scene_graphs.json)")
    p.add_argument("--num-samples", type=int, default=50, help="noise draws per image")
    p.add_argument("--temperature", type=float, default=None,
                   help="sampling temperature: tokens ~ softmax(logits / T), default 1.0")
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling per decode step (--decode xla only)")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k sampling per decode step, 0 = off (--decode xla only)")
    p.add_argument("--rank", default="freq", choices=["freq", "freq_logp", "logp"],
                   help="triple order: sample count (freq, ties lexicographic), count with a "
                        "log-prob tiebreak (freq_logp) or probability mass (logp)")
    p.add_argument("--num-images", type=int, default=None, help="limit images")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--recall-k", type=int, default=None, help="also report recall@k vs ground truth")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--split", default="test", choices=["train", "test"],
                   help="evaluate on held-out shards when available (default)")
    p.add_argument("--decode", default="xla", choices=["xla", "fused"],
                   help="decode path: 'xla' = the generator's forward per draw, "
                        "'fused' = one fused_decode kernel launch per draw "
                        "(attention-LSTM decoder only)")
    p.add_argument("--ema", action="store_true", help="sample from the EMA generator weights")
    p.add_argument("--avg-last", type=int, default=0, metavar="N",
                   help="average the generator's weights over the last N retained "
                        "checkpoints (see sgg_torch.cli.evaluate --avg-last)")
    p.add_argument("--quant", default=None, choices=["none", "int8"],
                   help="the encoder's PTQ mode (overrides model.quant): int8 sums "
                        "s8 x s8 products into int32 (torch._int_mm on the card)")
    add_device_arg(p)
    args = p.parse_args(argv)
    refusal = _refusal(args)
    if refusal:
        print(f"[sgg.generate] {refusal}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    cfg, vocab = load_workdir(args.workdir)
    cfg.model.vocab_size = len(vocab)
    if args.quant == "int8" and cfg.model.encoder == "precomputed":
        print("[sgg.generate] --quant int8 quantizes the encoder; this workdir's "
              "model.encoder is 'precomputed' (no encoder to quantize)", file=sys.stderr)
        return 2
    if args.decode == "fused" and cfg.model.decoder != "lstm":
        print(f"[sgg.generate] --decode fused runs the attention-LSTM decoder only; this "
              f"workdir's model.decoder is {cfg.model.decoder!r}: use --decode xla",
              file=sys.stderr)
        return 2
    ds, _ = load_dataset(cfg, split=args.split)
    n_images = min(args.num_images or len(ds), len(ds))

    restored = restore_weights(args.workdir, cfg, args.avg_last, device)
    if restored is None:
        print(f"[sgg.generate] no generator weights in {args.workdir}", file=sys.stderr)
        return 1
    step, g_params, g_ema, enc_params, avg_steps = restored
    avg = ("" if avg_steps is None else
           f" (generator averaged over the last {len(avg_steps)} checkpoints)")
    print(f"[sgg.generate] restored step {step}{avg}", flush=True)
    if args.ema:
        if g_ema is None:
            print("[sgg.generate] --ema: checkpoint has no EMA weights "
                  "(train with train.ema_decay > 0)", file=sys.stderr)
            return 1
        g_params = g_ema
    g_params = {k: v.to(device) for k, v in g_params.items()}
    generator = torch.Generator(device=device).manual_seed(args.seed)
    dtype = cfg.model.dtype
    end_to_end = cfg.model.encoder != "precomputed"
    if end_to_end and enc_params is None:
        print(f"[sgg.generate] encoder {cfg.model.encoder!r}: no encoder weights "
              f"(enc_params) in {args.workdir}", file=sys.stderr)
        return 1
    quant = None if args.quant is None else ("" if args.quant == "none" else args.quant)
    batch_features = make_batch_features(cfg, ds, enc_params, device, quant=quant)

    # Device-resident path: upload the whole feature set once and gather each
    # batch by index on the device.
    B = args.batch_size
    with_logp = args.rank != "freq"
    device_resident = (not end_to_end
                       and ds.features.nbytes <= cfg.data.device_resident_max_bytes)
    t_up = 0.0
    if args.decode == "fused":
        sampler = make_fused_sampler(
            cfg, step_mask=vocab.step_mask(), num_samples=args.num_samples,
            tau=args.temperature, indexed=device_resident,
        )
    else:
        sampler = (make_indexed_sampler if device_resident else make_sampler)(
            cfg, step_mask=vocab.step_mask(), num_samples=args.num_samples,
            tau=args.temperature, with_logp=with_logp, top_k=args.top_k or 0,
            top_p=args.top_p,
        )
    if device_resident:
        t0 = time.perf_counter()
        feats_dev = device_put_features(ds.features, device, dtype)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_up = time.perf_counter() - t0

    # Dispatch batch i+1 before reading batch i back: the launches queue on
    # the device while the host assembles the previous batch's graphs.
    def dispatch(lo):
        idx = np.arange(lo, min(lo + B, n_images))
        if device_resident:
            pad_idx = (
                np.concatenate([idx, np.repeat(idx[-1:], B - len(idx))])
                if len(idx) < B else idx
            )
            return idx, sampler(g_params, feats_dev, pad_idx, generator)
        feats = batch_features(idx)
        if feats.shape[0] < B:  # pad to the batch shape with the last row
            feats = torch.cat([feats, feats[-1:].expand(B - feats.shape[0], -1, -1)])
        return idx, sampler(g_params, feats, generator)

    graphs, gen_triples, gt_triples = [], [], []
    n_sampled = 0
    starts = list(range(0, n_images, B))
    if device.type == "cuda":  # build and load the kernel outside the timing
        load_library()
    t0 = time.perf_counter()
    pending = dispatch(starts[0]) if starts else None
    for pos in range(len(starts)):
        idx, fut = pending
        pending = dispatch(starts[pos + 1]) if pos + 1 < len(starts) else None
        if with_logp:  # the sync point
            tokens, logp = (x.cpu().numpy() for x in fut)
            logp = logp[: len(idx)]
        else:
            tokens, logp = fut.cpu().numpy(), None  # [B, K, 3]
        gs, ids = assemble_scene_graphs(tokens[: len(idx)], vocab, idx, logp=logp,
                                        rank=args.rank)
        graphs.extend(gs)
        gen_triples.extend(ids)
        gt_triples.extend([tuple(map(int, t)) for t in ds.triples[i]] for i in idx)
        n_sampled += len(idx) * tokens.shape[1]
    dt = time.perf_counter() - t0

    out_path = args.out or os.path.join(args.workdir, "scene_graphs.json")
    with open(out_path, "w") as f:
        json.dump({"num_images": n_images, "scene_graphs": graphs}, f, indent=2)
    triples_per_sec = n_sampled / dt if dt > 0 else 0.0
    up = f" (+{t_up:.2f}s one-time feature upload)" if t_up else ""
    print(
        f"[sgg.generate] {n_images} images, {n_sampled} triples in {dt:.2f}s "
        f"({triples_per_sec:.0f} triples/sec, {n_images / dt if dt > 0 else 0.0:.1f} "
        f"images/sec){up} → {out_path}",
        flush=True,
    )
    if args.recall_k:
        r = corpus_recall(gen_triples, gt_triples, k=args.recall_k)
        print(f"[sgg.generate] recall@{args.recall_k} = {r:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
