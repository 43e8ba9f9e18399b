"""Visual Genome filtering, vocab build and feature shards, from
``sgg/cli/preprocess.py``.

Parse ``relationships.json``, build the vocabulary, keep and encode the images
with usable triples, split them, and write feature + triple shards:

  out_dir/vocab.json
  out_dir/shard-00000-of-000NN.npz   (train split)
  out_dir/test/shard-*.npz           (held-out split)

  python -m sgg_torch.cli.preprocess --out-dir D --synthetic 64
  python -m sgg_torch.cli.preprocess --out-dir D --vg-dir VG --encoder random \\
      --max-objects 150 --max-predicates 50 --feat-dtype float16
  python -m sgg_torch.cli.preprocess --out-dir D --vg-dir VG --image-dir VG/images \\
      --encoder vgg19 --vgg-weights vgg19.npy [--compute-dtype bfloat16] [--device cpu]

Modes: ``--synthetic N``, a synthetic dataset (no VG needed); ``--vg-dir DIR``,
VG's JSON, with the features from ``--encoder``: ``random`` draws seeded
features (the reference's own values), which trains the pipeline without
images, on the host; ``vgg19`` runs an encoder over the JPEGs of
``--image-dir`` (``<image_id>.jpg``), streaming them through
``sgg_torch.data.extract.extract_to_shards`` (the native loader's threads
decode the next batch while the device encodes this one). Its weights come
from ``--vgg-weights`` (a ``.npy`` dict), from ``--encoder-ckpt`` (an
``encoder_params.npz``, or a directory holding one and a
``pretrain_meta.json``, whose ``encoder``, ``image_size``, ``vit_dims``,
``moe_experts`` and ``moe_top_k`` it takes, as ``sgg_torch.cli.pretrain``
writes them), or are seeded. The encoder runs on the CUDA kernels unless
``--device cpu`` is given, in ``--compute-dtype`` (float32, the reference's;
bfloat16 is the port's option). ``vocab.json`` is written last, so that it
marks a finished output directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from sgg_torch.cli.common import add_device_arg
from sgg_torch.data import (
    build_vocab_from_relationships,
    filter_and_encode,
    parse_relationships,
    synthetic_dataset,
    train_test_split,
    write_feature_shard,
)
from sgg_torch.data.shards import shard_name

RANDOM_CHUNK = 256  # images of random features drawn at a time


def _write_split(out_dir, image_ids, feats, triples, shard_size) -> int:
    os.makedirs(out_dir, exist_ok=True)
    n = len(image_ids)
    total = max(1, -(-n // shard_size))
    for s in range(total):
        lo, hi = s * shard_size, min((s + 1) * shard_size, n)
        write_feature_shard(os.path.join(out_dir, shard_name(s, total)),
                            np.asarray(image_ids[lo:hi], np.int32), feats[lo:hi],
                            triples[lo:hi])
    return total


def random_features(n: int, regions: int, feat_dim: int, dtype, seed: int) -> np.ndarray:
    """``RandomState(seed).randn(n, regions, feat_dim).astype(dtype)``, drawn
    a chunk of images at a time (the same stream) so that the float64 draw
    never holds the whole store."""
    rng = np.random.RandomState(seed)
    feats = np.empty((n, regions, feat_dim), dtype)
    for lo in range(0, n, RANDOM_CHUNK):
        hi = min(lo + RANDOM_CHUNK, n)
        feats[lo:hi] = rng.randn(hi - lo, regions, feat_dim).astype(dtype)
    return feats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="generate N synthetic images instead of reading VG")
    p.add_argument("--vg-dir", default=None, help="directory with relationships.json")
    p.add_argument("--encoder", default="vgg19", choices=["vgg19", "random"],
                   help="random: seeded features; vgg19: an encoder over the JPEGs")
    p.add_argument("--image-dir", default=None, help="directory with VG JPEGs (vgg19)")
    p.add_argument("--vgg-weights", default=None, help=".npy weight dict for VGG-19 (vgg19)")
    p.add_argument("--encoder-ckpt", default=None, help="encoder weights (vgg19)")
    p.add_argument("--batch-size", type=int, default=32, help="encoder batch (vgg19)")
    p.add_argument("--max-objects", type=int, default=None)
    p.add_argument("--max-predicates", type=int, default=None)
    p.add_argument("--min-count", type=int, default=2)
    p.add_argument("--min-triples", type=int, default=1)
    p.add_argument("--max-triples-per-image", type=int, default=32)
    p.add_argument("--max-images", type=int, default=None,
                   help="subsample the kept images before the split (deterministic by --seed)")
    p.add_argument("--test-fraction", type=float, default=0.1)
    p.add_argument("--shard-size", type=int, default=1024)
    p.add_argument("--regions", type=int, default=196)
    p.add_argument("--feat-dim", type=int, default=512)
    p.add_argument("--feat-dtype", default="float32", choices=["float32", "float16"],
                   help="shard feature dtype (float16 halves storage and transfer)")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the encoder's compute dtype (vgg19)")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    args = p.parse_args(argv)
    say = lambda m: print(f"[sgg.preprocess] {m}", flush=True)  # noqa: E731

    if args.synthetic is None and not args.vg_dir:
        p.error("either --synthetic N or --vg-dir is required")
    os.makedirs(args.out_dir, exist_ok=True)

    if args.synthetic is not None:
        n = args.synthetic
        data = synthetic_dataset(num_images=n, regions=args.regions, feat_dim=args.feat_dim,
                                 seed=args.seed, dtype=args.feat_dtype)
        vocab, ids = data["vocab"], list(range(n))
        n_test = int(round(n * args.test_fraction))
        tr, te = slice(0, n - n_test), slice(n - n_test, n)
        n_shards = _write_split(args.out_dir, ids[tr], data["features"][tr],
                                list(data["triples"][tr]), args.shard_size)
        if n_test:
            _write_split(os.path.join(args.out_dir, "test"), ids[te], data["features"][te],
                         list(data["triples"][te]), args.shard_size)
        vocab.save(os.path.join(args.out_dir, "vocab.json"))
        say(f"synthetic: {n} images, vocab={len(vocab)}, {n_shards} train shard(s) -> "
            f"{args.out_dir}")
        return 0

    rel_path = os.path.join(args.vg_dir, "relationships.json")
    if not os.path.exists(rel_path):
        print(f"[sgg.preprocess] missing {rel_path}", file=sys.stderr)
        return 1
    say(f"parsing {rel_path} ...")
    images = parse_relationships(rel_path)
    vocab = build_vocab_from_relationships(images, max_objects=args.max_objects,
                                           max_predicates=args.max_predicates,
                                           min_count=args.min_count)
    ids, enc = filter_and_encode(images, vocab, min_triples=args.min_triples,
                                 max_triples_per_image=args.max_triples_per_image)
    say(f"kept {len(ids)}/{len(images)} images, vocab={len(vocab)}")
    if args.max_images is not None and len(ids) > args.max_images:
        # After the vocab build (the vocab reflects the whole corpus), before
        # the split (train and test stay disjoint within the subset).
        keep = sorted(np.random.RandomState(args.seed).choice(len(ids), size=args.max_images,
                                                              replace=False))
        ids, enc = [ids[i] for i in keep], [enc[i] for i in keep]
        say(f"subsampled to {len(ids)} images")

    train_ids, test_ids = train_test_split(ids, args.test_fraction, args.seed)
    pos = {im: i for i, im in enumerate(ids)}
    tr_idx, te_idx = [pos[i] for i in train_ids], [pos[i] for i in test_ids]
    if args.encoder == "random":
        feats = random_features(len(ids), args.regions, args.feat_dim, args.feat_dtype,
                                args.seed)
        n_shards = _write_split(args.out_dir, train_ids, feats[tr_idx],
                                [enc[i] for i in tr_idx], args.shard_size)
        if te_idx:
            _write_split(os.path.join(args.out_dir, "test"), test_ids, feats[te_idx],
                         [enc[i] for i in te_idx], args.shard_size)
        vocab.save(os.path.join(args.out_dir, "vocab.json"))
        say(f"wrote {n_shards} train shard(s), {len(test_ids)} test images -> {args.out_dir}")
        return 0

    if not args.image_dir:
        print("[sgg.preprocess] --encoder vgg19 requires --image-dir "
              "(use --encoder random for a pipeline smoke)", file=sys.stderr)
        return 1
    enc_name, image_size, vit_dims, moe, params = _encoder_weights(args, say)
    import torch

    from sgg_torch.data.extract import extract_to_shards, resolve_image_paths

    for split_name, split_ids, split_idx in (("train", train_ids, tr_idx),
                                            ("test", test_ids, te_idx)):
        if not split_ids:
            continue
        out = args.out_dir if split_name == "train" else os.path.join(args.out_dir, "test")
        stats = extract_to_shards(
            enc_name, split_ids, resolve_image_paths(split_ids, args.image_dir),
            [enc[i] for i in split_idx], out, shard_size=args.shard_size,
            encoder_params=params, batch_size=args.batch_size, image_size=image_size,
            dtype=getattr(torch, args.compute_dtype), feat_dtype=np.dtype(args.feat_dtype),
            seed=args.seed, vit_dims=vit_dims, moe_experts=moe[0], moe_top_k=moe[1],
            device=args.device)
        say(f"{split_name}: {stats}")
    vocab.save(os.path.join(args.out_dir, "vocab.json"))
    return 0


def _encoder_weights(args, say):
    """(encoder, image size, vit_dims, (moe_experts, moe_top_k), port
    state_dict or None) from ``--vgg-weights`` or ``--encoder-ckpt`` (a
    pretrain directory's ``pretrain_meta.json`` names the encoder, its size,
    its ViT widths and MoE layers); None draws seeded weights."""
    enc_name, image_size, vit_dims, moe = "vgg19", 224, (768, 12, 12), (0, 2)
    if args.vgg_weights:
        from sgg_torch.models.vgg import load_npy_weights

        return enc_name, image_size, vit_dims, moe, load_npy_weights(args.vgg_weights)
    if not args.encoder_ckpt:
        return enc_name, image_size, vit_dims, moe, None
    from sgg_torch.convert_flax import encoder_flax_to_state_dict, load_params_npz

    ckpt = args.encoder_ckpt
    if os.path.isdir(ckpt):
        meta_path = os.path.join(ckpt, "pretrain_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            enc_name = meta.get("encoder", enc_name)
            image_size = int(meta.get("image_size", image_size))
            vit_dims = tuple(meta.get("vit_dims", vit_dims))
            moe = (int(meta.get("moe_experts", moe[0])), int(meta.get("moe_top_k", moe[1])))
        ckpt = os.path.join(ckpt, "encoder_params.npz")
    params = encoder_flax_to_state_dict(load_params_npz(ckpt))
    say(f"encoder weights <- {ckpt} ({enc_name} @ {image_size}px)")
    return enc_name, image_size, vit_dims, moe, params


if __name__ == "__main__":
    sys.exit(main())
