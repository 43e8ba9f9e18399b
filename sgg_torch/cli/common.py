"""CLI plumbing shared by ``train`` and ``generate``, from
``sgg/cli/common.py``: the config arguments, the device, and dataset
loading (feature shards, synthetic data, and for pixels-in configs the
``synthetic`` and ``vg`` image sources)."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sgg_torch.config import CONFIGS, Config, get_config
from sgg_torch.data import (
    ArrayImageTripleDataset,
    ImageTripleDataset,
    TripleDataset,
    Vocab,
    build_vocab_from_relationships,
    filter_and_encode,
    list_shards,
    parse_relationships,
    synthetic_dataset,
    train_test_split,
)
from sgg_torch.data.extract import resolve_image_paths


def add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="smoke", choices=sorted(CONFIGS),
                   help="named config")
    p.add_argument("--config-file", default=None,
                   help="JSON config file (overrides --config)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.FIELD=VALUE",
                   help="config override, e.g. --set train.batch_size=64 (repeatable)")
    p.add_argument("--workdir", default=None, help="run directory")
    add_device_arg(p)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")


def resolve_config(args: argparse.Namespace) -> Config:
    if args.config_file:
        with open(args.config_file) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = get_config(args.config)
    if args.overrides:
        cfg = cfg.override(args.overrides)
    if args.workdir:
        cfg.workdir = args.workdir
    return cfg


def resolve_device(name) -> torch.device:
    """``cuda`` (the default) or ``cpu``, a name or a torch.device; raises
    for CUDA when there is none (never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu (device='cpu') to run on the CPU"
        )
    return device


def load_dataset(cfg: Config, split: str = "train"):
    """(dataset, vocab) from cfg.data.source, as ``sgg.cli.common.load_dataset``:
    ``split='test'`` reads the held-out shards under ``data_dir/test`` when
    they exist; pixels-in configs get an image dataset of that split."""
    d = cfg.data
    if cfg.model.encoder != "precomputed":
        return _load_image_dataset(cfg, split)
    if d.source == "shards" and split == "test":
        test_dir = os.path.join(d.data_dir, "test")
        if list_shards(test_dir):
            vocab_path = d.vocab_path or os.path.join(d.data_dir, "vocab.json")
            return TripleDataset.from_shards(list_shards(test_dir)), Vocab.load(vocab_path)
    if d.source == "synthetic":
        data = synthetic_dataset(
            num_images=d.num_synthetic_images, regions=d.regions,
            feat_dim=d.feat_dim, seed=cfg.train.seed,
        )
        return TripleDataset(features=data["features"], triples=data["triples"]), data["vocab"]
    if d.source == "shards":
        if not d.data_dir:
            raise ValueError("data.source=shards requires data.data_dir")
        shards = list_shards(d.data_dir)
        if not shards:
            raise FileNotFoundError(f"no feature shards in {d.data_dir}")
        vocab_path = d.vocab_path or os.path.join(d.data_dir, "vocab.json")
        return TripleDataset.from_shards(shards), Vocab.load(vocab_path)
    raise ValueError(f"unsupported data.source {d.source!r} (synthetic or shards)")


def _load_image_dataset(cfg: Config, split: str = "train"):
    """Datasets for the pixels-in configs, ``sgg.cli.common``'s
    (``sgg/cli/common.py:153-221``). ``synthetic``: seeded uint8 images
    [N, S, S, 3] beside the synthetic triples, with no split. ``vg``:
    ``data_dir/relationships.json`` parsed and encoded with
    ``data.vocab_path`` or a vocab built at ``min_count=2``, split by image
    id as preprocess splits it (``train_test_split`` seeded by
    ``data.split_seed``, which must equal preprocess's ``--seed``), cut to
    ``data.max_images`` by a permutation seeded by the same, and paired with
    ``data_dir/images/<id>.jpg``: a path-backed ``ImageTripleDataset``."""
    d = cfg.data
    if d.source == "synthetic":
        data = synthetic_dataset(
            num_images=d.num_synthetic_images, regions=1, feat_dim=1, seed=cfg.train.seed,
        )
        rng = np.random.RandomState(cfg.train.seed)
        images = rng.randint(
            0, 256, size=(d.num_synthetic_images, d.image_size, d.image_size, 3),
            dtype=np.uint8,
        )
        return ArrayImageTripleDataset(images=images, triples=data["triples"]), data["vocab"]
    if d.source == "vg":
        if not d.data_dir:
            raise ValueError("data.source=vg requires data.data_dir")
        images = parse_relationships(os.path.join(d.data_dir, "relationships.json"))
        if d.vocab_path:
            vocab = Vocab.load(d.vocab_path)
        else:
            vocab = build_vocab_from_relationships(images, min_count=2)
        ids, enc = filter_and_encode(images, vocab,
                                     max_triples_per_image=d.max_triples_per_image)
        train_ids, test_ids = train_test_split(ids, d.test_fraction, seed=d.split_seed)
        keep = set(test_ids if split == "test" else train_ids)
        sel = [j for j, i in enumerate(ids) if i in keep]
        if d.max_images and len(sel) > d.max_images:
            # Shuffled by split_seed, so the cap does not favour the file order.
            pick = np.random.RandomState(d.split_seed).permutation(len(sel))[: d.max_images]
            sel = [sel[j] for j in sorted(pick)]
        paths = resolve_image_paths([ids[j] for j in sel], os.path.join(d.data_dir, "images"))
        return (ImageTripleDataset(paths=paths, triples=[enc[j] for j in sel],
                                   image_size=d.image_size), vocab)
    raise ValueError(f"unsupported data.source {d.source!r} for encoder configs "
                     "(synthetic or vg)")
