"""CLI plumbing shared by ``train`` and ``generate``, from
``sgg/cli/common.py``: the config arguments, the device, and dataset
loading."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sgg_torch.config import CONFIGS, Config, get_config
from sgg_torch.data import (
    ArrayImageTripleDataset,
    TripleDataset,
    Vocab,
    list_shards,
    synthetic_dataset,
)

LATER = "is not ported yet; a later slice of the port brings it"


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
    they exist; pixels-in configs get an image dataset."""
    d = cfg.data
    if cfg.model.encoder != "precomputed":
        return _load_image_dataset(cfg)
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


def _load_image_dataset(cfg: Config):
    """The ``synthetic`` image source of ``sgg.cli.common``: seeded uint8
    images [N, S, S, 3] beside the synthetic triples (no split)."""
    d = cfg.data
    if d.source != "synthetic":
        raise NotImplementedError(
            f"data.source {d.source!r} for encoder configs {LATER} (only synthetic)"
        )
    data = synthetic_dataset(
        num_images=d.num_synthetic_images, regions=1, feat_dim=1, seed=cfg.train.seed,
    )
    rng = np.random.RandomState(cfg.train.seed)
    images = rng.randint(
        0, 256, size=(d.num_synthetic_images, d.image_size, d.image_size, 3), dtype=np.uint8,
    )
    return ArrayImageTripleDataset(images=images, triples=data["triples"]), data["vocab"]
