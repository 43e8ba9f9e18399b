"""Feature-shard IO, a copy of ``sgg/data/shards.py``.

The layout is the reference's, so shards written by ``sgg.cli.preprocess``
load unchanged. Shards are ``.npz`` files with a simple, versioned schema:

  image_ids : int32[N]
  features  : float32|bfloat16 [N, R, F]   (R spatial regions, F channels)
  triples   : int32[T, 4]                  (image_index, subj, pred, obj)

Triples are stored in a flat ragged-to-dense encoding — row 0 is the index of
the owning image inside the shard — so the whole shard is two dense arrays
(no Python object arrays).
"""

from __future__ import annotations

import os
import re
from glob import glob

import numpy as np

SHARD_RE = re.compile(r"shard-(\d{5})-of-(\d{5})\.npz$")


def shard_name(index: int, total: int) -> str:
    return f"shard-{index:05d}-of-{total:05d}.npz"


def write_feature_shard(
    path: str,
    image_ids: np.ndarray,
    features: np.ndarray,
    triples_per_image: list[np.ndarray],
) -> None:
    """Write one shard. ``triples_per_image[i]`` is ``int32[n_i, 3]``."""
    if not len(image_ids) == features.shape[0] == len(triples_per_image):
        raise ValueError("image_ids, features and triples_per_image differ in length")
    flat = []
    for i, tr in enumerate(triples_per_image):
        tr = np.asarray(tr, dtype=np.int32).reshape(-1, 3)
        idx = np.full((tr.shape[0], 1), i, dtype=np.int32)
        flat.append(np.concatenate([idx, tr], axis=1))
    triples = (
        np.concatenate(flat, axis=0) if flat else np.zeros((0, 4), dtype=np.int32)
    )
    tmp = path + ".tmp"
    np.savez(
        tmp,
        image_ids=np.asarray(image_ids, dtype=np.int32),
        features=features,
        triples=triples,
        version=np.int32(1),
    )
    # np.savez appends .npz to the temp name.
    os.replace(tmp + ".npz", path)


def read_feature_shard(path: str) -> dict:
    with np.load(path) as z:
        return {
            "image_ids": z["image_ids"],
            "features": z["features"],
            "triples": z["triples"],
        }


def list_shards(directory: str) -> list[str]:
    paths = sorted(glob(os.path.join(directory, "shard-*-of-*.npz")))
    return [p for p in paths if SHARD_RE.search(p)]
