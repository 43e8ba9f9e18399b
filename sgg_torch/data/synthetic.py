"""Synthetic Visual-Genome-like data, the ``synthetic`` data source.

Only ``synthetic_dataset`` of ``sgg/data/synthetic.py`` is ported: features
are drawn around per-token centroids, so the data has structure a model can
learn. Same seed, same arrays as the reference.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from sgg_torch.data.vocab import Vocab

_OBJECTS = [
    "man", "woman", "dog", "cat", "car", "tree", "building", "sign",
    "table", "chair", "horse", "bus", "window", "shirt", "hat", "plate",
]
_PREDICATES = ["on", "has", "wearing", "behind", "in front of", "near", "riding", "holding"]


def synthetic_dataset(
    num_images: int = 64,
    regions: int = 196,
    feat_dim: int = 512,
    vocab_objects: int = 16,
    vocab_predicates: int = 8,
    triples_per_image: int = 4,
    seed: int = 0,
    dtype=np.float32,
):
    """Dense synthetic (features, triples) arrays + matching Vocab.

    Returns dict with:
      features : dtype[num_images, regions, feat_dim]
      triples  : int32[num_images, triples_per_image, 3]
      vocab    : Vocab
    """
    objs = _OBJECTS[:vocab_objects]
    preds = _PREDICATES[:vocab_predicates]
    vocab = Vocab.build(
        Counter({o: 100 - i for i, o in enumerate(objs)}),
        Counter({p: 100 - i for i, p in enumerate(preds)}),
    )

    rng = np.random.RandomState(seed)
    obj_ids = np.array([vocab.id(o) for o in objs], dtype=np.int32)
    pred_ids = np.array([vocab.id(p) for p in preds], dtype=np.int32)

    # Each token gets a centroid direction in feature space; an image's
    # features mix the centroids of the tokens appearing in its triples.
    centroids = rng.randn(len(vocab), feat_dim).astype(np.float32)

    feats = np.zeros((num_images, regions, feat_dim), dtype=np.float32)
    triples = np.zeros((num_images, triples_per_image, 3), dtype=np.int32)
    for i in range(num_images):
        s = obj_ids[rng.randint(len(obj_ids), size=triples_per_image)]
        p = pred_ids[rng.randint(len(pred_ids), size=triples_per_image)]
        o = obj_ids[rng.randint(len(obj_ids), size=triples_per_image)]
        triples[i, :, 0], triples[i, :, 1], triples[i, :, 2] = s, p, o
        toks = np.concatenate([s, p, o])
        base = centroids[toks].mean(axis=0)
        feats[i] = base[None, :] + 0.5 * rng.randn(regions, feat_dim)
    return {
        "features": feats.astype(dtype),
        "triples": triples,
        "vocab": vocab,
    }
