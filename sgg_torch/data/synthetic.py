"""Synthetic Visual-Genome-like data, the ``synthetic`` data source.

``synthetic_dataset`` and ``synthetic_vg_json`` of ``sgg/data/synthetic.py``
are ported. ``synthetic_dataset`` draws features around per-token centroids,
so the data has structure a model can learn; ``synthetic_vg_json`` makes a
VG-shaped ``relationships.json`` object (no images) for ``preprocess``. Same
seed, same arrays and the same JSON as the reference.
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


def synthetic_vg_json(
    num_images: int = 5,
    seed: int = 0,
    max_rels: int = 6,
    vocab_objects: int | None = None,
    vocab_predicates: int | None = None,
) -> list[dict]:
    """A relationships.json-shaped object (the schema of ``sgg_torch.data.vg``).

    With ``vocab_objects``/``vocab_predicates`` set beyond the base lists,
    synthesizes extra token names (``obj_017``…) drawn Zipf-style so the
    frequency-cut vocab build sees a realistic long tail."""
    rng = np.random.RandomState(seed)
    objs = list(_OBJECTS)
    preds = list(_PREDICATES)
    if vocab_objects is not None and vocab_objects > len(objs):
        objs += [f"obj_{i:03d}" for i in range(len(objs), vocab_objects)]
    if vocab_predicates is not None and vocab_predicates > len(preds):
        preds += [f"rel_{i:02d}" for i in range(len(preds), vocab_predicates)]

    def zipf(n, size):
        w = 1.0 / np.arange(1, n + 1)
        return rng.choice(n, size=size, p=w / w.sum())

    out = []
    for i in range(num_images):
        n_r = int(rng.randint(1, max_rels + 1))
        ss, oo = zipf(len(objs), n_r), zipf(len(objs), n_r)
        pp = zipf(len(preds), n_r)
        rels = []
        for s, p, o in zip(ss, pp, oo):
            if s == o:
                o = (o + 1) % len(objs)
            rels.append(
                {
                    "predicate": preds[p].upper(),  # exercise normalization
                    "subject": {"names": [objs[s]]},
                    "object": {"name": objs[o]},
                }
            )
        out.append({"image_id": 1000 + i, "relationships": rels})
    return out


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
