"""Visual Genome JSON parsing, filtering and triple encoding.

A copy of ``sgg/data/vg.py`` (framework-free), kept in the port so that
``sgg_torch`` imports nothing of ``sgg``: parse ``relationships.json``, keep
images with usable (subject, predicate, object) relationships, build the
vocabulary, and encode each image's relationships as integer triples with a
train/test split.

VG ``relationships.json`` shape (public schema):
    [
      {"image_id": 1,
       "relationships": [
          {"predicate": "ON",
           "subject": {"names": ["clock"], ...} | {"name": "clock", ...},
           "object":  {"names": ["tower"], ...}},
          ...]},
      ...
    ]
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from sgg_torch.data.vocab import Vocab, normalize_name


def _entity_name(ent: dict) -> str | None:
    """Extract the canonical name of a VG subject/object dict."""
    if "names" in ent and ent["names"]:
        return normalize_name(str(ent["names"][0]))
    if "name" in ent and ent["name"]:
        return normalize_name(str(ent["name"]))
    return None


@dataclass
class ImageTriples:
    image_id: int
    triples: list[tuple[str, str, str]]  # string triples, normalized


def parse_relationships(path_or_obj) -> list[ImageTriples]:
    """Parse relationships.json (path, file object, or already-loaded list)."""
    if isinstance(path_or_obj, str):
        with open(path_or_obj) as f:
            data = json.load(f)
    elif hasattr(path_or_obj, "read"):
        data = json.load(path_or_obj)
    else:
        data = path_or_obj

    out: list[ImageTriples] = []
    for entry in data:
        image_id = int(entry.get("image_id", entry.get("id", -1)))
        triples: list[tuple[str, str, str]] = []
        for rel in entry.get("relationships", []):
            pred = rel.get("predicate")
            if not pred:
                continue
            pred = normalize_name(str(pred))
            subj = _entity_name(rel.get("subject", {}))
            obj = _entity_name(rel.get("object", {}))
            if not (subj and pred and obj):
                continue
            triples.append((subj, pred, obj))
        out.append(ImageTriples(image_id=image_id, triples=triples))
    return out


def parse_entity_boxes(path_or_obj) -> dict[int, list[tuple[str, tuple]]]:
    """image_id → deduped [(name, (x, y, w, h)), ...] for entities that carry
    VG box fields.

    Real VG records subject/object boxes; images whose entities have no box
    fields map to an empty list. Names are normalized exactly as in
    :func:`parse_relationships`, so vocab ids line up.
    """
    if isinstance(path_or_obj, str):
        with open(path_or_obj) as f:
            data = json.load(f)
    elif hasattr(path_or_obj, "read"):
        data = json.load(path_or_obj)
    else:
        data = path_or_obj

    def box_of(ent: dict) -> tuple | None:
        if all(k in ent for k in ("x", "y", "w", "h")):
            return (int(ent["x"]), int(ent["y"]), int(ent["w"]), int(ent["h"]))
        return None

    out: dict[int, list[tuple[str, tuple]]] = {}
    for entry in data:
        image_id = int(entry.get("image_id", entry.get("id", -1)))
        seen: set = set()
        ents: list[tuple[str, tuple]] = []
        for rel in entry.get("relationships", []):
            for side in ("subject", "object"):
                ent = rel.get(side, {})
                name = _entity_name(ent)
                box = box_of(ent)
                if name is None or box is None:
                    continue
                key = (name, box)
                if key not in seen:
                    seen.add(key)
                    ents.append(key)
        out[image_id] = ents
    return out


def build_vocab_from_relationships(
    images: Iterable[ImageTriples],
    max_objects: int | None = None,
    max_predicates: int | None = None,
    min_count: int = 1,
) -> Vocab:
    obj_counts: Counter = Counter()
    pred_counts: Counter = Counter()
    for im in images:
        for s, p, o in im.triples:
            obj_counts[s] += 1
            obj_counts[o] += 1
            pred_counts[p] += 1
    return Vocab.build(
        obj_counts,
        pred_counts,
        max_objects=max_objects,
        max_predicates=max_predicates,
        min_count=min_count,
    )


def filter_and_encode(
    images: Iterable[ImageTriples],
    vocab: Vocab,
    min_triples: int = 1,
    max_triples_per_image: int | None = None,
    drop_unk: bool = True,
) -> tuple[list[int], list[np.ndarray]]:
    """Keep images with >= min_triples in-vocab relationships; encode to int32.

    Returns (image_ids, per-image ``int32[n_i, 3]`` arrays). With
    ``drop_unk=True`` (default), triples with any out-of-vocab token are
    dropped — matching a frequency-cut reference pipeline where rare tokens
    simply never appear in training triples.
    """
    ids_out: list[int] = []
    enc_out: list[np.ndarray] = []
    for im in images:
        enc = []
        for s, p, o in im.triples:
            t = vocab.encode_triple(s, p, o)
            if drop_unk and vocab.unk_id in t:
                continue
            enc.append(t)
        if max_triples_per_image is not None:
            enc = enc[:max_triples_per_image]
        if len(enc) >= min_triples:
            ids_out.append(im.image_id)
            enc_out.append(np.asarray(enc, dtype=np.int32))
    return ids_out, enc_out


def train_test_split(
    image_ids: list[int], test_fraction: float = 0.1, seed: int = 0
) -> tuple[list[int], list[int]]:
    """Deterministic split on shuffled image ids."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(image_ids))
    n_test = int(round(len(image_ids) * test_fraction))
    test_idx = set(order[:n_test].tolist())
    train = [image_ids[i] for i in range(len(image_ids)) if i not in test_idx]
    test = [image_ids[i] for i in range(len(image_ids)) if i in test_idx]
    return train, test
