"""Synthetic Visual-Genome-like data, from ``sgg/data/synthetic.py``.

``synthetic_dataset`` draws features around per-token centroids, so the data
has structure a model can learn (the ``synthetic`` data source);
``synthetic_vg_json`` makes a VG-shaped ``relationships.json`` object (no
images) for ``preprocess``. ``write_synthetic_vg_corpus`` writes a corpus of
JPEGs and its ``relationships.json``: plain (one colored rectangle per
relationship entity, colors keyed to token names) or ``grounded``, where
every predicate is :func:`spatial_predicate` of the rendered boxes and the
JSON carries VG-style boxes, so the image→triple mapping is pixel-learnable
(the corpus ``sgg_torch.cli.pretrain`` trains an encoder on). Host numpy
with ``np.random.RandomState``, the same draws in the same order: same seed,
same arrays, the same images before JPEG coding and the same JSON as the
reference. The JPEGs are coded by the port's native library
(``sgg_torch.native.encode_file``: libjpeg, or nvJPEG's encoder where
libjpeg's headers are missing), not PIL.
"""

from __future__ import annotations

import functools
import json
import os
import time
import zlib
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


def _token_color(token_id: int) -> tuple[int, int, int]:
    """Deterministic bright-ish RGB per token id."""
    r = (token_id * 97 + 31) % 200 + 40
    g = (token_id * 57 + 83) % 200 + 40
    b = (token_id * 163 + 7) % 200 + 40
    return int(r), int(g), int(b)


def _name_color(name: str) -> tuple[int, int, int]:
    """CRC-keyed color (few collisions across a 200-name vocabulary: object
    identity must be recoverable from the pixels)."""
    return _token_color(zlib.crc32(name.encode()) & 0xFFFF)


# Grounded-mode predicates: each a deterministic function of the subject and
# object rectangles.
GROUNDED_PREDICATES = (
    "on", "under", "left of", "right of", "inside", "around", "near",
    "far from",
)


def spatial_predicate(bs: tuple, bo: tuple) -> str:
    """(x, y, w, h) boxes → grounded predicate name: containment, then
    overlap (above/below), then the disjoint direction by the dominant
    center offset, then near/far by center distance."""
    xs, ys, ws, hs = bs
    xo, yo, wo, ho = bo
    cxs, cys = xs + ws / 2, ys + hs / 2
    cxo, cyo = xo + wo / 2, yo + ho / 2
    ix = max(0, min(xs + ws, xo + wo) - max(xs, xo))
    iy = max(0, min(ys + hs, yo + ho) - max(ys, yo))
    inter = ix * iy
    if inter >= 0.9 * ws * hs:
        return "inside"
    if inter >= 0.9 * wo * ho:
        return "around"
    if inter > 0.25 * min(ws * hs, wo * ho):
        return "on" if cys <= cyo else "under"
    dx, dy = cxo - cxs, cyo - cys
    dist = (dx * dx + dy * dy) ** 0.5
    diag = ((ws + wo) ** 2 + (hs + ho) ** 2) ** 0.5 / 2
    if abs(dx) > abs(dy):
        if dist < 1.2 * diag:
            return "left of" if dx > 0 else "right of"
    else:
        if dist < 1.2 * diag:
            return "near"
    return "near" if dist < 1.8 * diag else "far from"


def grounded_vg_entry(image_id: int, rng, objs: list[str], width: int = 500,
                      height: int = 375, max_entities: int = 7, max_rels: int = 12
                      ) -> tuple[dict, list[tuple[str, tuple]]]:
    """One VG-schema entry whose predicates are :func:`spatial_predicate` of
    its boxes → (entry, [(name, (x, y, w, h)), ...] for the renderer)."""

    def zipf(n, size):
        w = 1.0 / np.arange(1, n + 1)
        return rng.choice(n, size=size, p=w / w.sum())

    n_ent = int(rng.randint(3, max_entities + 1))
    ids = zipf(len(objs), n_ent)
    ents = []
    for e in ids:
        w = int(rng.randint(width // 10, width // 3))
        h = int(rng.randint(height // 10, height // 3))
        x = int(rng.randint(0, width - w))
        y = int(rng.randint(0, height - h))
        ents.append((objs[int(e)], (x, y, w, h)))

    pairs = [(i, j) for i in range(n_ent) for j in range(n_ent) if i != j]
    rng.shuffle(pairs)
    rels = []
    for i, j in pairs[: int(rng.randint(2, max_rels + 1))]:
        (sn, sb), (on, ob) = ents[i], ents[j]
        rels.append({
            "predicate": spatial_predicate(sb, ob),
            "subject": {"names": [sn], "x": sb[0], "y": sb[1], "w": sb[2], "h": sb[3]},
            "object": {"name": on, "x": ob[0], "y": ob[1], "w": ob[2], "h": ob[3]},
        })
    return {"image_id": image_id, "relationships": rels}, ents


@functools.lru_cache(maxsize=4)
def _gradient(width: int, height: int) -> np.ndarray:
    img = np.full((height, width, 3), 96, dtype=np.int16)
    gy = np.linspace(-30, 30, height, dtype=np.float32)[:, None]
    gx = np.linspace(-30, 30, width, dtype=np.float32)[None, :]
    img += (gy + gx).astype(np.int16)[:, :, None]
    img.flags.writeable = False
    return img


def _background(width: int, height: int) -> np.ndarray:
    """int16 [H, W, 3]: 96 plus a smooth diagonal gradient (a fresh copy)."""
    return _gradient(width, height).copy()


def _with_noise(img: np.ndarray, rng) -> np.ndarray:
    img = img + rng.randint(-12, 13, size=img.shape).astype(np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def render_grounded_image(ents: list[tuple[str, tuple]], rng, width: int = 500,
                          height: int = 375) -> np.ndarray:
    """uint8 [H, W, 3]: the entity boxes the relationships were derived from,
    larger boxes first, so smaller ('inside'/'on') ones stay visible."""
    img = _background(width, height)
    for name, (x, y, w, h) in sorted(ents, key=lambda e: -(e[1][2] * e[1][3])):
        img[y: y + h, x: x + w] = np.asarray(_name_color(name), np.int16)
    return _with_noise(img, rng)


def render_synthetic_image(rels: list[dict], rng, width: int = 500, height: int = 375
                           ) -> np.ndarray:
    """uint8 [H, W, 3]: one colored rectangle per relationship entity (colors
    keyed to token names), plus mild noise."""
    img = _background(width, height)
    names = []
    for rel in rels:
        sub = rel["subject"].get("names", [rel["subject"].get("name", "")])[0]
        obj = rel["object"].get("names", [rel["object"].get("name", "")])[0]
        names.extend([sub, obj])
    for name in names:
        tid = sum(ord(c) for c in name)
        w = int(rng.randint(width // 8, width // 3))
        h = int(rng.randint(height // 8, height // 3))
        x = int(rng.randint(0, width - w))
        y = int(rng.randint(0, height - h))
        img[y: y + h, x: x + w] = np.asarray(_token_color(tid), np.int16)
    return _with_noise(img, rng)


def write_synthetic_vg_corpus(out_dir: str, num_images: int, seed: int = 0,
                              max_rels: int = 12, vocab_objects: int | None = 200,
                              vocab_predicates: int | None = 60, width: int = 500,
                              height: int = 375, jpeg_quality: int = 75,
                              log_every: int = 5000, grounded: bool = False) -> dict:
    """A VG-shaped corpus on disk: ``relationships.json`` and
    ``images/<image_id>.jpg`` (``grounded``: predicates from the rendered
    geometry, boxes in the JSON).

    Returns ``{"num_images", "num_rels", "image_dir", "json", "seconds"}``."""
    from sgg_torch import native

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed + 1)
    if grounded:
        objs = list(_OBJECTS)
        if vocab_objects is not None and vocab_objects > len(objs):
            objs += [f"obj_{i:03d}" for i in range(len(objs), vocab_objects)]
        ent_rng = np.random.RandomState(seed)
        entries, boxes = [], []
        for i in range(num_images):
            entry, ents = grounded_vg_entry(1000 + i, ent_rng, objs, width=width,
                                            height=height, max_rels=max_rels)
            entries.append(entry)
            boxes.append(ents)
    else:
        entries = synthetic_vg_json(num_images, seed=seed, max_rels=max_rels,
                                    vocab_objects=vocab_objects,
                                    vocab_predicates=vocab_predicates)
        boxes = None
    t0 = time.time()
    for i, entry in enumerate(entries):
        if grounded:
            arr = render_grounded_image(boxes[i], rng, width=width, height=height)
        else:
            arr = render_synthetic_image(entry["relationships"], rng, width=width,
                                         height=height)
        path = os.path.join(img_dir, f"{entry['image_id']}.jpg")
        native.encode_file(path, arr, quality=jpeg_quality)
        if log_every and (i + 1) % log_every == 0:
            rate = (i + 1) / (time.time() - t0)
            print(f"[synthetic-corpus] {i + 1}/{num_images} images ({rate:.0f}/s)", flush=True)
    json_path = os.path.join(out_dir, "relationships.json")
    with open(json_path, "w") as f:
        json.dump(entries, f)
    n_rels = sum(len(e["relationships"]) for e in entries)
    return {"num_images": num_images, "num_rels": n_rels, "image_dir": img_dir,
            "json": json_path, "seconds": round(time.time() - t0, 1)}
