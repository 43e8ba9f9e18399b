"""Recall@k over generated scene-graph triples, a copy of the first part of
``sgg/eval/recall.py``: for each image, the fraction of ground-truth
(subject, predicate, object) triples recovered among the top-k generated
ones, macro-averaged over images.
"""

from __future__ import annotations

import numpy as np


def recall_at_k(
    generated: list[tuple[int, int, int]] | np.ndarray,
    ground_truth: list[tuple[int, int, int]] | np.ndarray,
    k: int = 50,
) -> float:
    """Per-image recall@k. ``generated`` must be ordered by confidence.

    Duplicate generated triples are collapsed (first occurrence keeps the
    rank) before the top-k cut, so a caller passing raw samples gets the
    same answer as one that pre-dedupes.
    """
    gt = {tuple(int(x) for x in t) for t in np.asarray(ground_truth).reshape(-1, 3)}
    if not gt:
        return 0.0
    seen: set = set()
    top: list = []
    for t in np.asarray(generated).reshape(-1, 3):
        tt = tuple(int(x) for x in t)
        if tt not in seen:
            seen.add(tt)
            top.append(tt)
            if len(top) == k:
                break
    return len(gt & set(top)) / len(gt)


def corpus_recall(
    per_image_generated: list, per_image_gt: list, k: int = 50
) -> float:
    """Macro-average of recall@k over a corpus of images."""
    if not per_image_gt:
        return 0.0
    vals = [
        recall_at_k(g, t, k) for g, t in zip(per_image_generated, per_image_gt)
    ]
    return float(np.mean(vals))
