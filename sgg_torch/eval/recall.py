"""Recall metrics over generated scene-graph triples, a copy of
``sgg/eval/recall.py``: recall@k (for each image, the fraction of ground-truth
(subject, predicate, object) triples among the top-k generated ones,
macro-averaged over images) at one or several cutoffs, with percentile
bootstrap intervals over images; zero-shot recall (ground truth never seen in
training); predicate-balanced mean recall (mR@k); and PredCls recall.
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


def _dedup_top(generated, k: int) -> list[tuple[int, int, int]]:
    """First-occurrence dedupe, cut to the top ``k`` (rank = confidence)."""
    seen: set = set()
    top: list = []
    for t in np.asarray(generated).reshape(-1, 3):
        tt = (int(t[0]), int(t[1]), int(t[2]))
        if tt not in seen:
            seen.add(tt)
            top.append(tt)
            if len(top) == k:
                break
    return top


def corpus_recall_multi(
    per_image_generated: list, per_image_gt: list, ks: list[int]
) -> dict[int, float]:
    """Macro recall at several cutoffs in ONE pass over the samples.

    Sampling dominates evaluation wall-clock, so reporting recall@{20,50,100}
    must not mean sampling three times — each image's deduped ranking is
    computed once at max(ks) and cut at every k.
    """
    if not per_image_gt or not ks:
        return {k: 0.0 for k in ks}
    kmax = max(ks)
    sums = {k: 0.0 for k in ks}
    for gen, gt_list in zip(per_image_generated, per_image_gt):
        gt = {tuple(int(x) for x in t)
              for t in np.asarray(gt_list).reshape(-1, 3)}
        if not gt:
            continue
        top = _dedup_top(gen, kmax)
        hit_rank = [t in gt for t in top]
        cum = np.cumsum(hit_rank) if top else np.zeros(0)
        for k in ks:
            hits = int(cum[min(k, len(cum)) - 1]) if len(cum) else 0
            sums[k] += hits / len(gt)
    n = len(per_image_gt)
    return {k: sums[k] / n for k in ks}


def corpus_recall_bootstrap(
    per_image_generated: list, per_image_gt: list, ks: list[int],
    n_boot: int = 1000, seed: int = 0, alpha: float = 0.05,
) -> dict[int, tuple[float, float, float]]:
    """Percentile-bootstrap confidence intervals for macro recall@k.

    Resamples IMAGES with replacement (the i.i.d. unit of the macro
    average) ``n_boot`` times and returns ``{k: (point, lo, hi)}`` where
    ``point`` is the plain macro recall (identical weighting to
    :func:`corpus_recall_multi`: images with empty GT contribute 0 and
    stay in the denominator) and ``[lo, hi]`` is the central
    ``1 - alpha`` percentile interval. Per-image recalls are computed
    ONCE (one dedup pass at max(ks), as everywhere else); the resampling
    is a [n_boot, n] integer gather + mean, so even 10k replicates are
    milliseconds — evaluation cost stays sampling-bound. Deterministic
    in ``seed``.

    Why images and not triples: recall@k is macro-averaged per image, so
    corpus-level uncertainty is driven by which images are in the eval
    set; a triple-level bootstrap would understate it (triples within an
    image share the same generated ranking).
    """
    if int(n_boot) <= 0:
        raise ValueError(
            f"n_boot must be positive, got {n_boot} (0 replicates would "
            "feed np.percentile an empty array)"
        )
    n = len(per_image_gt)
    if n == 0 or not ks:
        return {k: (0.0, 0.0, 0.0) for k in ks}
    kmax = max(ks)
    vals = {k: np.zeros(n, np.float64) for k in ks}
    for i, (gen, gt_list) in enumerate(
        zip(per_image_generated, per_image_gt)
    ):
        gt = {tuple(int(x) for x in t)
              for t in np.asarray(gt_list).reshape(-1, 3)}
        if not gt:
            continue
        top = _dedup_top(gen, kmax)
        cum = np.cumsum([t in gt for t in top]) if top else np.zeros(0)
        for k in ks:
            hits = int(cum[min(k, len(cum)) - 1]) if len(cum) else 0
            vals[k][i] = hits / len(gt)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(int(n_boot), n))
    lo_q, hi_q = 100.0 * (alpha / 2), 100.0 * (1 - alpha / 2)
    out = {}
    for k in ks:
        reps = vals[k][idx].mean(axis=1)
        out[k] = (
            float(vals[k].mean()),
            float(np.percentile(reps, lo_q)),
            float(np.percentile(reps, hi_q)),
        )
    return out


def corpus_zero_shot_recall(
    per_image_generated: list,
    per_image_gt: list,
    train_triples: set,
    ks: list[int],
) -> tuple[dict[int, float], int]:
    """Zero-shot recall@k: recall over GT triples NEVER seen in training.

    The standard zsR@k protocol (Lu et al. 2016, kept by the scene-graph
    literature since): restrict each image's ground truth to the
    (subject, predicate, object) combinations absent from the training
    split, then macro-average recall@k over the images that still have any.
    High recall@k with low zsR@k means the model memorizes the training
    triple distribution rather than composing from the image. Returns
    ``({k: recall}, n_images_with_zero_shot_gt)``.
    """
    sums = {k: 0.0 for k in ks}
    n_zs = 0
    if not ks:
        return sums, 0
    kmax = max(ks)
    for gen, gt_list in zip(per_image_generated, per_image_gt):
        gt = {tuple(int(x) for x in t)
              for t in np.asarray(gt_list).reshape(-1, 3)}
        gt -= train_triples
        if not gt:
            continue
        n_zs += 1
        top = _dedup_top(gen, kmax)
        hit_rank = [t in gt for t in top]
        cum = np.cumsum(hit_rank) if top else np.zeros(0)
        for k in ks:
            hits = int(cum[min(k, len(cum)) - 1]) if len(cum) else 0
            sums[k] += hits / len(gt)
    if n_zs == 0:
        return {k: 0.0 for k in ks}, 0
    return {k: sums[k] / n_zs for k in ks}, n_zs


def corpus_mean_recall(
    per_image_generated: list, per_image_gt: list, k: int = 50
) -> tuple[float, dict[int, tuple[float, int]]]:
    """Predicate-balanced mean recall (mR@k) + the per-predicate table.

    Frequency-skewed corpora let a model score high recall@k from the few
    head predicates alone; mR@k (Tang et al.'s mean recall, standard in the
    scene-graph literature) recalls each PREDICATE class separately —
    hits/total over all ground-truth triples of that class corpus-wide —
    then averages over classes with support. Returns
    ``(mR@k, {predicate_id: (recall, support)})``.
    """
    hits: dict[int, int] = {}
    totals: dict[int, int] = {}
    for gen, gt_list in zip(per_image_generated, per_image_gt):
        gt = {tuple(int(x) for x in t)
              for t in np.asarray(gt_list).reshape(-1, 3)}
        if not gt:
            continue
        top = set(_dedup_top(gen, k))
        for t in gt:
            p = t[1]
            totals[p] = totals.get(p, 0) + 1
            if t in top:
                hits[p] = hits.get(p, 0) + 1
    table = {
        p: (hits.get(p, 0) / tot, tot) for p, tot in sorted(totals.items())
    }
    mr = float(np.mean([r for r, _ in table.values()])) if table else 0.0
    return mr, table


def predicate_recall(
    scores: np.ndarray, gt_pred: np.ndarray, ks: list[int]
) -> dict[int, float]:
    """PredCls metric: fraction of (image, GT subject, GT object) rows whose
    ground-truth predicate ranks in the top-k of the conditional predicate
    scores. ``scores`` float[N, V] (higher = better), ``gt_pred`` int[N].
    Rank counts strictly-greater scores, so exact ties resolve in the GT's
    favor (rank is the optimistic one) — deterministic and documented.
    """
    scores = np.asarray(scores)
    gt = np.asarray(gt_pred)
    gt_scores = scores[np.arange(len(gt)), gt]
    rank = (scores > gt_scores[:, None]).sum(axis=1)  # 0 = top
    return {k: float((rank < k).mean()) if len(gt) else 0.0 for k in ks}
