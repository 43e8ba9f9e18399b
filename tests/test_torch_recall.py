"""The port's recall metrics against ``sgg/eval/recall.py`` on the same
rankings: recall at several cutoffs, the percentile bootstrap from the same
seed, zero-shot recall, mean recall with its per-predicate table and PredCls
recall, all identical; and the edge cases (no cutoffs, empty ground truth,
no zero-shot image, a non-positive replicate count).
"""

import numpy as np
import pytest
import torch

from sgg.eval import recall as ref
from sgg_torch.eval import recall as port

torch.set_num_threads(1)

KS = [1, 3, 5, 20]


def _corpus(seed=0, n=40):
    """Per-image rankings with repeats and ground truth with some empty
    images, over a small vocabulary so that hits are common."""
    r = np.random.RandomState(seed)
    gen, gt = [], []
    for i in range(n):
        gen.append([tuple(int(x) for x in t) for t in r.randint(0, 4, (r.randint(0, 30), 3))])
        gt.append([] if i % 7 == 3 else
                  [tuple(int(x) for x in t) for t in r.randint(0, 4, (r.randint(1, 6), 3))])
    return gen, gt


def test_recall_multi_and_bootstrap_match_reference():
    gen, gt = _corpus()
    assert port.corpus_recall_multi(gen, gt, KS) == ref.corpus_recall_multi(gen, gt, KS)
    assert port.corpus_recall_multi(gen, gt, []) == ref.corpus_recall_multi(gen, gt, []) == {}
    assert port.corpus_recall_multi([], [], KS) == ref.corpus_recall_multi([], [], KS)
    for seed, n_boot, alpha in ((0, 200, 0.05), (3, 57, 0.1)):
        assert port.corpus_recall_bootstrap(gen, gt, KS, n_boot=n_boot, seed=seed, alpha=alpha) \
            == ref.corpus_recall_bootstrap(gen, gt, KS, n_boot=n_boot, seed=seed, alpha=alpha)
    with pytest.raises(ValueError):
        port.corpus_recall_bootstrap(gen, gt, KS, n_boot=0)
    for k in KS:
        assert port.corpus_recall(gen, gt, k) == ref.corpus_recall(gen, gt, k)


def test_zero_shot_and_mean_recall_match_reference():
    gen, gt = _corpus(1)
    train = {t for g in _corpus(2)[1] for t in g}
    assert port.corpus_zero_shot_recall(gen, gt, train, KS) == \
        ref.corpus_zero_shot_recall(gen, gt, train, KS)
    every = {t for g in gt for t in g}
    assert port.corpus_zero_shot_recall(gen, gt, every, KS) == \
        ref.corpus_zero_shot_recall(gen, gt, every, KS) == ({k: 0.0 for k in KS}, 0)
    for k in (1, 5, 50):
        assert port.corpus_mean_recall(gen, gt, k) == ref.corpus_mean_recall(gen, gt, k)
    assert port.corpus_mean_recall([], [], 5) == ref.corpus_mean_recall([], [], 5)


def test_predicate_recall_matches_reference():
    r = np.random.RandomState(4)
    scores = r.randn(50, 12).astype(np.float32)
    scores[3, :] = 0.0  # an exact tie resolves in the ground truth's favour
    gt = r.randint(0, 12, 50)
    assert port.predicate_recall(scores, gt, [1, 2, 5]) == \
        ref.predicate_recall(scores, gt, [1, 2, 5])
    assert port.predicate_recall(scores[:0], gt[:0], [1]) == {1: 0.0}
