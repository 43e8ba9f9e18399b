"""The main path's data tier against the reference (``sgg/data``): the
predicate-balance weights, the dense CDF and the int8 quantization
(identical arrays); the weighted host iterator (the reference's batches,
identical); the device gather, fed the reference's own ``jax.random`` draws
(identical batches for the uniform, balanced, int8 and int8 + balanced
stores, float32 and float16); and the rotating iterator (identical subsets,
order and batches step by step, at most two subsets alive, the swap after
``min_steps_per_subset`` steps).
"""

import time

import numpy as np
import pytest
import torch

import jax

from sgg.data import TripleDataset as JaxTripleDataset
from sgg.data.images import compute_triple_weights as jax_compute_triple_weights
from sgg.data.pipeline import _dense_cum_weights as jax_dense_cum_weights
from sgg.data.pipeline import _make_sample_body, _prepare_device_arrays
from sgg.data.pipeline import make_rotating_device_iterator as jax_make_rotating
from sgg.data.pipeline import make_train_iterator as jax_make_train_iterator
from sgg.data.pipeline import quantize_feature_store as jax_quantize
from sgg_torch.config import get_config
from sgg_torch.data import TripleDataset
from sgg_torch.data.images import ArrayImageTripleDataset, compute_triple_weights
from sgg_torch.data.pipeline import (
    RotatingDeviceIterator,
    _dense_cum_weights,
    make_device_train_iterator,
    make_train_iterator,
    quantize_feature_store,
    rotation_subsets,
)

torch.set_num_threads(1)

N, R, F, NPRED = 24, 3, 8, 12
NC, B = 2, 5


def long_tail_data(seed=0, dtype=np.float32, n=N):
    """Features and 1-6 triples per image whose predicates follow a long
    tail (predicate p drawn with weight 1/(p+1)^2)."""
    r = np.random.RandomState(seed)
    feats = (r.randn(n, R, F) * r.uniform(0.1, 10, (n, R, 1))).astype(dtype)
    w = 1.0 / (np.arange(NPRED) + 1.0) ** 2
    triples = []
    for _ in range(n):
        k = r.randint(1, 7)
        triples.append(np.stack([r.randint(0, 30, k), 30 + r.choice(NPRED, k, p=w / w.sum()),
                                 r.randint(0, 30, k)], axis=1).astype(np.int32))
    return feats, triples


def datasets(alpha, dtype=np.float32):
    feats, triples = long_tail_data(dtype=dtype)
    ref, port = JaxTripleDataset(feats, triples), TripleDataset(feats, triples)
    if alpha:
        ref.set_predicate_balance(alpha)
        port.set_predicate_balance(alpha)
    return ref, port


def test_weights_cdf_and_quantization_match_reference():
    feats, triples = long_tail_data()
    for alpha in (0.0, 0.7, 1.0):
        want, got = jax_compute_triple_weights(triples, alpha), compute_triple_weights(
            triples, alpha)
        if alpha == 0:
            assert want is None and got is None
            continue
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(_dense_cum_weights(triples, got, 7),
                                      jax_dense_cum_weights(triples, want, 7))
    for dtype in (np.float32, np.float16):
        f = feats.astype(dtype)
        for (q, s), (qr, sr) in ((quantize_feature_store(f, chunk=7), jax_quantize(f, chunk=7)),
                                 (quantize_feature_store(f), jax_quantize(f))):
            assert q.dtype == np.int8 and s.dtype == np.float32
            np.testing.assert_array_equal(q, qr)
            np.testing.assert_array_equal(s, sr)
    imgs = ArrayImageTripleDataset(np.zeros((N, 2, 2, 3), np.uint8), triples)
    imgs.set_predicate_balance(0.7)
    for a, b in zip(imgs.triple_weights, jax_compute_triple_weights(triples, 0.7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("alpha", [0.0, 0.7])
def test_weighted_host_iterator_matches_reference(alpha):
    ref, port = datasets(alpha)
    want = jax_make_train_iterator(ref, B, NC, seed=3, process_index=0, process_count=1,
                                   prefetch=0, device_put=False)
    got = make_train_iterator(port, B, NC, seed=3, prefetch=0)
    for _ in range(4):
        a, b = next(got), next(want)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def reference_draws(seed, shape, n, fold_base=None):
    """The reference sampler's draws at each step: fold_in(key(seed), step),
    split into the image and the triple keys."""
    base = jax.random.key(seed) if fold_base is None else fold_base

    def draws(step):
        k_img, k_tri = jax.random.split(jax.random.fold_in(base, step))
        img = jax.random.randint(k_img, shape, 0, n)
        u = jax.random.uniform(k_tri, shape)
        return torch.from_numpy(np.array(img)).long(), torch.from_numpy(np.array(u))

    return draws


@pytest.mark.parametrize("int8,alpha,dtype", [(False, 0.0, np.float32), (False, 0.7, np.float32),
                                              (True, 0.0, np.float32), (True, 0.7, np.float16)])
def test_device_gather_matches_reference_on_its_draws(int8, alpha, dtype):
    ref, port = datasets(alpha, dtype)
    arrays, meta = _prepare_device_arrays(ref, 0, 1, int8)
    sample = jax.jit(_make_sample_body(meta, B, NC, 5, None))
    it = make_device_train_iterator(port, B, NC, device="cpu", int8_store=int8,
                                    draws=reference_draws(5, (NC + 1, B), N))
    for step in range(3):
        want, got = sample(*arrays, step), next(it)
        assert got["features"].dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_array_equal(got["features"].numpy(), np.asarray(want["features"]))
        np.testing.assert_array_equal(got["triples"].numpy(), np.asarray(want["triples"]))


def test_balanced_draws_move_toward_the_tail():
    """At the same draws, alpha = 0.7 picks tail predicates more often than
    the uniform choice, and a draw equal to a step of an image's CDF takes
    that step's triple (the strict inverse CDF)."""
    _, port = datasets(0.0)
    _, bal = datasets(0.7)
    draws = reference_draws(1, (NC + 1, 400), N)
    uni = next(make_device_train_iterator(port, 400, NC, device="cpu", draws=draws))
    tail = next(make_device_train_iterator(bal, 400, NC, device="cpu", draws=draws))
    head = lambda b: (b["triples"][..., 1] - 30 < 2).float().mean().item()  # noqa: E731
    assert head(tail) < head(uni)
    from sgg_torch.data.pipeline import DeviceStore, gather_super_batch

    cumw = torch.from_numpy(_dense_cum_weights(bal.triples, bal.triple_weights, 6))
    img = torch.tensor([[j for j in range(N) if len(bal.triples[j]) > 2][0]])
    u = cumw[img, 1]  # exactly the CDF's second step: the second triple
    store = DeviceStore(torch.zeros(N, 1), None, torch.zeros(N, 6, 3, dtype=torch.int32),
                        torch.zeros(N, dtype=torch.int32), cumw, torch.float32)
    store.dense[img, 1] = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert gather_super_batch(store, img, u)["triples"].tolist() == [[1, 2, 3]]


def _wait(pred, timeout=30.0):
    t0 = time.time()
    while not pred():
        if time.time() - t0 > timeout:
            raise TimeoutError("the next subset never became ready")
        time.sleep(0.005)


@pytest.mark.parametrize("min_steps,int8,alpha", [(1, False, 0.0), (2, True, 0.7)])
def test_rotating_iterator_matches_reference(min_steps, int8, alpha):
    """Each step waits until the next subset is ready, so both iterators swap
    exactly every ``min_steps`` steps; the port's batches are then the
    reference's, given its draws."""
    ref, port = datasets(alpha, np.float16)
    store = quantize_feature_store(port.features)[0] if int8 else port.features
    per_img = store[0].nbytes + (R * 4 if int8 else 0)
    subset_bytes = per_img * 9  # 9 images a subset: 3 subsets, the last wrapping
    want = jax_make_rotating(ref, B, NC, seed=4, subset_bytes=subset_bytes,
                             min_steps_per_subset=min_steps, int8_store=int8, log=None)
    got = RotatingDeviceIterator(port, B, NC, seed=4, subset_bytes=subset_bytes,
                                 min_steps_per_subset=min_steps, int8_store=int8,
                                 device="cpu", log=None,
                                 draws=reference_draws(4, (NC + 1, B), 9))
    try:
        subsets = rotation_subsets(N, per_img, subset_bytes, 4)
        assert got.n_subsets == 3 and [len(s) for s in subsets] == [9, 9, 9]
        order = np.random.RandomState(4).permutation(N)
        np.testing.assert_array_equal(np.concatenate(subsets)[:N], order)
        np.testing.assert_array_equal(subsets[2][6:], order[:3])  # the last one wraps
        n_steps = 7 * min_steps
        for step in range(n_steps):
            b_want, b_got = next(want), next(got)
            for k in ("features", "triples"):
                np.testing.assert_array_equal(b_got[k].numpy(), np.asarray(b_want[k]))
            time.sleep(0.2)  # the reference's thread puts the next subset meanwhile
            _wait(got.preloaded)
        assert got.swaps == (n_steps - 1) // min_steps
        assert [u[0] for u in got.uploads][:4] == [0, 1, 2, 0]
        assert got.max_alive == 2 and got.alive == 2
    finally:
        got.close()
    assert not got._thread.is_alive()


def test_rotation_waits_for_min_steps_and_a_ready_subset():
    _, port = datasets(0.0)
    it = RotatingDeviceIterator(port, 2, 1, seed=0, subset_bytes=port.features[0].nbytes * 8,
                                min_steps_per_subset=3, device="cpu", log=None)
    try:
        seen = []
        for _ in range(9):
            _wait(it.preloaded)
            next(it)
            seen.append(it.swaps)
        assert seen == [0, 0, 0, 1, 1, 1, 2, 2, 2]
        assert it.max_alive == 2
    finally:
        it.close()
    one = RotatingDeviceIterator(port, 2, 1, subset_bytes=10 ** 9, device="cpu", log=None)
    next(one)
    assert one.n_subsets == 1 and one._thread is None and one.swaps == 0
    one.close()


def test_pipeline_v4_config_matches_reference():
    from sgg.config import get_config as jax_get_config

    assert get_config("pipeline_v4").to_json() == jax_get_config("pipeline_v4").to_json()
