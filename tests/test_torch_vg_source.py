"""The ``vg`` image source and the path-backed ``ImageTripleDataset`` against
``sgg.cli.common`` and ``sgg.data.images`` on the CPU, on the committed
VG-shaped JPEG fixture (``tests/fixtures_torch/vg_jpeg``): the same split
(ids, paths, triples) for train and test, with and without ``max_images``
and for two split seeds; the same ``sample_batch`` draws (images and triples
identical) given one ``RandomState``, with and without predicate balance and
with the decoded-image cache on; the same ``materialize``; the host-prefetch
iterator's batches; and the named config ``vg_full`` field for field.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sgg.cli.common import load_dataset as jax_load_dataset
from sgg.config import get_config as jax_get_config
from sgg.data.images import ImageTripleDataset as JaxImageTripleDataset
from sgg.data.pipeline import make_train_iterator as jax_make_train_iterator
from sgg_torch.cli.common import load_dataset
from sgg_torch.config import Config as PortConfig
from sgg_torch.config import get_config
from sgg_torch.data import ArrayImageTripleDataset, ImageTripleDataset
from sgg_torch.data.pipeline import make_train_iterator
from test_torch_jpeg import reference_native  # noqa: F401  (sgg's JPEG loader, private)

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures_torch",
                       "vg_jpeg")
SIZE = 32


def _cfgs(**data):
    cfg = jax_get_config("vg_full")
    cfg.data.data_dir, cfg.data.image_size = FIXTURE, SIZE
    for k, v in data.items():
        setattr(cfg.data, k, v)
    return cfg, PortConfig.from_json(cfg.to_json())


def _rel(paths):
    return [os.path.relpath(p, FIXTURE) for p in paths]


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("max_images,split_seed", [(0, 0), (0, 3), (10, 0), (10, 3)])
def test_vg_source_splits_like_reference(split, max_images, split_seed):
    jcfg, pcfg = _cfgs(max_images=max_images, split_seed=split_seed,
                       test_fraction=0.25 if split == "test" else 0.1)
    want, wvocab = jax_load_dataset(jcfg, split=split)
    got, gvocab = load_dataset(pcfg, split=split)
    assert isinstance(got, ImageTripleDataset) and got.image_size == SIZE
    assert _rel(got.paths) == _rel(want.paths) and len(got) > 2
    assert len(got.triples) == len(want.triples)
    for a, b in zip(got.triples, want.triples):
        np.testing.assert_array_equal(a, b)
    assert gvocab.to_json() == wvocab.to_json()
    if max_images and split == "train":
        assert len(got) == max_images


def test_vg_source_train_and_test_are_disjoint():
    _, pcfg = _cfgs()
    train, _ = load_dataset(pcfg, split="train")
    test, _ = load_dataset(pcfg, split="test")
    assert not set(train.paths) & set(test.paths)
    assert len(test) == round(0.1 * (len(train) + len(test)))


def _pair(alpha=0.0, cache=0):
    jcfg, pcfg = _cfgs()
    ref, _ = jax_load_dataset(jcfg)
    ref = JaxImageTripleDataset(paths=ref.paths, triples=ref.triples, image_size=SIZE,
                                cache_images=cache)
    port = ImageTripleDataset(paths=list(ref.paths), triples=list(ref.triples),
                              image_size=SIZE, cache_images=cache)
    if alpha:
        ref.set_predicate_balance(alpha)
        port.set_predicate_balance(alpha)
    return ref, port


@pytest.mark.parametrize("alpha,cache", [(0.0, 0), (0.7, 0), (0.0, 12), (0.7, 100)])
def test_sample_batch_draws_like_reference(alpha, cache):
    ref, port = _pair(alpha, cache)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    idx = ref.process_slice(0, 1)
    np.testing.assert_array_equal(port.process_slice(0, 1), idx)
    for _ in range(4):
        a, b = port.sample_batch(r1, idx, 6), ref.sample_batch(r2, idx, 6)
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["triples"], b["triples"])
        assert a["images"].shape == (6, SIZE, SIZE, 3) and a["triples"].dtype == np.int32
    assert sorted(port._cache) == sorted(ref._cache)
    assert port.decoded_images >= 6 and port.decode_seconds > 0
    assert port.est_bytes == ref.est_bytes == len(port) * SIZE * SIZE * 3


@pytest.mark.parametrize("alpha", [0.0, 0.7])
def test_materialize_equals_reference(alpha):
    ref, port = _pair(alpha)
    lines = []
    got, want = port.materialize(log=lines.append, chunk=8), ref.materialize(chunk=8)
    assert isinstance(got, ArrayImageTripleDataset)
    np.testing.assert_array_equal(got.images, want.images)
    for a, b in zip(got.triples, want.triples):
        np.testing.assert_array_equal(a, b)
    if alpha:
        for a, b in zip(got.triple_weights, want.triple_weights):
            np.testing.assert_array_equal(a, b)
    assert lines[0] == f"[sgg.data] materialize: 8/{len(port)} images decoded"


def test_host_iterator_takes_the_path_backed_dataset():
    ref, port = _pair(0.7)
    want = jax_make_train_iterator(ref, 4, 2, seed=3, process_index=0, process_count=1,
                                   prefetch=0, device_put=False)
    got = make_train_iterator(port, 4, 2, seed=3, prefetch=0)
    for _ in range(2):
        a, b = next(got), next(want)
        assert set(a) == set(b) == {"images", "triples"}
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_vg_full_equals_reference_config():
    got, want = get_config("vg_full"), jax_get_config("vg_full")
    for section in ("model", "data", "train", "mesh"):
        a, b = dataclasses.asdict(getattr(got, section)), dataclasses.asdict(
            getattr(want, section))
        assert a == b, section
    assert got.name == want.name == "vg_full"
    assert got.to_json() == want.to_json()
