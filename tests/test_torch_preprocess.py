"""VG parsing, ``preprocess`` and the debug checks against the reference.

- Every function of ``sgg_torch.data.vg`` (and ``normalize_name``) against
  ``sgg.data.vg``'s on the same JSON: a synthetic VG corpus and hand-written
  edge cases (``name`` and ``names``, missing and empty fields, ``id`` for
  ``image_id``, boxes, out-of-vocab tokens); ``synthetic_vg_json`` against
  ``sgg``'s, equal objects.
- ``python -m sgg_torch.cli.preprocess`` against ``sgg.cli.preprocess``:
  ``--synthetic`` and ``--vg-dir --encoder random`` (with ``--max-images``)
  give byte-identical ``vocab.json`` and equal shard arrays; the reference's
  random route returns before it writes ``vocab.json``, so the port's is held
  against the vocab the reference built and would have saved; ``--encoder
  vgg19`` without ``--image-dir`` returns 1 with the reference's message
  (``tests/test_torch_extract.py`` holds its extraction).
- ``assert_super_batch`` on good and malformed batches, numpy and tensors,
  where ``sgg``'s raises too; ``--debug-nans``: a NaN in the features fails
  both train CLIs (``FloatingPointError``), and on sound data the port's
  metrics are those of a run without it.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import sgg.cli.preprocess as jax_preprocess
from sgg.data import synthetic_vg_json as jax_synthetic_vg_json
from sgg.data import vg as jax_vg
from sgg.data.vocab import normalize_name as jax_normalize_name
from sgg.utils.debug import assert_super_batch as jax_assert_super_batch
from sgg_torch.cli import preprocess, train
from sgg_torch.data import (
    build_vocab_from_relationships,
    filter_and_encode,
    list_shards,
    normalize_name,
    parse_entity_boxes,
    parse_relationships,
    TripleDataset,
    read_feature_shard,
    synthetic_vg_json,
    train_test_split,
    write_feature_shard,
)
from sgg_torch.data.shards import shard_name
from sgg_torch.utils.debug import assert_super_batch, host_rss_gb

torch.set_num_threads(1)

THROUGHPUT = {"images_per_sec", "images_per_sec_per_chip", "steps_per_sec"}
EDGES = [
    {"image_id": 1, "relationships": [
        {"predicate": "  Sitting   ON ", "subject": {"names": ["Man"], "x": 1, "y": 2, "w": 3,
                                                      "h": 4},
         "object": {"name": "bench", "x": 5, "y": 6, "w": 7, "h": 8}},
        {"predicate": "", "subject": {"name": "man"}, "object": {"name": "dog"}},
        {"predicate": "has", "subject": {"names": []}, "object": {"name": "hat"}},
        {"predicate": "has", "subject": {"name": "man", "x": 1, "y": 2, "w": 3, "h": 4},
         "object": {"name": "HAT"}},
        {"subject": {"name": "man"}, "object": {"name": "hat"}}]},
    {"id": 2, "relationships": [{"predicate": "near", "subject": {"name": "dog"},
                                 "object": {"names": ["tree", "plant"]}}]},
    {"image_id": 3},
    {"image_id": 4, "relationships": [{"predicate": "on", "subject": {"name": "zebra"},
                                       "object": {"name": "grass"}}] * 3},
]


def test_vg_functions_match_reference():
    for name in ("  A  Big\tDog ", "ON", ""):
        assert normalize_name(name) == jax_normalize_name(name)
    for data in (EDGES, synthetic_vg_json(60, seed=2, max_rels=9, vocab_objects=40,
                                          vocab_predicates=14)):
        images, ref_images = parse_relationships(data), jax_vg.parse_relationships(data)
        assert [(i.image_id, i.triples) for i in images] == \
            [(i.image_id, i.triples) for i in ref_images]
        assert parse_entity_boxes(data) == jax_vg.parse_entity_boxes(data)
        for kw in ({}, {"max_objects": 5, "max_predicates": 2, "min_count": 2}):
            vocab = build_vocab_from_relationships(images, **kw)
            ref_vocab = jax_vg.build_vocab_from_relationships(ref_images, **kw)
            assert vocab.to_json() == ref_vocab.to_json()
            for fk in ({}, {"min_triples": 2, "max_triples_per_image": 3},
                       {"drop_unk": False}):
                ids, enc = filter_and_encode(images, vocab, **fk)
                ref_ids, ref_enc = jax_vg.filter_and_encode(ref_images, ref_vocab, **fk)
                assert ids == ref_ids and len(enc) == len(ref_enc)
                for a, b in zip(enc, ref_enc):
                    assert a.dtype == b.dtype == np.int32
                    np.testing.assert_array_equal(a, b)
    ids = list(range(100, 137))
    for frac, seed in ((0.1, 0), (0.3, 5), (0.0, 1)):
        assert train_test_split(ids, frac, seed) == jax_vg.train_test_split(ids, frac, seed)


def test_vg_parsing_reads_paths_and_files(tmp_path):
    path = str(tmp_path / "relationships.json")
    with open(path, "w") as f:
        json.dump(EDGES, f)
    want = [(i.image_id, i.triples) for i in jax_vg.parse_relationships(path)]
    assert [(i.image_id, i.triples) for i in parse_relationships(path)] == want
    with open(path) as f:
        assert [(i.image_id, i.triples) for i in parse_relationships(f)] == want
    assert parse_entity_boxes(path) == jax_vg.parse_entity_boxes(path)


@pytest.mark.parametrize("kw", [{}, {"num_images": 30, "seed": 4, "max_rels": 12},
                                {"num_images": 25, "vocab_objects": 300,
                                 "vocab_predicates": 80, "max_rels": 20}])
def test_synthetic_vg_json_matches_reference(kw):
    assert synthetic_vg_json(**kw) == jax_synthetic_vg_json(**kw)


def _same_output(port_dir, ref_dir, vocab_too=True):
    if vocab_too:
        with open(os.path.join(port_dir, "vocab.json"), "rb") as f, \
                open(os.path.join(ref_dir, "vocab.json"), "rb") as g:
            assert f.read() == g.read()
    for sub in ("", "test"):
        mine, theirs = list_shards(os.path.join(port_dir, sub)), \
            list_shards(os.path.join(ref_dir, sub))
        assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in theirs]
        assert mine
        for a, b in zip(mine, theirs):
            sa, sb = read_feature_shard(a), read_feature_shard(b)
            assert set(sa) == set(sb)
            for k in sb:
                if isinstance(sb[k], list):
                    assert len(sa[k]) == len(sb[k])
                    for x, y in zip(sa[k], sb[k]):
                        np.testing.assert_array_equal(x, y)
                else:
                    assert sa[k].dtype == sb[k].dtype
                    np.testing.assert_array_equal(sa[k], sb[k])


def test_preprocess_synthetic_matches_reference(tmp_path, capsys):
    args = ["--synthetic", "30", "--regions", "5", "--feat-dim", "8", "--shard-size", "8",
            "--feat-dtype", "float16", "--seed", "3"]
    assert preprocess.main(["--out-dir", str(tmp_path / "port"), *args]) == 0
    assert jax_preprocess.main(["--out-dir", str(tmp_path / "ref"), *args]) == 0
    _same_output(str(tmp_path / "port"), str(tmp_path / "ref"))
    assert "synthetic: 30 images" in capsys.readouterr().out


def test_preprocess_vg_random_matches_reference(tmp_path, monkeypatch):
    """The reference's ``--encoder random`` returns before it saves the vocab
    (sgg/cli/preprocess.py), so the port's ``vocab.json`` is held against the
    vocab the reference built, saved by the reference's ``Vocab.save``."""
    vg = tmp_path / "vg"
    vg.mkdir()
    with open(vg / "relationships.json", "w") as f:
        json.dump(synthetic_vg_json(90, vocab_objects=40, vocab_predicates=15, max_rels=8), f)
    args = ["--vg-dir", str(vg), "--encoder", "random", "--max-objects", "25",
            "--max-predicates", "9", "--min-count", "2", "--max-triples-per-image", "5",
            "--max-images", "70", "--test-fraction", "0.2", "--shard-size", "16",
            "--regions", "4", "--feat-dim", "6", "--feat-dtype", "float16", "--seed", "1"]
    built = []
    build = jax_preprocess.build_vocab_from_relationships
    monkeypatch.setattr(jax_preprocess, "build_vocab_from_relationships",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    assert jax_preprocess.main(["--out-dir", str(tmp_path / "ref"), *args]) == 0
    assert not (tmp_path / "ref" / "vocab.json").exists()
    built[0].save(str(tmp_path / "ref" / "vocab.json"))
    assert preprocess.main(["--out-dir", str(tmp_path / "port"), *args]) == 0
    _same_output(str(tmp_path / "port"), str(tmp_path / "ref"))
    n_train = sum(len(read_feature_shard(p)["image_ids"])
                  for p in list_shards(str(tmp_path / "port")))
    assert n_train == 56  # 70 images, 14 held out


@pytest.mark.parametrize("extra", [[], ["--vgg-weights", "w.npy"], ["--encoder-ckpt", "e"]])
def test_preprocess_refuses_vgg19(tmp_path, capsys, extra):
    """``--encoder vgg19`` without ``--image-dir``: both CLIs return 1 with the
    same message before they read any weights, and write no vocab.json."""
    (tmp_path / "vg").mkdir()
    with open(tmp_path / "vg" / "relationships.json", "w") as f:
        json.dump(synthetic_vg_json(12, seed=1, max_rels=4), f)
    args = ["--vg-dir", str(tmp_path / "vg"), "--encoder", "vgg19", *extra]
    assert jax_preprocess.main(["--out-dir", str(tmp_path / "ref"), *args]) == 1
    want = capsys.readouterr().err
    assert preprocess.main(["--out-dir", str(tmp_path / "out"), *args]) == 1
    err = capsys.readouterr().err
    assert err == want and "--encoder vgg19 requires --image-dir" in err
    assert not os.path.exists(tmp_path / "out" / "vocab.json")


def _batch(nc=2, B=4, images=False, lib=np):
    r = np.random.RandomState(0)
    data = (r.randint(0, 256, (nc + 1, B, 8, 8, 3)).astype(np.uint8) if images
            else r.randn(nc + 1, B, 5, 6).astype(np.float32))
    out = {"images" if images else "features": data,
           "triples": r.randint(0, 9, (nc + 1, B, 3)).astype(np.int32)}
    return out if lib is np else {k: torch.from_numpy(v) for k, v in out.items()}


@pytest.mark.parametrize("lib", ["numpy", "torch"])
def test_assert_super_batch_matches_reference(lib):
    lib = np if lib == "numpy" else torch
    bad = [
        ({"triples": lambda t: t[..., :2]}, "axis '2'"),
        ({"triples": lambda t: t[0]}, "rank 2"),
        ({"triples": lambda t: t.astype(np.int64) if isinstance(t, np.ndarray) else t.long()},
         "int64"),
        ({"features": lambda x: x[:2], "triples": lambda t: t[:2]}, "'3' on axis '0'"),
        ({"features": lambda x: x[:, :3]}, "'4' on axis '1'"),
        ({"features": lambda x: x[..., 0]}, "rank 3"),
    ]
    for images in (False, True):
        good = _batch(images=images, lib=lib)
        assert_super_batch(good, 2, 4)
        jax_assert_super_batch(_batch(images=images), 2, 4)
    for images in (False, True):
        for edits, message in bad:
            key = "images" if images else "features"
            batch = _batch(images=images, lib=lib)
            ref = _batch(images=images)
            for k, fn in edits.items():
                k = key if k == "features" else k
                batch[k], ref[k] = fn(batch[k]), fn(ref[k])
            with pytest.raises(AssertionError) as got:
                assert_super_batch(batch, 2, 4)
            with pytest.raises(AssertionError):
                jax_assert_super_batch(ref, 2, 4)
            if not (images and "rank 3" in message):
                assert message in str(got.value)
    pix = _batch(images=True, lib=lib)
    pix["images"] = pix["images"].astype(np.float32) if lib is np else pix["images"].float()
    with pytest.raises(AssertionError, match="float32 but expected uint8"):
        assert_super_batch(pix, 2, 4)
    assert host_rss_gb() > 0


def _nan_corpus(root):
    """A seeded shard corpus (9 x 16 float16 features, 12-object, 8-predicate
    vocab) with one NaN in every image's features."""
    from test_torch_evaluate import write_corpus

    write_corpus(root)
    path = os.path.join(root, shard_name(0, 1))
    ds = TripleDataset.from_shards([path])
    feats = ds.features.copy()
    feats[:, 0, 0] = np.nan
    write_feature_shard(path, read_feature_shard(path)["image_ids"], feats, ds.triples)


def _sets(root):
    return ["--set", "data.source=shards", "--set", f"data.data_dir={root}",
            "--set", "data.regions=9", "--set", "data.feat_dim=16"]


def test_debug_nans_fails_both_clis(tmp_path, capsys):
    import sgg.cli.train as jax_train

    root = str(tmp_path / "corpus")
    _nan_corpus(root)
    port = ["--config", "smoke", "--device", "cpu", "--steps", "2", *_sets(root)]
    with pytest.raises(FloatingPointError, match="step 1"):
        train.main(port + ["--workdir", str(tmp_path / "port"), "--debug-nans"])
    assert train.main(port + ["--workdir", str(tmp_path / "unchecked")]) == 0
    with open(tmp_path / "unchecked" / "metrics.jsonl") as f:
        assert any(not np.isfinite(v) for v in json.loads(f.readline()).values())
    try:
        with pytest.raises(FloatingPointError):
            jax_train.main(["--config", "smoke", "--steps", "1", "--workdir",
                            str(tmp_path / "ref"), "--debug-nans", *_sets(root)])
    finally:
        jax.config.update("jax_debug_nans", False)


def test_debug_nans_leaves_a_sound_run_unchanged(tmp_path):
    lines = []
    for name, extra in (("plain", []), ("checked", ["--debug-nans"])):
        wd = tmp_path / name
        assert train.main(["--config", "smoke", "--device", "cpu", "--steps", "3", "--workdir",
                           str(wd), "--set", "train.log_every=1", *extra]) == 0
        with open(wd / "metrics.jsonl") as f:
            lines.append([{k: v for k, v in json.loads(ln).items() if k not in THROUGHPUT}
                          for ln in f])
    assert len(lines[0]) == 3 and lines[0] == lines[1]
    assert not torch.is_anomaly_enabled()
