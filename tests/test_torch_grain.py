"""The grain loader (``sgg_torch.data.grain_pipeline``, ``data.loader=grain``)
against ``sgg.data.grain_pipeline``'s.

- Fed ``grain.IndexSampler``'s record keys, the port's super-batches equal
  ``sgg``'s ``make_grain_iterator`` (grain itself, no workers) bit for bit,
  across two epoch boundaries, at one process and at two (each shard's record
  set is grain's), for a feature dataset and for a path-backed image dataset
  (the JPEG fixture at 32 px).
- ``num_workers = 2`` (spawned processes) gives the batches of
  ``num_workers = 0``; its mid-epoch state resumes a fresh iterator exactly.
- The default order is a permutation of the shard in each epoch, another in
  each.
- ``get_state``/``set_state`` alone and through ``CheckpointManager``'s
  sidecar, with pruning (``tests/unit/test_grain_pipeline.py``'s contract).
- ``train --set data.loader=grain`` cut at a checkpoint (in two worker
  processes) and resumed equals an unbroken run bit for bit, and prints the
  reference's restored line (``test_train_grain_loader_exact_resume``).
"""

import json
import os

import grain.python as grain
import numpy as np
import pytest
import torch

from sgg.data import TripleDataset as RefTripleDataset
from sgg.data import synthetic_dataset
from sgg.data.grain_pipeline import make_grain_iterator as ref_make_grain_iterator
from sgg.data.images import ImageTripleDataset as RefImageTripleDataset
from sgg_torch.cli import train
from sgg_torch.config import get_config
from sgg_torch.data import ImageTripleDataset, TripleDataset
from sgg_torch.data.grain_pipeline import make_grain_iterator, shard_bounds
from sgg_torch.train.checkpoint import CheckpointManager
from sgg_torch.train.state import create_train_state
from test_torch_jpeg import reference_native  # noqa: F401  (sgg's JPEG loader, private)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = os.path.join(REPO, "tests", "fixtures_torch", "vg_jpeg")
N = 33  # records: shards of 16 at two processes, one left over
B, N_CRITIC = 4, 2


def _datasets(kind):
    """(reference dataset, port dataset) over the same records."""
    if kind == "features":
        d = synthetic_dataset(num_images=N, regions=7, feat_dim=8)
        return (RefTripleDataset(features=d["features"], triples=d["triples"]),
                TripleDataset(features=d["features"], triples=d["triples"]))
    with open(os.path.join(JPEGS, "relationships.json")) as f:
        ids = [e["image_id"] for e in json.load(f)]
    paths = [os.path.join(JPEGS, "images", f"{i}.jpg") for i in ids]
    r = np.random.RandomState(1)
    triples = [r.randint(0, 20, (int(r.randint(1, 4)), 3)).astype(np.int32) for _ in paths]
    return (RefImageTripleDataset(paths=paths, triples=triples, image_size=32),
            ImageTripleDataset(paths=paths, triples=triples, image_size=32))


def grain_order(n, seed, index, count, records):
    """The record keys grain's DataLoader reads in process ``index`` of
    ``count`` (global indices index, index + count, ...)."""
    s = grain.IndexSampler(num_records=n, shard_options=grain.ShardOptions(
        shard_index=index, shard_count=count, drop_remainder=True),
        shuffle=True, num_epochs=None, seed=seed)
    return [s[index + k * count].record_key for k in range(records)]


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kind,count", [("features", 1), ("features", 2), ("images", 1)])
def test_super_batches_match_the_reference(kind, count):
    ref_ds, ds = _datasets(kind)
    n = len(ds)
    steps = 2 * (n // count) // (B * (N_CRITIC + 1)) + 1  # past two epoch boundaries
    for index in range(count):
        order = grain_order(n, 5, index, count, steps * B * (N_CRITIC + 1))
        lo, hi = shard_bounds(n, index, count)
        assert set(order) == set(range(lo, hi))  # each shard's records are grain's
        ref = ref_make_grain_iterator(ref_ds, B, N_CRITIC, seed=5, process_index=index,
                                      process_count=count)
        it = make_grain_iterator(ds, B, N_CRITIC, seed=5, process_index=index,
                                 process_count=count, order=order)
        for _ in range(steps):
            got = next(it)
            _equal(got, next(ref))
        assert got["triples"].dtype == np.int32
        assert got["images" if kind == "images" else "features"].shape[:2] == (N_CRITIC + 1, B)


def test_workers_give_the_batches_of_no_workers_and_resume():
    _, ds = _datasets("features")
    plain = make_grain_iterator(ds, B, N_CRITIC, seed=3)
    spawned = make_grain_iterator(ds, B, N_CRITIC, seed=3, num_workers=2)
    try:
        for _ in range(4):  # past the first epoch's end (33 records, 12 a step)
            _equal(next(spawned), next(plain))
        state = spawned.get_state()
        assert json.loads(state) == {"epoch": 1, "position": 15, "seed": 3, "shard_count": 1,
                                     "batch_size": B}
        want = [next(spawned) for _ in range(3)]
    finally:
        spawned.close()
    fresh = make_grain_iterator(ds, B, N_CRITIC, seed=3)
    fresh.set_state(state)
    for w in want:
        _equal(next(fresh), w)
    with pytest.raises(ValueError, match="does not fit"):
        make_grain_iterator(ds, B, N_CRITIC, seed=4).set_state(state)


def test_default_order_is_a_fresh_permutation_each_epoch():
    _, ds = _datasets("features")
    for index in (0, 1):
        it = make_grain_iterator(ds, B, N_CRITIC, seed=3, process_index=index, process_count=2)
        lo, hi = shard_bounds(N, index, 2)
        stream = it._stream(0)
        epochs = [[next(stream) for _ in range(hi - lo)] for _ in range(3)]
        for e in epochs:
            assert sorted(e) == list(range(lo, hi))
        assert epochs[0] != epochs[1] != epochs[2]
        resumed = it._stream(hi - lo + 5)  # mid-epoch, as set_state starts it
        assert [next(resumed) for _ in range(hi - lo)] == (epochs[1] + epochs[2])[5:hi - lo + 5]


def test_midepoch_state_and_checkpoint_sidecar(tmp_path):
    _, ds = _datasets("features")
    mk = lambda: make_grain_iterator(ds, B, 1, seed=7)  # noqa: E731
    it = mk()
    for _ in range(3):
        next(it)
    snap = it.get_state()
    expect = [next(it) for _ in range(4)]
    it2 = mk()
    it2.set_state(snap)
    for e in expect:
        _equal(next(it2), e)

    cfg = get_config("smoke")
    cfg.model.vocab_size = 16
    mgr = CheckpointManager(str(tmp_path), cfg, max_to_keep=2)
    state = create_train_state(cfg, 0)
    it = mk()
    snaps = {}
    for step in (1, 2, 3):
        next(it)
        state.step = step
        snaps[step] = it.get_state()
        mgr.save(state, data_state=snaps[step])
        assert mgr.restore_data_state() == snaps[step]
    names = sorted(n for n in os.listdir(mgr.ckpt_dir) if n.startswith("data_iter_"))
    assert names == ["data_iter_2.bin", "data_iter_3.bin"] and mgr.all_steps() == [2, 3]
    want = next(it)
    it3 = mk()
    it3.set_state(mgr.restore_data_state())
    _equal(next(it3), want)


def _run(wd, steps, workers=0):
    return train.main(["--config", "smoke", "--device", "cpu", "--workdir", str(wd),
                       "--steps", str(steps), "--set", "data.loader=grain",
                       "--set", f"data.grain_workers={workers}", "--set", "train.log_every=1",
                       "--set", "train.checkpoint_every=5",
                       "--set", "train.steps_per_dispatch=2"])


def test_train_grain_cut_and_resumed_equals_unbroken(tmp_path, capsys):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    assert _run(whole, 8) == 0
    assert _run(cut, 5, workers=2) == 0
    out = capsys.readouterr().out
    assert "[sgg.train] grain loader (workers=2)" in out
    assert ("[sgg.train] steps_per_dispatch needs the single-process device-resident data "
            "path — falling back to per-step dispatch") in out
    assert (cut / "checkpoints" / "data_iter_5.bin").exists()
    assert _run(cut, 8) == 0
    out = capsys.readouterr().out
    assert "resumed from step 5" in out
    assert "[sgg.train] grain iterator state restored (exact mid-epoch resume)" in out
    assert (cut / "checkpoints" / "data_iter_8.bin").exists()
    a, b = (torch.load(w / "checkpoints" / "8" / "state.pt", weights_only=True)
            for w in (whole, cut))
    for part in ("g_params", "d_params", "g_ema"):
        for k in a[part] or {}:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    with open(whole / "metrics.jsonl") as f, open(cut / "metrics.jsonl") as g:
        losses = [[{k: v for k, v in json.loads(line).items() if "loss" in k or k == "step"}
                   for line in h] for h in (f, g)]
    assert losses[0] == losses[1] and len(losses[0]) == 8
    assert (cut / "checkpoints" / "data_iter_8.bin").read_bytes() == \
        (whole / "checkpoints" / "data_iter_8.bin").read_bytes()
