"""The grain loader (``data.loader=grain``), from ``sgg/data/grain_pipeline.py``.

The reference builds it on Google Grain; the port's is its own, on
``torch.utils.data``, with the reference's contract:
  - **Records.** One record per image index ``i``: the image and one of its
    triples, drawn by ``RandomState((seed·1,000,003 + i) % 2^31)`` through
    ``dataset.sample_batch(rng, [i], 1)`` (:class:`RecordSource`).
  - **Shards.** Each process reads the records of its own shard, grain's
    ``ShardOptions(drop_remainder=True)`` rule: ``len // count`` records from
    ``index · (len // count)`` (:func:`shard_bounds`); every shard has the
    same size.
  - **Order.** A shuffle that repeats forever, in batches of ``batch_size``
    (the remainder of a finite order is dropped); ``n_critic + 1`` batches
    make one super-batch ``{'features' | 'images': [n_sub, B, ...],
    'triples': int32 [n_sub, B, 3]}``. Grain's own order cannot be drawn
    without grain, so the order is an argument: ``order``, an iterable of
    record indices (the tests fill it from ``grain.IndexSampler``'s record
    keys), or by default the port's own, a permutation of the shard drawn
    afresh for each epoch by ``numpy.random.default_rng([seed, shard index,
    epoch])``.
  - **Workers.** ``num_workers`` > 0 fetches and batches records in that
    many worker processes of a ``torch.utils.data.DataLoader``, started with
    ``spawn`` (a process forked after the parent has touched CUDA could not
    decode with nvJPEG); the batches are the ones ``num_workers = 0`` gives,
    in the same order. A decode that fails in a worker fails the run.
  - **State.** :meth:`GrainTrainIterator.get_state` is a small JSON (epoch,
    position, seed, shard count, batch size), the port's format, not
    grain's: it counts the records consumed, not those a worker has
    prefetched, so :meth:`~GrainTrainIterator.set_state` resumes at the
    exact super-batch. Shards have equal sizes, so the state is the same on
    every rank and rank 0's checkpoint sidecar serves them all
    (``sgg_torch.train.checkpoint.CheckpointManager.save(...,
    data_state=...)``).
"""

from __future__ import annotations

import copy
import itertools
import json
import time

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, get_worker_info

RECORD_SEED_STRIDE = 1_000_003


def shard_bounds(num_records: int, shard_index: int, shard_count: int) -> tuple[int, int]:
    """[start, end) of a shard: grain's ``even_split`` with ``drop_remainder``."""
    per = num_records // shard_count
    return per * shard_index, per * (shard_index + 1)


class RecordSource(Dataset):
    """Record ``i``: image ``i`` and one of its triples, chosen by its own
    seeded ``RandomState``. Tracks the host's decode time for the stats that
    each batch carries back."""

    def __init__(self, dataset, seed: int):
        self.dataset, self.seed = dataset, int(seed)
        self._mark = self._decode_totals()
        self._shared = None  # the dataset as a worker receives it, made once

    def __getstate__(self) -> dict:
        """Pickled for a worker: the dataset's in-memory store (``features``
        or ``images``) travels as a shared-memory tensor, a file descriptor,
        not as its bytes through the worker's pipe."""
        if self._shared is None:
            ds = copy.copy(self.dataset)
            for name in ("features", "images"):
                a = getattr(ds, name, None)
                if isinstance(a, np.ndarray):
                    setattr(ds, name, torch.from_numpy(np.ascontiguousarray(a)).share_memory_())
            self._shared = ds
        return {**self.__dict__, "dataset": self._shared, "_shared": None}

    def __setstate__(self, state: dict) -> None:
        ds = state["dataset"]
        for name in ("features", "images"):
            if isinstance(getattr(ds, name, None), torch.Tensor):
                setattr(ds, name, getattr(ds, name).numpy())
        self.__dict__.update(state)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState((self.seed * RECORD_SEED_STRIDE + int(i)) % (2**31))
        sub = self.dataset.sample_batch(rng, np.asarray([i]), 1)
        return {k: v[0] for k, v in sub.items()}

    def _decode_totals(self) -> tuple[float, int]:
        return (float(getattr(self.dataset, "decode_seconds", 0.0)),
                int(getattr(self.dataset, "decoded_images", 0)))

    def take_decode_stats(self) -> tuple[float, int]:
        """Decode seconds and images since the last call, in this process."""
        now = self._decode_totals()
        delta = (now[0] - self._mark[0], now[1] - self._mark[1])
        self._mark = now
        return delta


class _Collate:
    """Stack a batch's records (as tensors, which workers hand back through
    shared memory) with the decode stats of the process that fetched them."""

    def __init__(self, source: RecordSource):
        self.source = source

    def __call__(self, records: list[dict]):
        info = get_worker_info()
        source = info.dataset if info is not None else self.source
        batch = {k: torch.from_numpy(np.stack([r[k] for r in records])) for k in records[0]}
        return batch, source.take_decode_stats()


class _BatchSampler:
    """Batches of ``batch_size`` record indices from an index stream (a
    finite stream's remainder dropped) until ``stopped`` is set."""

    def __init__(self, stream, batch_size: int):
        self.stream, self.batch_size = stream, batch_size
        self.stopped = False

    def __iter__(self):
        while not self.stopped:
            batch = list(itertools.islice(self.stream, self.batch_size))
            if len(batch) < self.batch_size:
                return  # a finite order's remainder is dropped
            yield batch


class GrainTrainIterator:
    """Super-batches over the record source, with state snapshots at
    super-batch granularity (``get_state`` between two ``__next__``)."""

    def __init__(self, source: RecordSource, batch_size: int, n_critic: int, seed: int,
                 shard: tuple[int, int], num_workers: int = 0, device=None, order=None):
        self.source, self.batch_size, self.n_sub = source, batch_size, n_critic + 1
        self.device = None if device is None else torch.device(device)
        self.seed, self.shard, self.num_workers, self.order = seed, shard, num_workers, order
        self.start, self.end = shard_bounds(len(source), *shard)
        if self.end <= self.start:
            raise ValueError(f"process {shard[0]} of {shard[1]} got an empty grain shard "
                             f"({len(source)} records)")
        self.consumed = 0  # records handed out, in whole super-batches
        self.decode_seconds, self.decoded_images = 0.0, 0
        self.batches, self.wait_seconds = 0, 0.0  # super-batches handed out, time in __next__
        self._it = None

    @property
    def shard_len(self) -> int:
        return self.end - self.start

    def _stream(self, start: int):
        """Record indices from ``start`` records into the order on."""
        if self.order is not None:
            yield from itertools.islice(iter(self.order), start, None)
            return
        epoch, pos = divmod(start, self.shard_len)
        while True:
            perm = np.random.default_rng([self.seed, self.shard[0], epoch]).permutation(
                self.shard_len)
            yield from (self.start + perm[pos:]).tolist()
            epoch, pos = epoch + 1, 0

    def _loader(self):
        sampler = self._sampler = _BatchSampler(self._stream(self.consumed), self.batch_size)
        if self.num_workers > 0:
            return DataLoader(self.source, batch_sampler=sampler, num_workers=self.num_workers,
                              collate_fn=_Collate(self.source), multiprocessing_context="spawn")
        return DataLoader(self.source, batch_sampler=sampler, collate_fn=_Collate(self.source))

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        """The next super-batch: numpy arrays, or tensors on ``device``."""
        t0 = time.perf_counter()
        if self._it is None:
            self._it = iter(self._loader())
        subs = []
        for _ in range(self.n_sub):
            batch, (secs, images) = next(self._it)
            self.decode_seconds += secs
            self.decoded_images += images
            subs.append(batch)
        self.consumed += self.n_sub * self.batch_size
        out = {k: np.stack([s[k].numpy() for s in subs]) for k in subs[0]}
        if self.device is not None:
            out = {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}
        self.batches += 1
        self.wait_seconds += time.perf_counter() - t0
        return out

    def get_state(self) -> bytes:
        epoch, position = divmod(self.consumed, self.shard_len)
        return json.dumps({"epoch": epoch, "position": position, "seed": self.seed,
                           "shard_count": self.shard[1], "batch_size": self.batch_size},
                          sort_keys=True).encode()

    def set_state(self, state: bytes) -> None:
        s = json.loads(state)
        mine = {"seed": self.seed, "shard_count": self.shard[1], "batch_size": self.batch_size}
        theirs = {k: s.get(k) for k in mine}
        if theirs != mine:
            raise ValueError(f"grain iterator state {theirs} does not fit this iterator {mine}")
        self.close()
        self.consumed = int(s["epoch"]) * self.shard_len + int(s["position"])

    def close(self) -> None:
        """Stop the worker processes (a later ``__next__`` starts new ones).
        The batches the workers were asked for are drained first, so that
        each worker is idle when it exits: a worker that exits while it hands
        a tensor back through shared memory aborts (torch 2.11 and 2.13)."""
        it, self._it = self._it, None
        if it is not None and self.num_workers > 0:
            self._sampler.stopped = True
            for _ in it:  # the iterator shuts its workers down once drained
                pass


def make_grain_iterator(dataset, batch_size: int, n_critic: int, seed: int = 0,
                        process_index: int = 0, process_count: int = 1, num_workers: int = 0,
                        device=None, order=None) -> GrainTrainIterator:
    """The grain loader over a ``TripleDataset`` or an image dataset: the
    super-batches of this process's shard (see the module's docstring), as
    numpy arrays, or with ``device`` as tensors there. ``order``, when given,
    is the shard's record index order (re-iterable, so that ``set_state`` can
    skip into it)."""
    return GrainTrainIterator(RecordSource(dataset, seed), batch_size, n_critic, seed,
                              (process_index, process_count), num_workers, device, order)
