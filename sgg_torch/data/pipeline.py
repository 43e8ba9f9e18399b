"""In-memory (features, triples) dataset and the training iterators, from
``sgg/data/pipeline.py``.

Both iterators yield *super-batches* for the train step: ``n_critic`` critic
sub-batches and one generator sub-batch, ``{'features' | 'images':
[n_critic+1, B, ...], 'triples': int32 [n_critic+1, B, 3]}``; each row is an
image and one of its triples, chosen uniformly.
  - :func:`make_train_iterator`: numpy batches on the host from
    ``RandomState(seed + 7919·process_index)``, the reference's own draws, so
    its batches are identical to ``sgg``'s; with ``prefetch > 0`` a thread
    assembles them ahead and stops when the iterator is closed.
  - :func:`make_device_train_iterator`: the whole store lives on the device
    and each super-batch is one gather, with indices from a seeded
    ``torch.Generator`` (so its batches differ from the reference's, whose
    draws are ``jax.random``'s).
Predicate-balanced triple choice, the int8 feature store, rotating subsets
and the grain loader come with a later slice.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from sgg_torch.data.shards import read_feature_shard

_LATER = "is not ported yet; a later slice of the port brings it"


def refuse_weights(dataset) -> None:
    if getattr(dataset, "triple_weights", None) is not None:
        raise NotImplementedError(f"predicate-balanced triple sampling {_LATER}")


def sample_rows(store: np.ndarray, triples: list, rng: np.random.RandomState,
                indices: np.ndarray, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(store rows, one uniformly chosen triple of each) for ``batch_size``
    images drawn from ``indices``, the reference's ``sample_batch`` draws."""
    img = indices[rng.randint(len(indices), size=batch_size)]
    pick = [triples[i][rng.randint(triples[i].shape[0])] for i in img]
    return store[img], np.stack(pick).astype(np.int32)


@dataclass
class TripleDataset:
    """In-memory (features, triples) pairs with ragged triples per image.

    features : float[N, R, F]
    triples  : list of int32[n_i, 3] (or a dense int32[N, T, 3])
    """

    features: np.ndarray
    triples: list[np.ndarray] | np.ndarray
    # Per-triple sampling weights (predicate balance); a later slice reads them.
    triple_weights: list | None = None

    def __post_init__(self):
        if isinstance(self.triples, np.ndarray) and self.triples.ndim == 3:
            self.triples = [t for t in self.triples]
        if len(self.triples) != self.features.shape[0]:
            raise ValueError(
                f"{len(self.triples)} triple lists for "
                f"{self.features.shape[0]} feature rows"
            )

    def __len__(self) -> int:
        return self.features.shape[0]

    def process_slice(self, process_index: int, process_count: int) -> np.ndarray:
        """Disjoint, covering image-index shard for this process."""
        return np.arange(len(self))[process_index::process_count]

    def sample_batch(self, rng: np.random.RandomState, indices: np.ndarray,
                     batch_size: int) -> dict:
        """(image, one of its triples) pairs, the reference's unit."""
        refuse_weights(self)
        feats, trip = sample_rows(self.features, self.triples, rng, indices, batch_size)
        return {"features": feats, "triples": trip}

    @classmethod
    def from_shards(cls, shard_paths: list[str]) -> "TripleDataset":
        """Images without triples are dropped, as in the reference."""
        feats, triples = [], []
        for p in shard_paths:
            d = read_feature_shard(p)
            n = d["features"].shape[0]
            per_image: list[list] = [[] for _ in range(n)]
            for row in d["triples"]:
                per_image[int(row[0])].append(row[1:4])
            keep = [i for i in range(n) if per_image[i]]
            feats.append(d["features"][keep])
            triples.extend(
                np.asarray(per_image[i], dtype=np.int32) for i in keep
            )
        return cls(features=np.concatenate(feats, axis=0), triples=triples)


def data_store(dataset) -> tuple[np.ndarray, str]:
    """(host array, batch key): ``features`` f32 [N, R, F] or ``images`` u8
    [N, H, W, 3]."""
    if hasattr(dataset, "features"):
        return dataset.features, "features"
    return dataset.images, "images"


def make_train_iterator(dataset, batch_size: int, n_critic: int, seed: int = 0,
                        process_index: int = 0, process_count: int = 1,
                        prefetch: int = 2) -> Iterator[dict]:
    """Infinite iterator of numpy super-batches, drawn as the reference's
    ``make_train_iterator`` draws them. Close it (``.close()``) to stop the
    prefetch thread."""
    refuse_weights(dataset)
    indices = dataset.process_slice(process_index, process_count)
    if len(indices) == 0:
        raise ValueError(f"process {process_index}/{process_count} got an empty shard "
                         f"({len(dataset)} images)")
    rng = np.random.RandomState(seed + 7919 * process_index)
    n_sub = n_critic + 1

    def host_batch() -> dict:
        subs = [dataset.sample_batch(rng, indices, batch_size) for _ in range(n_sub)]
        return {k: np.stack([s[k] for s in subs]) for k in subs[0]}

    if prefetch <= 0:
        while True:
            yield host_batch()

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            b = host_batch()
            while not stop.is_set():
                try:
                    q.put(b, timeout=0.5)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=worker, daemon=True, name="sgg-torch-data-prefetch")
    thread.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
        thread.join(timeout=10)


def make_device_train_iterator(dataset, batch_size: int, n_critic: int, seed: int = 0,
                               device: torch.device | str = "cuda") -> Iterator[dict]:
    """Device-resident iterator: the store (features, or uint8 images) and
    the dense triple table go to ``device`` once; each super-batch is one
    gather at indices drawn on the device: images uniformly, then a triple
    uniformly among the image's own."""
    refuse_weights(dataset)
    store_host, key = data_store(dataset)
    tri = dataset.triples
    T = max(t.shape[0] for t in tri)
    dense = np.zeros((len(tri), T, 3), np.int32)
    counts = np.zeros((len(tri),), np.int32)
    for j, t in enumerate(tri):
        dense[j, : t.shape[0]] = t
        counts[j] = t.shape[0]
    store = torch.from_numpy(np.ascontiguousarray(store_host)).to(device)
    dense_d = torch.from_numpy(dense).to(device)
    counts_d = torch.from_numpy(counts).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    shape, N = (n_critic + 1, batch_size), len(tri)

    def gen_batches():
        while True:
            img = torch.randint(0, N, shape, generator=gen, device=device)
            u = torch.rand(shape, generator=gen, device=device)
            tsel = (u * counts_d[img]).long()
            yield {key: store[img], "triples": dense_d[img, tsel]}

    return gen_batches()
