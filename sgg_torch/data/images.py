"""Image datasets for the pixels-in (encoder) configs, and the
predicate-balance weights every dataset shares, from ``sgg/data/images.py``.

``ImageTripleDataset`` (``:50-135``) holds image paths beside their triples
and decodes JPEGs as batches are drawn (``sgg_torch.data.extract.load_batch``,
the native loader's threads), with a cache of decoded images that fills up to
``cache_images`` and then stays as it is. ``materialize`` decodes the whole
corpus once into an ``ArrayImageTripleDataset``, the in-memory form the
device-resident iterators take; the train CLI does so when ``est_bytes`` fits
``data.device_resident_max_bytes``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from sgg_torch.data.pipeline import sample_indices, sample_rows


def compute_triple_weights(triples, alpha: float):
    """Per-image triple weights ∝ global-predicate-frequency^(−alpha), the
    long-tail resampling lever: a list of float64[n_i] rows, each summing to
    1, or None when alpha ≤ 0."""
    if alpha <= 0:
        return None
    freq = np.zeros(0, np.int64)
    for t in triples:
        p = np.asarray(t)[:, 1]
        if p.size and p.max() >= freq.size:
            freq = np.concatenate(
                [freq, np.zeros(int(p.max()) + 1 - freq.size, np.int64)]
            )
        np.add.at(freq, p, 1)
    w_pred = np.where(freq > 0, freq.astype(np.float64), 1.0) ** -alpha
    return [
        (lambda w: w / w.sum())(w_pred[np.asarray(t)[:, 1]]) for t in triples
    ]


@dataclass
class ImageTripleDataset:
    """(image path, triples) pairs; decodes lazily, with a cache of decoded
    images. ``decode_seconds`` and ``decoded_images`` add up the host's decode
    time and count as batches are drawn."""

    paths: list[str]
    triples: list[np.ndarray]
    image_size: int = 224
    cache_images: int = 0  # decoded images to keep (0 = no cache)
    triple_weights: list | None = None  # set by set_predicate_balance()

    def __post_init__(self):
        if len(self.paths) != len(self.triples):
            raise ValueError(f"{len(self.paths)} paths but {len(self.triples)} triple lists")
        self._cache: dict[int, np.ndarray] = {}
        self.decode_seconds = 0.0
        self.decoded_images = 0

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def est_bytes(self) -> int:
        """The decoded corpus's size (uint8 HWC): the device-residency gate."""
        return len(self.paths) * self.image_size * self.image_size * 3

    def set_predicate_balance(self, alpha: float) -> "ImageTripleDataset":
        self.triple_weights = compute_triple_weights(self.triples, alpha)
        return self

    def _decode(self, paths: list[str]) -> np.ndarray:
        from sgg_torch.data.extract import load_batch

        t0 = time.perf_counter()
        out = load_batch(paths, self.image_size)
        self.decode_seconds += time.perf_counter() - t0
        self.decoded_images += len(paths)
        return out

    def materialize(self, log=None, chunk: int = 512) -> "ArrayImageTripleDataset":
        """Decode every image once into an in-memory uint8 array, ``chunk``
        images at a time (a line to ``log`` every 20 chunks)."""
        n = len(self.paths)
        out = np.empty((n, self.image_size, self.image_size, 3), np.uint8)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            out[lo:hi] = self._decode(self.paths[lo:hi])
            if log and (lo // chunk) % 20 == 0:
                log(f"[sgg.data] materialize: {hi}/{n} images decoded")
        return ArrayImageTripleDataset(images=out, triples=self.triples,
                                       triple_weights=self.triple_weights)

    def process_slice(self, process_index: int, process_count: int) -> np.ndarray:
        return np.arange(len(self))[process_index::process_count]

    def sample_batch(self, rng: np.random.RandomState, indices: np.ndarray,
                     batch_size: int) -> dict:
        """The reference's draws (``batch_size`` images, then one triple
        each), the images decoded unless all of them are cached."""
        img_idx, trip = sample_indices(self.triples, rng, indices, batch_size,
                                       self.triple_weights)
        if all(int(i) in self._cache for i in img_idx):
            images = np.stack([self._cache[int(i)] for i in img_idx])
        else:
            images = self._decode([self.paths[int(i)] for i in img_idx])
            if self.cache_images:
                for j, i in enumerate(img_idx):
                    if len(self._cache) < self.cache_images:
                        self._cache[int(i)] = images[j]
        return {"images": images, "triples": trip}


@dataclass
class ArrayImageTripleDataset:
    """uint8 images [N, H, W, 3] beside each image's int32 triples [n_i, 3]."""

    images: np.ndarray
    triples: list[np.ndarray] | np.ndarray
    triple_weights: list | None = None  # set by set_predicate_balance()

    def __post_init__(self):
        if isinstance(self.triples, np.ndarray) and self.triples.ndim == 3:
            self.triples = [t for t in self.triples]
        if len(self.triples) != self.images.shape[0]:
            raise ValueError(f"{self.images.shape[0]} images but {len(self.triples)} "
                             "triple lists")

    def __len__(self) -> int:
        return self.images.shape[0]

    def set_predicate_balance(self, alpha: float) -> "ArrayImageTripleDataset":
        self.triple_weights = compute_triple_weights(self.triples, alpha)
        return self

    def process_slice(self, process_index: int, process_count: int) -> np.ndarray:
        return np.arange(len(self))[process_index::process_count]

    def sample_batch(self, rng: np.random.RandomState, indices: np.ndarray,
                     batch_size: int) -> dict:
        images, trip = sample_rows(self.images, self.triples, rng, indices, batch_size,
                                   self.triple_weights)
        return {"images": images, "triples": trip}
