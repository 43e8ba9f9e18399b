"""In-memory image datasets for the pixels-in (encoder) configs, and the
predicate-balance weights every dataset shares, from ``sgg/data/images.py``.
Only ``ArrayImageTripleDataset`` is ported; the path-backed
``ImageTripleDataset`` (JPEG decode) comes with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sgg_torch.data.pipeline import sample_rows


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
