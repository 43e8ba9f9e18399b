"""In-memory image datasets for the pixels-in (encoder) configs, from
``sgg/data/images.py``. Only ``ArrayImageTripleDataset`` is ported; the
path-backed ``ImageTripleDataset`` (JPEG decode) and predicate balance come
with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sgg_torch.data.pipeline import refuse_weights, sample_rows


@dataclass
class ArrayImageTripleDataset:
    """uint8 images [N, H, W, 3] beside each image's int32 triples [n_i, 3]."""

    images: np.ndarray
    triples: list[np.ndarray] | np.ndarray

    def __post_init__(self):
        if isinstance(self.triples, np.ndarray) and self.triples.ndim == 3:
            self.triples = [t for t in self.triples]
        if len(self.triples) != self.images.shape[0]:
            raise ValueError(f"{self.images.shape[0]} images but {len(self.triples)} "
                             "triple lists")

    def __len__(self) -> int:
        return self.images.shape[0]

    def process_slice(self, process_index: int, process_count: int) -> np.ndarray:
        return np.arange(len(self))[process_index::process_count]

    def sample_batch(self, rng: np.random.RandomState, indices: np.ndarray,
                     batch_size: int) -> dict:
        refuse_weights(self)
        images, trip = sample_rows(self.images, self.triples, rng, indices, batch_size)
        return {"images": images, "triples": trip}
