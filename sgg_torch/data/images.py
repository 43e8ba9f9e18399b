"""In-memory image datasets for the pixels-in (encoder) configs, from
``sgg/data/images.py``. Only ``ArrayImageTripleDataset`` is ported, as far as
generate reads it; the path-backed ``ImageTripleDataset`` (JPEG decode) and
the training samplers come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
