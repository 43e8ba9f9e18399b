"""In-memory (features, triples) dataset, from ``sgg/data/pipeline.py``.

Only what inference reads is ported: the fields, ``__len__`` and
``from_shards``. The training iterators come with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sgg_torch.data.shards import read_feature_shard


@dataclass
class TripleDataset:
    """In-memory (features, triples) pairs with ragged triples per image.

    features : float[N, R, F]
    triples  : list of int32[n_i, 3] (or a dense int32[N, T, 3])
    """

    features: np.ndarray
    triples: list[np.ndarray] | np.ndarray
    # Per-triple sampling weights; only training reads them.
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
