"""sgg_torch.data — vocab, feature shards and datasets for the port."""

from sgg_torch.data.images import ArrayImageTripleDataset
from sgg_torch.data.pipeline import TripleDataset
from sgg_torch.data.shards import list_shards, read_feature_shard, write_feature_shard
from sgg_torch.data.synthetic import synthetic_dataset
from sgg_torch.data.vocab import Vocab

__all__ = [
    "ArrayImageTripleDataset",
    "TripleDataset",
    "Vocab",
    "list_shards",
    "read_feature_shard",
    "synthetic_dataset",
    "write_feature_shard",
]
