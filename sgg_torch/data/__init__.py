"""sgg_torch.data — VG parsing, vocab, feature shards and datasets for the port."""

from sgg_torch.data.images import ArrayImageTripleDataset, ImageTripleDataset
from sgg_torch.data.pipeline import TripleDataset
from sgg_torch.data.shards import list_shards, read_feature_shard, write_feature_shard
from sgg_torch.data.synthetic import synthetic_dataset, synthetic_vg_json
from sgg_torch.data.vg import (
    ImageTriples,
    build_vocab_from_relationships,
    filter_and_encode,
    parse_entity_boxes,
    parse_relationships,
    train_test_split,
)
from sgg_torch.data.vocab import Vocab, normalize_name

__all__ = [
    "ArrayImageTripleDataset",
    "ImageTripleDataset",
    "ImageTriples",
    "TripleDataset",
    "Vocab",
    "build_vocab_from_relationships",
    "filter_and_encode",
    "list_shards",
    "normalize_name",
    "parse_entity_boxes",
    "parse_relationships",
    "read_feature_shard",
    "synthetic_dataset",
    "synthetic_vg_json",
    "train_test_split",
    "write_feature_shard",
]
