"""Token vocabulary over Visual Genome objects and predicates.

A copy of ``sgg/data/vocab.py`` (framework-free), kept in the port so that
``sgg_torch`` imports nothing of ``sgg``. Objects and predicates share one id
space; the vocab records which ids are which, so each decode step can be
masked to its legal sub-vocabulary. One JSON file serializes it.
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

# Reserved ids. <pad> is id 0 so zero-padding is a no-op token.
PAD = "<pad>"
UNK = "<unk>"
SPECIALS = (PAD, UNK)


@dataclass
class Vocab:
    """Bidirectional token↔id map with object/predicate typing.

    Attributes:
      tokens: id → token string. ``tokens[0] == "<pad>"``, ``tokens[1] == "<unk>"``.
      is_object: bool per id — True if the token appears as a subject/object.
      is_predicate: bool per id — True if the token appears as a predicate.
        (A token may be both; specials are neither.)
    """

    tokens: list[str]
    is_object: list[bool]
    is_predicate: list[bool]
    _ids: dict[str, int] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not self._ids:
            self._ids = {t: i for i, t in enumerate(self.tokens)}

    # ------------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        object_counts: Counter | dict[str, int],
        predicate_counts: Counter | dict[str, int],
        max_objects: int | None = None,
        max_predicates: int | None = None,
        min_count: int = 1,
    ) -> "Vocab":
        """Top-N frequency cut over objects and predicates, one shared id space."""

        def top(counts, n):
            items = [
                (t, c) for t, c in counts.items() if c >= min_count and t not in SPECIALS
            ]
            # Sort by (-count, token) for a deterministic id assignment.
            items.sort(key=lambda kv: (-kv[1], kv[0]))
            if n is not None:
                items = items[:n]
            return [t for t, _ in items]

        objs = top(object_counts, max_objects)
        preds = top(predicate_counts, max_predicates)

        tokens = list(SPECIALS)
        is_object = [False, False]
        is_predicate = [False, False]
        seen = {t: i for i, t in enumerate(tokens)}
        for t in objs:
            seen[t] = len(tokens)
            tokens.append(t)
            is_object.append(True)
            is_predicate.append(False)
        for t in preds:
            if t in seen:  # token used as both object and predicate
                is_predicate[seen[t]] = True
            else:
                seen[t] = len(tokens)
                tokens.append(t)
                is_object.append(False)
                is_predicate.append(True)
        return cls(tokens=tokens, is_object=is_object, is_predicate=is_predicate)

    # ----------------------------------------------------------------- lookup
    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def pad_id(self) -> int:
        return 0

    @property
    def unk_id(self) -> int:
        return 1

    def id(self, token: str) -> int:
        return self._ids.get(token, self.unk_id)

    def token(self, i: int) -> str:
        return self.tokens[i]

    def encode_triple(self, subj: str, pred: str, obj: str) -> tuple[int, int, int]:
        return (self.id(subj), self.id(pred), self.id(obj))

    def decode_triple(self, ids: Sequence[int]) -> tuple[str, str, str]:
        s, p, o = (int(i) for i in ids)
        return (self.tokens[s], self.tokens[p], self.tokens[o])

    # ------------------------------------------------------------------ masks
    def step_mask(self) -> np.ndarray:
        """``bool[3, V]`` legality mask for (subject, predicate, object) steps.

        Row 0/2 allow object tokens, row 1 allows predicate tokens. Used by the
        decoders to mask logits so generated triples are type-correct.
        """
        obj = np.asarray(self.is_object, dtype=bool)
        pred = np.asarray(self.is_predicate, dtype=bool)
        return np.stack([obj, pred, obj], axis=0)

    # -------------------------------------------------------------------- io
    def to_json(self) -> str:
        return json.dumps(
            {
                "tokens": self.tokens,
                "is_object": self.is_object,
                "is_predicate": self.is_predicate,
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "Vocab":
        d = json.loads(s)
        return cls(
            tokens=d["tokens"],
            is_object=d["is_object"],
            is_predicate=d["is_predicate"],
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            return cls.from_json(f.read())



def normalize_name(name: str) -> str:
    """Canonicalize a VG object/predicate name: lowercase, collapse whitespace."""
    return " ".join(name.lower().strip().split())
