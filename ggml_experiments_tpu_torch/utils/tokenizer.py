"""Character tokenizer for the Shakespeare GRU model.

The 66-char vocabulary is the sorted unique charset of the Shakespeare corpus
prefixed with TF StringLookup's specials: index 0 = '\\t' stands in for
unknown characters (unknown chars map to id 0).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

import numpy as np

SHAKESPEARE_VOCAB = (
    "\t\n !$&',-.3:;?ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
)


@dataclasses.dataclass(frozen=True)
class CharTokenizer:
    vocab: str = SHAKESPEARE_VOCAB

    @classmethod
    def from_corpus(cls, text: str, specials: str = "\t\n") -> "CharTokenizer":
        """Sorted unique chars of ``text`` with ``specials`` pinned to the
        front (id 0 = unknown fallback)."""
        chars = sorted(set(text) - set(specials))
        return cls(vocab=specials + "".join(chars))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> List[int]:
        c2i = {c: i for i, c in enumerate(self.vocab)}
        return [c2i.get(c, 0) for c in text]

    def decode(self, ids: Iterable[int]) -> str:
        return "".join(self.vocab[i] for i in ids)

    def encode_batch(self, texts: Sequence[str], pad_to: int | None = None):
        """Encode + left-align pad with id 0; returns (ids, lengths) numpy arrays."""
        encoded = [self.encode(t) for t in texts]
        max_len = pad_to or max((len(e) for e in encoded), default=0)
        out = np.zeros((len(texts), max_len), np.int32)
        lengths = np.zeros((len(texts),), np.int32)
        for i, e in enumerate(encoded):
            e = e[:max_len]
            out[i, : len(e)] = e
            lengths[i] = len(e)
        return out, lengths
