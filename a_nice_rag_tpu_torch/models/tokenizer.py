"""Hashing tokenizer: hermetic text -> token ids (a copy of the JAX
package's ``models/tokenizer.py``, which imports no jax).

A deterministic feature-hashing tokenizer (word pieces hashed into a
fixed id space) so the on-device models run with zero external
vocabulary files. Real deployments can swap in a cached HF tokenizer; the
model code only sees int arrays either way.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class HashingTokenizer:
    def __init__(self, vocab_size: int = 32768, max_len: int = 128):
        # id 0 is reserved for padding.
        self.vocab_size = vocab_size
        self.max_len = max_len

    def _hash(self, piece: str) -> int:
        digest = hashlib.blake2s(piece.encode("utf-8"), digest_size=4).digest()
        return 1 + int.from_bytes(digest, "little") % (self.vocab_size - 1)

    def encode(self, text: str) -> List[int]:
        pieces = _TOKEN_RE.findall(text.lower())[: self.max_len]
        return [self._hash(p) for p in pieces]

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.max_len), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
        return out

    def encode_pairs(
        self, queries: Sequence[str], documents: Sequence[str]
    ) -> np.ndarray:
        """[query ; SEP ; document] sequences for the cross-encoder."""
        sep = self.vocab_size - 1
        out = np.zeros((len(queries), self.max_len), np.int32)
        for i, (q, d) in enumerate(zip(queries, documents)):
            q_ids = self.encode(q)[: self.max_len // 3]
            d_ids = self.encode(d)[: self.max_len - len(q_ids) - 1]
            ids = q_ids + [sep] + d_ids
            out[i, : len(ids)] = ids
        return out
