"""Golden reference algorithms (pure NumPy / pure Python; a copy of the
JAX package's ``testing/golden.py``, which imports no jax).

These replicate the exact semantics of the reference system's retrieval
math so the port can be parity-tested on fixtures:

* dense top-k: np.dot + argpartition ordering (src/search_engine.py:80-92)
* BM25 Okapi with rank_bm25's epsilon-floored IDF, implemented from the
  published Okapi formula (the behavior behind src/search_engine.py:219)
* weighted reciprocal-rank fusion with dict accumulation and stable sort
  (src/search_engine.py:21-34)

They are intentionally slow and simple — they exist to be obviously
correct, not fast.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def golden_dense_top_k(
    emb: np.ndarray, query: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference dense search for one query: (scores desc, indices)."""
    sims = np.dot(query.reshape(1, -1), emb.T).flatten()
    if len(sims) > k:
        idx = np.argpartition(sims, -k)[-k:]
        idx = idx[sims[idx].argsort()[::-1]]
    else:
        idx = sims.argsort()[::-1]
    return sims[idx], idx


class GoldenBm25Okapi:
    """Okapi BM25 with epsilon-floored IDF (rank_bm25-compatible numerics).

    score(q, d) = sum over query-term occurrences t of
        idf(t) * tf(t,d) * (k1+1) / (tf(t,d) + k1 * (1 - b + b * dl_d/avgdl))
    idf(t) = ln((N - df + 0.5) / (df + 0.5)); any negative idf is replaced
    by epsilon * mean(raw idf over vocabulary).
    """

    def __init__(
        self,
        corpus: Sequence[Sequence[str]],
        k1: float = 1.7,
        b: float = 0.83,
        epsilon: float = 0.05,
    ):
        self.k1, self.b, self.epsilon = k1, b, epsilon
        self.corpus_size = len(corpus)
        self.doc_len = np.array([len(doc) for doc in corpus], dtype=np.float64)
        self.avgdl = float(self.doc_len.sum()) / self.corpus_size
        # term -> {doc index -> term frequency}
        self.doc_freqs: List[Dict[str, int]] = []
        df: Dict[str, int] = defaultdict(int)
        for doc in corpus:
            freqs: Dict[str, int] = defaultdict(int)
            for tok in doc:
                freqs[tok] += 1
            self.doc_freqs.append(dict(freqs))
            for tok in freqs:
                df[tok] += 1
        self.idf: Dict[str, float] = {}
        idf_sum = 0.0
        negative = []
        for word, freq in df.items():
            idf = math.log(self.corpus_size - freq + 0.5) - math.log(freq + 0.5)
            self.idf[word] = idf
            idf_sum += idf
            if idf < 0:
                negative.append(word)
        self.average_idf = idf_sum / len(self.idf)
        eps = self.epsilon * self.average_idf
        for word in negative:
            self.idf[word] = eps

    def get_scores(self, query: Sequence[str]) -> np.ndarray:
        score = np.zeros(self.corpus_size, dtype=np.float64)
        denom_base = self.k1 * (1 - self.b + self.b * self.doc_len / self.avgdl)
        for q in query:
            q_freq = np.array(
                [doc.get(q, 0) for doc in self.doc_freqs], dtype=np.float64
            )
            score += (self.idf.get(q) or 0.0) * (
                q_freq * (self.k1 + 1) / (q_freq + denom_base)
            )
        return score


def golden_wrrf(
    ranked_lists: List[Tuple[List[str], str]],
    model_weights: Dict[str, float],
    k: int = 50,
) -> List[Tuple[str, float]]:
    """Reference weighted RRF: dict accumulation, stable descending sort."""
    rrf_scores: Dict[str, float] = defaultdict(float)
    for ranked_list, model_name in ranked_lists:
        weight = model_weights.get(model_name, 1.0)
        for rank, doc_id in enumerate(ranked_list, start=1):
            rrf_scores[doc_id] += weight * (1.0 / (k + rank))
    return sorted(rrf_scores.items(), key=lambda x: x[1], reverse=True)
