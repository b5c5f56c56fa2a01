"""Synthetic corpora for the port's tests and benchmark.

A copy of ``SynthCorpus``, ``_unit`` and ``synth_corpus`` from the JAX
package's ``testing/synth.py``, kept in the port so that it imports
nothing of that package. The draws are numpy's, in the same order, so
the same arguments give the same corpus byte for byte (held by
``tests/test_torch_bench.py``): unit-norm embedding matrices with
planted nearest neighbours, and Zipf-ish token corpora with
guideline-style sources and ids (``{guideline}_{section}`` ids,
``CG``/``NG``/``QS`` source prefixes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SynthCorpus:
    ids: List[str]
    sources: List[str]
    contents: List[str]
    urls: List[str]
    tokens: List[List[str]]  # lemmatized-style token lists
    embeddings: Dict[str, np.ndarray]  # model name -> [N, D] unit-norm f32
    query_tokens: List[List[str]]
    query_embeddings: Dict[str, np.ndarray]  # model name -> [Q, D]
    gold_ids: List[str]  # gold chunk id per query
    # Raw query TEXTS, when generated with their own (richer) channel.
    # The reference's BM25 sees lossy preprocessed/lemmatized tokens
    # while its rerank + embedding APIs see the raw question text
    # (src/search_engine.py:161-203 vs preprocess_bm25.py) — so the
    # synthetic world mirrors that: ``query_tokens`` is the short noisy
    # BM25 channel, ``query_texts`` (optional) a longer, cleaner draw
    # from the same gold document. None -> callers fall back to
    # " ".join(query_tokens).
    query_texts: Optional[List[str]] = None

    def texts(self) -> List[str]:
        if self.query_texts is not None:
            return self.query_texts
        return [" ".join(t) for t in self.query_tokens]


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def synth_corpus(
    n_docs: int = 500,
    dim: int = 256,
    n_queries: int = 64,
    vocab_size: int = 800,
    seed: int = 0,
    models: Optional[List[str]] = None,
    prefixes: Optional[List[str]] = None,
    model_noise: Optional[Dict[str, float]] = None,
    query_token_noise: float = 0.0,
    query_len_range: Optional[tuple] = None,
    query_text_len_range: Optional[tuple] = None,
    query_text_noise: float = 0.0,
) -> SynthCorpus:
    """Build a synthetic corpus where query q's gold document is doc q.

    Query embeddings are a noisy copy of their gold document embedding,
    and query tokens are sampled from the gold document's tokens, so both
    dense and BM25 retrieval have a meaningful signal to find.

    ``model_noise`` gives each dense model its own query-noise scale
    (default: 0.25 for every model — the historical stream, byte-stable
    for seeded benchmark corpora). ``query_token_noise`` replaces that
    fraction of each query's tokens with global Zipf draws, degrading the
    BM25 signal independently of the dense noise. Together they let a
    sweep reproduce the reference's qualitative §6.1 structure (dense
    models spread, dense > BM25, hybrid >= best single) instead of four
    statistically identical models (the JAX package's
    ``calibrated_quality_corpus``).
    """
    rng = np.random.default_rng(seed)
    n_queries = min(n_queries, n_docs)
    models = models or ["voyage-3-large"]
    prefixes = prefixes or ["CG", "NG", "QS"]

    vocab = [f"term{i}" for i in range(vocab_size)]
    # Zipf-distributed token draws give realistic df skew.
    zipf_p = 1.0 / np.arange(1, vocab_size + 1)
    zipf_p /= zipf_p.sum()

    ids, sources, contents, urls, tokens = [], [], [], [], []
    # Per-doc rng.choice over the string vocab rebuilds the 20k-entry
    # CDF per call (minutes at 100k+ docs); past a size threshold draw
    # ALL token indices in one vectorized call. The small-corpus path
    # keeps its original RNG stream so seeded benchmark corpora (and
    # their asserted planted-gold floors) are byte-identical.
    big = n_docs > 50_000
    if big:
        lengths = rng.integers(20, 120, size=n_docs)
        draws = rng.choice(vocab_size, size=int(lengths.sum()), p=zipf_p)
        offsets = np.concatenate([[0], np.cumsum(lengths)])
    for i in range(n_docs):
        prefix = prefixes[i % len(prefixes)]
        source = f"{prefix}{i // 7 + 1}"
        ids.append(f"{source}_Section {i}")
        sources.append(source)
        urls.append(f"https://www.nice.org.uk/guidance/{source.lower()}")
        if big:
            toks = [vocab[t] for t in draws[offsets[i]:offsets[i + 1]]]
        else:
            length = int(rng.integers(20, 120))
            toks = list(rng.choice(vocab, size=length, p=zipf_p))
        tokens.append(toks)
        contents.append(" ".join(toks))

    embeddings = {
        m: _unit(rng.standard_normal((n_docs, dim)).astype(np.float32))
        for m in models
    }

    q_idx = rng.permutation(n_docs)[:n_queries]
    gold_ids = [ids[j] for j in q_idx]
    query_embeddings = {}
    for m in models:
        scale = 0.25 if model_noise is None else model_noise.get(m, 0.25)
        noise = scale * rng.standard_normal((n_queries, dim)).astype(np.float32)
        query_embeddings[m] = _unit(embeddings[m][q_idx] + noise)
    query_tokens = []
    for j in q_idx:
        doc_toks = tokens[j]
        lo, hi = query_len_range or (3, 9)
        take = min(len(doc_toks), int(rng.integers(lo, hi)))
        q_toks = list(rng.choice(doc_toks, size=take))
        if query_token_noise > 0.0:
            flips = rng.random(take) < query_token_noise
            noise_toks = rng.choice(vocab, size=take, p=zipf_p)
            q_toks = [
                noise_toks[t] if flips[t] else q_toks[t]
                for t in range(take)
            ]
        query_tokens.append(q_toks)

    # Raw-text channel (separate child stream so enabling it never
    # perturbs the byte-stable token/embedding draws above).
    query_texts = None
    if query_text_len_range is not None:
        trng = np.random.default_rng(seed + 777)
        query_texts = []
        tlo, thi = query_text_len_range
        for j in q_idx:
            doc_toks = tokens[j]
            take = min(len(doc_toks), int(trng.integers(tlo, thi)))
            t_toks = list(trng.choice(doc_toks, size=take))
            if query_text_noise > 0.0:
                flips = trng.random(take) < query_text_noise
                noise_toks = trng.choice(vocab, size=take, p=zipf_p)
                t_toks = [
                    noise_toks[t] if flips[t] else t_toks[t]
                    for t in range(take)
                ]
            query_texts.append(" ".join(t_toks))

    return SynthCorpus(
        ids=ids,
        sources=sources,
        contents=contents,
        urls=urls,
        tokens=tokens,
        embeddings=embeddings,
        query_tokens=query_tokens,
        query_embeddings=query_embeddings,
        gold_ids=gold_ids,
        query_texts=query_texts,
    )
