"""Synthetic corpora for the port's tests and benchmark.

A copy of the JAX package's ``testing/synth.py`` (``SynthCorpus``,
``synth_corpus``, ``add_hard_distractors``, ``sample_queries``, the
calibrated reference-quality corpus and its noise constants), kept in
the port so that it imports nothing of that package. The draws are
numpy's, in the same order, so the same arguments give the same corpus
byte for byte (held by ``tests/test_torch_bench.py`` and
``tests/test_torch_reference_io.py``): unit-norm embedding matrices
with planted nearest neighbours, and Zipf-ish token corpora with
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
    statistically identical models — see
    ``calibrated_quality_corpus``.
    """
    rng = np.random.default_rng(seed)
    n_queries = min(n_queries, n_docs)
    models = models or ["voyage-3-large"]
    prefixes = prefixes or ["CG", "NG", "QS"]

    # One string array for every draw: rng.choice converts a list
    # argument to an array on each call (most of the time of a 10k-doc
    # corpus), while its draws depend only on the population size and p,
    # so the array gives the same tokens from the same stream.
    names = [f"term{i}" for i in range(vocab_size)]
    vocab = np.array(names)
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
            toks = [names[t] for t in draws[offsets[i]:offsets[i + 1]]]
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


def add_hard_distractors(
    corpus: SynthCorpus,
    n_per_gold: int = 2,
    emb_cos: float = 0.93,
    token_overlap: float = 0.75,
    seed: int = 7001,
) -> SynthCorpus:
    """Append near-duplicate distractor documents for every eval gold.

    Each distractor of a gold document g gets an embedding at cosine
    ~``emb_cos`` to g's (per model) and a token list sharing
    ``token_overlap`` of its draws with g — so BOTH retrieval channels
    rank it next to g and rank fusion cannot separate them; only a
    stage that reads the texts (the cross-encoder reranker) can. This
    de-saturates the synthetic rerank benchmark: without distractors
    the trained reranker hits R@1 ~0.99 and the rerank-2 vs
    rerank-2-lite tiers are indistinguishable, unlike the reference
    where they separate (results/retrieval_evaluation_results.csv
    rows 9-10: R@1 0.810 vs 0.779).

    Returns a NEW corpus; the base docs, queries, and golds are
    byte-identical to the input (distractors are appended after), so
    seeded floors on the base corpus stay valid.
    """
    rng = np.random.default_rng(seed)
    row_of = {d: i for i, d in enumerate(corpus.ids)}
    # Empty-token docs can neither anchor nor donate (rng.integers
    # over an empty range raises; an empty distractor is useless).
    gold_rows = sorted({
        row_of[g] for g in corpus.gold_ids if corpus.tokens[row_of[g]]
    })
    donor_rows = [i for i, t in enumerate(corpus.tokens) if t]
    if not donor_rows:
        raise ValueError("add_hard_distractors needs non-empty docs")
    n_base = len(corpus.ids)
    ids = list(corpus.ids)
    sources = list(corpus.sources)
    contents = list(corpus.contents)
    urls = list(corpus.urls)
    tokens = [list(t) for t in corpus.tokens]
    new_rows = []  # (victim_row,)
    i = n_base
    for g in gold_rows:
        for _ in range(n_per_gold):
            src = f"{corpus.sources[g]}D"
            ids.append(f"{src}_Section {i}")
            sources.append(src)
            urls.append(corpus.urls[g])
            gt = corpus.tokens[g]
            keep = rng.random(len(gt)) < token_overlap
            # Replacements are drawn from OTHER documents' vocabulary
            # usage (uniform over the corpus's token stream) so the
            # distractor stays in-distribution.
            donor = corpus.tokens[
                donor_rows[int(rng.integers(0, len(donor_rows)))]
            ]
            toks = [
                t if k else donor[int(rng.integers(0, len(donor)))]
                for t, k in zip(gt, keep)
            ]
            tokens.append(toks)
            contents.append(" ".join(toks))
            new_rows.append(g)
            i += 1
    embeddings = {}
    for m, emb in corpus.embeddings.items():
        g_emb = emb[np.asarray(new_rows)]
        noise = rng.standard_normal(g_emb.shape).astype(np.float32)
        # Orthogonalize the noise against the gold direction, then mix
        # at the exact target cosine.
        noise -= (noise * g_emb).sum(-1, keepdims=True) * g_emb
        noise = _unit(noise)
        d_emb = emb_cos * g_emb + np.sqrt(1.0 - emb_cos**2) * noise
        embeddings[m] = np.concatenate(
            [emb, _unit(d_emb).astype(np.float32)]
        )
    return SynthCorpus(
        ids=ids,
        sources=sources,
        contents=contents,
        urls=urls,
        tokens=tokens,
        embeddings=embeddings,
        query_tokens=corpus.query_tokens,
        query_embeddings=corpus.query_embeddings,
        gold_ids=corpus.gold_ids,
        query_texts=corpus.query_texts,
    )


# Per-model query-noise scales calibrated (scripts history, round 3) so a
# 9.7k-doc sweep reproduces the reference's qualitative §6.1 structure:
# dense MRR spread Voyage-3-Large > Voyage-3.5 > Qwen3 > TE3L, every
# dense model above BM25, and hybrid/ensemble fusion lifting R@10 above
# the best single ranker (reference
# results/retrieval_evaluation_results.csv rows 2-8).
REFERENCE_QUALITY_NOISE: Dict[str, float] = {
    "voyage-3-large": 0.235,
    "voyage-3.5": 0.247,
    "text-embedding-3-large": 0.257,
    "Qwen3": 0.250,
}
REFERENCE_QUALITY_TOKEN_NOISE: float = 0.51
REFERENCE_QUALITY_QUERY_LEN: tuple = (5, 11)
# The rerank channel: raw query text is a LONGER, CLEANER draw from the
# gold document than the preprocessed BM25 tokens — mirroring the
# reference, whose rerank/embedding APIs see the raw question while
# BM25 sees lossy lemmatized tokens. This is what gives a trained
# cross-encoder rank-1 headroom over rank fusion (reference CSV rows
# 9-10: hybrid R@1 0.699 -> rerank 0.810).
REFERENCE_QUALITY_TEXT_LEN: tuple = (12, 20)
REFERENCE_QUALITY_TEXT_NOISE: float = 0.18


def sample_queries(
    corpus: SynthCorpus,
    n_queries: int,
    vocab_size: int,
    model_noise: Optional[Dict[str, float]] = None,
    query_token_noise: float = 0.0,
    query_len_range: Optional[tuple] = None,
    query_text_len_range: Optional[tuple] = None,
    query_text_noise: float = 0.0,
    seed: int = 1234,
):
    """Draw ADDITIONAL queries from an existing corpus's documents with
    the same noise process but a fresh RNG stream.

    This is the training-data generator for learned rerank/fusion
    stages (the reference trains on its generated question DBs,
    src/question_generation.ipynb — same corpus, disjoint query draw):
    evaluation queries stay unseen while training queries share the
    corpus and the noise distribution.

    Returns ``(gold_rows, query_tokens, query_embeddings, query_texts)``
    where gold_rows indexes ``corpus.ids``/``corpus.tokens`` and
    query_texts is None unless ``query_text_len_range`` is given.
    """
    rng = np.random.default_rng(seed)
    n_docs = len(corpus.ids)
    vocab = np.array([f"term{i}" for i in range(vocab_size)])  # see synth_corpus
    zipf_p = 1.0 / np.arange(1, vocab_size + 1)
    zipf_p /= zipf_p.sum()
    models = list(corpus.embeddings)
    q_idx = rng.integers(0, n_docs, size=n_queries)
    dim = next(iter(corpus.embeddings.values())).shape[1]
    query_embeddings = {}
    for m in models:
        scale = 0.25 if model_noise is None else model_noise.get(m, 0.25)
        noise = scale * rng.standard_normal((n_queries, dim)).astype(np.float32)
        query_embeddings[m] = _unit(corpus.embeddings[m][q_idx] + noise)
    query_tokens = []
    lo, hi = query_len_range or (3, 9)
    for j in q_idx:
        doc_toks = corpus.tokens[j]
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
    query_texts = None
    if query_text_len_range is not None:
        query_texts = []
        tlo, thi = query_text_len_range
        for j in q_idx:
            doc_toks = corpus.tokens[j]
            take = min(len(doc_toks), int(rng.integers(tlo, thi)))
            t_toks = list(rng.choice(doc_toks, size=take))
            if query_text_noise > 0.0:
                flips = rng.random(take) < query_text_noise
                noise_toks = rng.choice(vocab, size=take, p=zipf_p)
                t_toks = [
                    noise_toks[t] if flips[t] else t_toks[t]
                    for t in range(take)
                ]
            query_texts.append(" ".join(t_toks))
    return q_idx.astype(np.int64), query_tokens, query_embeddings, query_texts


def calibrated_quality_corpus(
    n_docs: int = 9728,
    dim: int = 256,
    n_queries: int = 2048,
    vocab_size: int = 20000,
    seed: int = 42,
) -> SynthCorpus:
    """Reference-§6.1-shaped synthetic corpus (see REFERENCE_QUALITY_NOISE).

    Used by the committed synthetic sweep
    (results/retrieval_evaluation_results_synthetic.csv) and the quality
    -gate tests: a fusion/scoring regression that would flip the
    reference's configuration ordering flips it here too.
    """
    return synth_corpus(
        n_docs=n_docs,
        dim=dim,
        n_queries=n_queries,
        vocab_size=vocab_size,
        seed=seed,
        models=list(REFERENCE_QUALITY_NOISE),
        model_noise=dict(REFERENCE_QUALITY_NOISE),
        query_token_noise=REFERENCE_QUALITY_TOKEN_NOISE,
        query_len_range=REFERENCE_QUALITY_QUERY_LEN,
        query_text_len_range=REFERENCE_QUALITY_TEXT_LEN,
        query_text_noise=REFERENCE_QUALITY_TEXT_NOISE,
    )


def calibrated_sample_queries(
    corpus: SynthCorpus,
    n_queries: int,
    vocab_size: int = 20000,
    seed: int = 1234,
):
    """:func:`sample_queries` with the calibrated reference-§6.1 noise —
    the training-query generator matching :func:`calibrated_quality_corpus`."""
    return sample_queries(
        corpus,
        n_queries,
        vocab_size,
        model_noise=dict(REFERENCE_QUALITY_NOISE),
        query_token_noise=REFERENCE_QUALITY_TOKEN_NOISE,
        query_len_range=REFERENCE_QUALITY_QUERY_LEN,
        query_text_len_range=REFERENCE_QUALITY_TEXT_LEN,
        query_text_noise=REFERENCE_QUALITY_TEXT_NOISE,
        seed=seed,
    )
