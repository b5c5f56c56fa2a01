"""Generate reference-format on-disk artifacts from a synthetic corpus.

The reference deployment persists per-model SQLite chunk DBs
(reference src/processing/embed_chunks.py — table ``chunks(id, content,
source, embedding[, url])`` with float32-blob embeddings), a
``rank_bm25.BM25Okapi`` pickle (src/processing/bm25_search.py:82-93:
``{bm25, sections, section_ids, config}``), per-model query-embedding
DBs (table ``queries(id, query, query_embedding)``) and a preprocessed
BM25 query CSV. Its real databases are not redistributable, so this
module writes the same formats from a :func:`synth_corpus` — the §6.1
replay CLI (`evals.replay_reference`) is tested end-to-end against it.

Counterpart of ``a_nice_rag_tpu/testing/reference_fixture.py``: the same
files, with the port's ``GoldenBm25Okapi`` and ``_Document`` in the
pickle, which either package's importer reads through its stub
unpickler.
"""

from __future__ import annotations

import csv
import os
import pickle
import sqlite3
from dataclasses import dataclass
from typing import Dict

import numpy as np

from a_nice_rag_tpu_torch.testing.golden import GoldenBm25Okapi
from a_nice_rag_tpu_torch.testing.synth import SynthCorpus


@dataclass
class ReferenceFixture:
    """Paths of the generated reference-format artifacts."""

    chunk_dbs: Dict[str, str]  # model -> sqlite path
    bm25_pickle: str
    query_dbs: Dict[str, str]  # model -> sqlite path
    bm25_queries_csv: str


class _Document:
    """langchain-Document stand-in: page_content + metadata, pickled so
    the loader's stub unpickler reconstructs the same attributes."""

    def __init__(self, page_content: str, metadata: Dict):
        self.page_content = page_content
        self.metadata = metadata


def write_chunk_db(path: str, ids, contents, sources, urls,
                   embeddings: np.ndarray) -> None:
    conn = sqlite3.connect(path)
    try:
        conn.execute(
            "CREATE TABLE chunks "
            "(id TEXT, content TEXT, source TEXT, embedding BLOB, url TEXT)"
        )
        for i, cid in enumerate(ids):
            conn.execute(
                "INSERT INTO chunks VALUES (?,?,?,?,?)",
                (cid, contents[i], sources[i],
                 np.asarray(embeddings[i], np.float32).tobytes(), urls[i]),
            )
        conn.commit()
    finally:
        conn.close()


def write_query_db(path: str, ids, queries, embeddings: np.ndarray) -> None:
    conn = sqlite3.connect(path)
    try:
        conn.execute(
            "CREATE TABLE queries (id TEXT, query TEXT, query_embedding BLOB)"
        )
        for i, qid in enumerate(ids):
            conn.execute(
                "INSERT INTO queries VALUES (?,?,?)",
                (qid, queries[i],
                 np.asarray(embeddings[i], np.float32).tobytes()),
            )
        conn.commit()
    finally:
        conn.close()


def write_bm25_pickle(path: str, token_lists, section_ids, contents,
                      sources, k1: float = 1.7, b: float = 0.83,
                      epsilon: float = 0.05) -> None:
    """Persist the reference's BM25 payload shape. GoldenBm25Okapi is
    rank_bm25-attribute-compatible (idf/doc_len/corpus_size/avgdl/
    doc_freqs/k1/b/epsilon), so the import path reads it exactly as it
    reads a real BM25Okapi (via its stub unpickler)."""
    bm25 = GoldenBm25Okapi(token_lists, k1=k1, b=b, epsilon=epsilon)
    sections = [
        _Document(contents[i], {"source": sources[i]})
        for i in range(len(section_ids))
    ]
    payload = {
        "bm25": bm25,
        "sections": sections,
        "section_ids": list(section_ids),
        "config": {"k1": k1, "b": b, "epsilon": epsilon},
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def write_tokens_queries_csv(path: str, qids, token_lists) -> None:
    """Token lists as Python literals of plain ``str``. (numpy >= 2
    writes a ``numpy.str_`` token, as synth_corpus draws them, as
    ``np.str_('term1')``, which the reader's ``ast.literal_eval`` rejects:
    every query would reach BM25 with no terms.)"""
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["id", "tokens_lemmatized"])
        w.writeheader()
        for qid, toks in zip(qids, token_lists):
            w.writerow({"id": qid,
                        "tokens_lemmatized": repr([str(t) for t in toks])})


def write_reference_fixture(dirpath: str, corpus: SynthCorpus,
                            bm25_subset_stride: int = 1) -> ReferenceFixture:
    """Write every reference-format artifact for ``corpus``.

    ``bm25_subset_stride > 1`` drops documents from the BM25 pickle
    (the reference indexes only its non-empty-token subset, so the
    pickle's row space differs from the chunk DB's — keep some mismatch
    to exercise the row remapping in import_reference).
    """
    os.makedirs(dirpath, exist_ok=True)
    chunk_dbs, query_dbs = {}, {}
    for model, emb in corpus.embeddings.items():
        p = os.path.join(dirpath, f"chunks_{model.replace('/', '_')}.db")
        write_chunk_db(p, corpus.ids, corpus.contents, corpus.sources,
                       corpus.urls, emb)
        chunk_dbs[model] = p
        qp = os.path.join(dirpath, f"queries_{model.replace('/', '_')}.db")
        write_query_db(qp, corpus.gold_ids,
                       [" ".join(t) for t in corpus.query_tokens],
                       corpus.query_embeddings[model])
        query_dbs[model] = qp

    keep = list(range(0, len(corpus.ids), bm25_subset_stride))
    pkl = os.path.join(dirpath, "bm25_index.pkl")
    write_bm25_pickle(
        pkl,
        [corpus.tokens[i] for i in keep],
        [corpus.ids[i] for i in keep],
        [corpus.contents[i] for i in keep],
        [corpus.sources[i] for i in keep],
    )
    qcsv = os.path.join(dirpath, "queries_bm25_preprocessed.csv")
    write_tokens_queries_csv(qcsv, corpus.gold_ids, corpus.query_tokens)
    return ReferenceFixture(
        chunk_dbs=chunk_dbs, bm25_pickle=pkl, query_dbs=query_dbs,
        bm25_queries_csv=qcsv,
    )
