"""Index artifact persistence and reference-format importers.

The artifact is the same ``arrays.npz`` + ``meta.json`` directory that
``a_nice_rag_tpu.index.io`` writes and reads, so either package loads
the other's artifact.

The importers read the reference deployment's on-disk formats directly,
as the JAX package's do:

* SQLite chunk DBs ``chunks(id, content, source, embedding BLOB, url)``
  with float32 blobs (reference src/processing/create_database.py:57-66),
* SQLite query DBs ``queries(id, query, query_embedding BLOB)``
  (reference notebooks/question_generation.ipynb cell 8),
* the ``rank_bm25`` pickle, read without its dependencies by an
  allowlisting unpickler,
* preprocessed-chunk CSVs with token-list columns
  (reference src/processing/preprocess_bm25.py:55-94).

bf16 matrices saved by the JAX package come back from npz as a raw
2-byte (``V2``) dtype; they are reinterpreted as bfloat16 bit patterns.
bf16 matrices saved here are written as float32 (exact), which both
packages read.
"""

from __future__ import annotations

import ast
import json
import os
import pickle
import sqlite3
from typing import Dict, List, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device
from a_nice_rag_tpu_torch.index.array_index import (
    ArrayIndex,
    CorpusMeta,
    dense_impact_from_csr,
    torch_dtype,
)
from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays
from a_nice_rag_tpu_torch.ops.quantized import QuantizedDense

_FORMAT_VERSION = 1


def numpy_to_torch(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``; 2-byte void or ml_dtypes
    bfloat16 arrays are read as bfloat16 bit patterns."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            or arr.dtype.name == "bfloat16":
        arr = np.ascontiguousarray(arr).view(np.int16)
        bf16 = True
    else:
        bf16 = False
    # Copy read-only buffers (e.g. another framework's arrays) so the
    # tensor never aliases memory it must not write.
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)  # npz has no bfloat16; f32 is exact
    return t.cpu().numpy()


def _ivf_path(path: str, model: str) -> str:
    return os.path.join(path, f"ivf_{model.replace('/', '_')}.npz")


def save_index(index: ArrayIndex, path: str) -> None:
    from a_nice_rag_tpu_torch.index.ivf import save_ivf  # imports this module

    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for model, emb in index.dense.items():
        arrays[f"dense/{model}"] = _host(emb)
    for model, qd in (index.dense_q or {}).items():
        arrays[f"dense_q/{model}/values"] = _host(qd.values)
        arrays[f"dense_q/{model}/scales"] = _host(qd.scales)
    if index.bm25 is not None:
        arrays["bm25/indptr"] = _host(index.bm25.indptr)
        arrays["bm25/doc_ids"] = _host(index.bm25.doc_ids)
        arrays["bm25/impact"] = _host(index.bm25.impact)
        arrays["bm25/doc_mask"] = np.asarray(index.bm25_doc_mask)
    np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)
    for model, ivf in (index.ivf or {}).items():
        save_ivf(ivf, _ivf_path(path, model))
    meta = {
        "format_version": _FORMAT_VERSION,
        "n_docs": index.meta.n_docs,
        "n_docs_padded": index.meta.n_docs_padded,
        "ids": index.meta.ids,
        "sources": index.meta.sources,
        "urls": index.meta.urls,
        "contents": index.meta.contents,
        "dense_models": list(index.dense.keys()),
        "dense_q_models": list((index.dense_q or {}).keys()),
        "vocab": index.vocab,
        "bm25_stats": index.bm25_stats,
        "deleted_rows": np.flatnonzero(index.meta.deleted).tolist(),
        "ivf_models": list((index.ivf or {}).keys()),
    }
    with open(os.path.join(path, "meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f)


def load_index(
    path: str, emb_dtype: str = "float32", device: DeviceLike = "cuda"
) -> ArrayIndex:
    """Load an index artifact, IVF structures included, onto ``device``."""
    from a_nice_rag_tpu_torch.index.ivf import load_ivf  # imports this module

    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json"), "r", encoding="utf-8") as f:
        meta_d = json.load(f)
    found = meta_d.get("format_version")
    if found != _FORMAT_VERSION:
        raise ValueError(
            f"index artifact at {path} has format_version {found!r}; "
            f"this build reads version {_FORMAT_VERSION}. Rebuild the "
            "artifact with build_index + save_index."
        )
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {name: data[name] for name in data.files}
    meta = CorpusMeta(
        ids=meta_d["ids"],
        sources=meta_d["sources"],
        contents=meta_d["contents"],
        urls=meta_d["urls"],
        n_docs=meta_d["n_docs"],
        n_docs_padded=meta_d["n_docs_padded"],
    )
    for row in meta_d.get("deleted_rows", []):
        meta.deleted[row] = True
    dense = {
        m: numpy_to_torch(arrays[f"dense/{m}"], dev).to(torch_dtype(emb_dtype))
        for m in meta_d["dense_models"]
    }
    dense_q = {
        m: QuantizedDense(
            values=numpy_to_torch(arrays[f"dense_q/{m}/values"], dev),
            scales=numpy_to_torch(arrays[f"dense_q/{m}/scales"], dev),
        )
        for m in meta_d.get("dense_q_models", [])
    } or None
    bm25 = None
    bm25_doc_mask = None
    bm25_dense = None
    if "bm25/indptr" in arrays:
        bm25 = Bm25Arrays(
            indptr=numpy_to_torch(arrays["bm25/indptr"], dev),
            doc_ids=numpy_to_torch(arrays["bm25/doc_ids"], dev),
            impact=numpy_to_torch(arrays["bm25/impact"], dev),
            n_docs_padded=meta_d["n_docs_padded"],
        )
        bm25_doc_mask = arrays["bm25/doc_mask"]
        # The dense impact matrix is derived, not stored: rebuild it when
        # it fits the default memory budget (as build_index does).
        if bm25.vocab_size * meta_d["n_docs_padded"] * 4 <= (4 << 30):
            bm25_dense = dense_impact_from_csr(bm25)
    ivf = {
        m: load_ivf(_ivf_path(path, m), dev)
        for m in meta_d.get("ivf_models", [])
    } or None
    return ArrayIndex(
        meta=meta,
        dense=dense,
        bm25=bm25,
        vocab=meta_d["vocab"],
        bm25_stats=meta_d["bm25_stats"],
        bm25_doc_mask=bm25_doc_mask,
        bm25_dense=bm25_dense,
        dense_q=dense_q,
        ivf=ivf,
    )


def load_reference_chunk_db(
    db_path: str,
) -> Tuple[List[str], List[str], List[str], List[str], np.ndarray]:
    """Read a reference-format chunk DB into columnar arrays.

    Returns (ids, contents, sources, urls, embeddings [N, D] float32),
    the embeddings decoded into one contiguous host matrix in one pass.
    """
    conn = sqlite3.connect(db_path)
    try:
        cols = {
            r[1] for r in conn.execute("PRAGMA table_info(chunks)").fetchall()
        }
        has_url = "url" in cols
        sel = "SELECT id, content, source, embedding" + (
            ", url" if has_url else ""
        ) + " FROM chunks"
        ids, contents, sources, urls, blobs = [], [], [], [], []
        for row in conn.execute(sel):
            ids.append(row[0])
            contents.append(row[1])
            sources.append(row[2])
            blobs.append(row[3])
            urls.append(row[4] if has_url else "Unknown")
    finally:
        conn.close()
    if not blobs:
        return ids, contents, sources, urls, np.zeros((0, 0), np.float32)
    flat = np.frombuffer(b"".join(blobs), dtype=np.float32)
    return ids, contents, sources, urls, flat.reshape(len(blobs), -1)


def load_reference_query_db(
    db_path: str,
) -> Tuple[List[str], List[str], np.ndarray]:
    """Read a reference-format query DB: (ids, queries, embeddings [Q, D])."""
    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute(
            "SELECT id, query, query_embedding FROM queries "
            "WHERE query_embedding IS NOT NULL"
        ).fetchall()
    finally:
        conn.close()
    ids = [r[0] for r in rows]
    queries = [r[1] for r in rows]
    if not rows:
        return ids, queries, np.zeros((0, 0), np.float32)
    flat = np.frombuffer(b"".join(r[2] for r in rows), dtype=np.float32)
    return ids, queries, flat.reshape(len(rows), -1)


class _StubObject:
    """Attribute container standing in for unimportable pickled classes."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            # pydantic v1-style state nests the real attrs under __dict__.
            inner = state.get("__dict__")
            self.__dict__.update(
                inner if isinstance(inner, dict) else state
            )
        elif isinstance(state, tuple) and state and isinstance(state[0], dict):
            self.__dict__.update(state[0])


# Allowlist of globals a reference BM25 pickle legitimately needs:
# container/primitive constructors and the numpy array reconstructors.
# Everything else, importable or not (rank_bm25, langchain, either
# package's fixture classes), resolves to a _StubObject subclass without
# being imported, so a hostile pickle cannot reach os.system,
# builtins.eval or any other importable callable through REDUCE.
_SAFE_GLOBALS = (
    {
        ("builtins", n)
        for n in (
            "set", "frozenset", "list", "tuple", "dict", "bytearray",
            "complex", "slice", "range", "object", "bytes", "str",
            "int", "float", "bool",
        )
    }
    | {
        ("collections", n)
        for n in ("OrderedDict", "defaultdict", "Counter", "deque")
    }
    | {("copyreg", "_reconstructor")}
)
_SAFE_NUMPY_MODULES = frozenset(
    ("numpy", "numpy.core.multiarray", "numpy._core.multiarray")
)
_SAFE_NUMPY_NAMES = frozenset(("_reconstruct", "scalar", "ndarray", "dtype"))


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS or (
            module in _SAFE_NUMPY_MODULES and name in _SAFE_NUMPY_NAMES
        ):
            return super().find_class(module, name)
        return type(name, (_StubObject,), {"__module__": module})


def load_reference_bm25_pickle(path: str, device: DeviceLike = "cuda"):
    """Import a reference BM25 pickle WITHOUT its dependencies installed.

    The reference persists ``{bm25: rank_bm25.BM25Okapi, sections:
    [langchain Document], section_ids, config}``
    (src/processing/bm25_search.py:82-93). Unimportable classes are
    reconstructed as attribute containers, and the index is rebuilt as
    Bm25Arrays on ``device`` from the pickle's OWN statistics (the stored
    IDF values verbatim, stored k1/b/avgdl). The impacts are formed in
    numpy float64 and cast to float32 on the host before they become
    tensors, so they are bit for bit the JAX package's.

    Returns (bm25_arrays, vocab, stats, section_ids, contents, sources).
    """
    dev = resolve_device(device)
    with open(path, "rb") as f:
        payload = _StubUnpickler(f).load()
    bm25 = payload["bm25"]
    section_ids = list(payload["section_ids"])
    sections = payload.get("sections") or []
    contents, sources = [], []
    for doc in sections:
        contents.append(getattr(doc, "page_content", ""))
        meta = getattr(doc, "metadata", {}) or {}
        sources.append(meta.get("source", "Unknown"))

    idf: Dict[str, float] = dict(bm25.idf)
    doc_len = np.asarray(bm25.doc_len, dtype=np.float64)
    n_docs = int(bm25.corpus_size)
    avgdl = float(bm25.avgdl)
    k1 = float(getattr(bm25, "k1", 1.5))
    b = float(getattr(bm25, "b", 0.75))
    epsilon = float(getattr(bm25, "epsilon", 0.25))
    n_pad = -(-n_docs // 128) * 128

    vocab_terms = sorted(idf)
    vocab = {t: i for i, t in enumerate(vocab_terms)}
    denom_base = k1 * (1.0 - b + b * doc_len / avgdl)
    postings: Dict[str, Dict[int, int]] = {t: {} for t in vocab_terms}
    for d, freqs in enumerate(bm25.doc_freqs):
        for term, tf in freqs.items():
            postings[term][d] = tf

    indptr = np.zeros(len(vocab_terms) + 1, dtype=np.int32)
    ids_parts, imp_parts = [], []
    for ti, term in enumerate(vocab_terms):
        docs = np.fromiter(
            sorted(postings[term]), dtype=np.int32, count=len(postings[term])
        )
        tf = np.asarray([postings[term][d] for d in docs], dtype=np.float64)
        imp = idf[term] * tf * (k1 + 1.0) / (tf + denom_base[docs])
        ids_parts.append(docs)
        imp_parts.append(imp)
        indptr[ti + 1] = indptr[ti] + len(docs)
    nnz = int(indptr[-1])
    doc_ids = np.empty(nnz + 1, dtype=np.int32)
    impact = np.empty(nnz + 1, dtype=np.float32)
    doc_ids[:nnz] = np.concatenate(ids_parts) if nnz else []
    impact[:nnz] = np.concatenate(imp_parts).astype(np.float32) if nnz else []
    doc_ids[nnz] = n_pad
    impact[nnz] = 0.0
    arrays = Bm25Arrays(
        indptr=numpy_to_torch(indptr, dev),
        doc_ids=numpy_to_torch(doc_ids, dev),
        impact=numpy_to_torch(impact, dev),
        n_docs_padded=n_pad,
    )
    stats = {
        "k1": k1, "b": b, "epsilon": epsilon, "avgdl": avgdl,
        "corpus_size": n_docs, "nnz": nnz,
        "imported_from": path,
    }
    return arrays, vocab, stats, section_ids, contents, sources


def load_preprocessed_tokens_csv(
    csv_path: str, token_column: str = "tokens_lemmatized"
) -> Dict[str, List[str]]:
    """Read a reference preprocessed-chunks/queries CSV: id -> token list."""
    import csv

    out: Dict[str, List[str]] = {}
    with open(csv_path, "r", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        for row in reader:
            raw = row.get(token_column, "")
            try:
                toks = ast.literal_eval(raw) if isinstance(raw, str) else raw
            except (ValueError, SyntaxError):
                toks = []
            out[row["id"]] = toks if isinstance(toks, list) else []
    return out
