"""Online index updates: tombstone deletes and frozen-stats appends.

Counterpart of ``a_nice_rag_tpu/index/updates.py``:

* ``delete_documents`` / ``undelete_documents`` — O(1) tombstones: the
  rows stay in the arrays but every candidate mask excludes them from
  then on. A tombstone makes the mask non-trivial, so an IVF retriever
  takes the exact masked route.
* ``append_documents`` — a new index with the documents appended, without
  touching existing postings: dense matrices extend by concatenation and
  the BM25 CSR extends under FROZEN corpus statistics (idf, avgdl and
  corpus size stay as built), so every existing impact is bit-identical.
  The new index carries no IVF: ANN must be re-attached, so it can never
  silently miss appended documents.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from a_nice_rag_tpu_torch.index.array_index import (
    ArrayIndex,
    CorpusMeta,
    _pad_to,
    dense_impact_from_csr,
)
from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays
from a_nice_rag_tpu_torch.ops.quantized import (
    QuantizedDense,
    quantize_embeddings,
)


def _set_deleted(index: ArrayIndex, doc_ids: Sequence[str],
                 deleted: bool) -> int:
    n_new = 0
    for d in doc_ids:
        row = index.meta.id_to_row.get(d)
        if row is not None and index.meta.deleted[row] != deleted:
            index.meta.deleted[row] = deleted
            n_new += 1
    if n_new:
        index._filter_cache.clear()
        index._version += 1
    return n_new


def delete_documents(index: ArrayIndex, doc_ids: Sequence[str]) -> int:
    """Tombstone documents by id; returns how many were newly deleted.
    Unknown ids are ignored. Retriever mask caches are version-keyed and
    refresh on their next call."""
    return _set_deleted(index, doc_ids, True)


def undelete_documents(index: ArrayIndex, doc_ids: Sequence[str]) -> int:
    """Clear tombstones; returns how many were restored."""
    return _set_deleted(index, doc_ids, False)


def _frozen_idf(df: int, stats: Dict[str, float]) -> float:
    num = stats["corpus_size"] - df + 0.5
    # df at or beyond the frozen corpus size means raw idf <= 0: floor.
    raw = math.log(num) - math.log(df + 0.5) if num > 0 else -1.0
    if raw < 0:
        return stats["epsilon"] * stats["average_idf"]
    return raw


def _ensure_average_idf(stats: Dict[str, float], indptr: np.ndarray) -> None:
    """Stats dicts without average_idf (imported reference pickles)
    derive it from the frozen df distribution."""
    if "average_idf" in stats:
        return
    df = np.diff(indptr).astype(np.float64)
    df = df[df > 0]
    cs = stats["corpus_size"]
    raw = np.log(np.maximum(cs - df + 0.5, 1e-9)) - np.log(df + 0.5)
    stats["average_idf"] = float(raw.mean()) if raw.size else 1.0


def _append_rows(old: torch.Tensor, old_n: int, new: torch.Tensor,
                 n_pad: int) -> torch.Tensor:
    out = torch.zeros((n_pad,) + tuple(old.shape[1:]), dtype=old.dtype,
                      device=old.device)
    out[:old_n] = old[:old_n]
    out[old_n:old_n + new.shape[0]] = new.to(old.dtype)
    return out


def _checked_embeddings(embeddings, model: str, m: int, d: int,
                        device: torch.device) -> torch.Tensor:
    if model not in embeddings:
        raise ValueError(f"missing embeddings for model {model!r}")
    new = np.asarray(embeddings[model], dtype=np.float32)
    if new.shape != (m, d):
        raise ValueError(f"{model}: expected {(m, d)}, got {new.shape}")
    return torch.as_tensor(new, device=device)


def append_documents(
    index: ArrayIndex,
    ids: Sequence[str],
    sources: Sequence[str],
    contents: Sequence[str],
    embeddings: Dict[str, np.ndarray],
    urls: Optional[Sequence[str]] = None,
    token_lists: Optional[Sequence[Sequence[str]]] = None,
    pad_multiple: int = 128,
    bm25_dense_max_bytes: int = 4 << 30,
) -> ArrayIndex:
    """A new ArrayIndex, on the same device, with the documents appended
    (see the module docstring). ``embeddings`` must cover the index's
    models; ``token_lists`` is required when the index has BM25. Existing
    rows, postings and impacts are preserved bit for bit; tombstones carry
    over."""
    m = len(ids)
    if m == 0:
        return index
    dup = [d for d in ids if d in index.meta.id_to_row]
    if dup:
        raise ValueError(f"ids already present: {dup[:5]}")
    if len(set(ids)) != m:
        seen = set()
        repeats = [d for d in ids if d in seen or seen.add(d)]
        raise ValueError(f"duplicate ids within batch: {repeats[:5]}")
    dev = index.device
    old_n = index.meta.n_docs
    n = old_n + m
    n_pad = _pad_to(n, pad_multiple)

    meta = CorpusMeta(
        ids=index.meta.ids + list(ids),
        sources=index.meta.sources + list(sources),
        contents=index.meta.contents + list(contents),
        urls=index.meta.urls + (
            list(urls) if urls is not None else ["Unknown"] * m
        ),
        n_docs=n,
        n_docs_padded=n_pad,
    )
    meta.deleted[:old_n] = index.meta.deleted

    dense = {
        model: _append_rows(
            emb, old_n,
            _checked_embeddings(embeddings, model, m, emb.shape[1], dev),
            n_pad,
        )
        for model, emb in index.dense.items()
    }

    dense_q = None
    if index.dense_q:
        dense_q = {}
        for model, qd in index.dense_q.items():
            new = _checked_embeddings(embeddings, model, m,
                                      qd.values.shape[1], dev)
            # Per-row scales: old rows carry over bit for bit; only the
            # new rows quantize.
            new_q = quantize_embeddings(new)
            dense_q[model] = QuantizedDense(
                values=_append_rows(qd.values, old_n, new_q.values, n_pad),
                scales=_append_rows(qd.scales, old_n, new_q.scales, n_pad),
            )

    bm25 = index.bm25
    vocab = index.vocab
    stats = index.bm25_stats
    bm25_doc_mask = index.bm25_doc_mask
    bm25_dense = index.bm25_dense
    if index.bm25 is not None:
        if token_lists is None:
            raise ValueError(
                "index has a BM25 component; token_lists required"
            )
        old_ptr = index.bm25.indptr.cpu().numpy()
        old_ids = index.bm25.doc_ids.cpu().numpy()
        old_imp = index.bm25.impact.cpu().numpy()
        stats = dict(index.bm25_stats)
        _ensure_average_idf(stats, old_ptr)
        k1, b = stats["k1"], stats["b"]
        avgdl = stats["avgdl"]

        # Per-appended-doc term frequencies and lengths.
        vocab = dict(index.vocab)
        new_postings: Dict[int, Dict[int, int]] = {}
        dl = np.zeros(m, dtype=np.float64)
        for j, toks in enumerate(token_lists):
            dl[j] = len(toks)
            seen: Dict[str, int] = {}
            for t in toks:
                seen[t] = seen.get(t, 0) + 1
            for t, c in seen.items():
                ti = vocab.setdefault(t, len(vocab))
                new_postings.setdefault(ti, {})[old_n + j] = c

        old_v = old_ptr.shape[0] - 1
        v = len(vocab)
        denom = k1 * (1.0 - b + b * dl / avgdl)

        ids_parts, imp_parts = [], []
        indptr = np.zeros(v + 1, dtype=np.int32)
        for ti in range(v):
            if ti < old_v:
                lo, hi = int(old_ptr[ti]), int(old_ptr[ti + 1])
                ids_parts.append(old_ids[lo:hi])
                imp_parts.append(old_imp[lo:hi])
                count = hi - lo
            else:
                count = 0
            post = new_postings.get(ti)
            if post:
                # New rows follow every existing row: appending keeps each
                # term's doc order.
                docs = np.fromiter(post.keys(), np.int32, len(post))
                order = np.argsort(docs, kind="stable")
                docs = docs[order]
                tf = np.fromiter(
                    post.values(), np.float64, len(post))[order]
                # Frozen statistics: an existing term's new postings use
                # the idf its old postings were built with; a new term
                # gets idf from its appended df.
                df_for_idf = count if count > 0 else len(post)
                idf = _frozen_idf(df_for_idf, stats)
                imp = (
                    idf * tf * (k1 + 1.0)
                    / (tf + denom[docs - old_n])
                ).astype(np.float32)
                ids_parts.append(docs)
                imp_parts.append(imp)
                count += len(post)
            indptr[ti + 1] = indptr[ti] + count
        nnz = int(indptr[-1])
        doc_ids = np.empty(nnz + 1, dtype=np.int32)
        impact = np.empty(nnz + 1, dtype=np.float32)
        if nnz:
            doc_ids[:nnz] = np.concatenate(ids_parts)
            impact[:nnz] = np.concatenate(imp_parts)
        doc_ids[nnz] = n_pad
        impact[nnz] = 0.0
        bm25 = Bm25Arrays(
            indptr=torch.as_tensor(indptr, device=dev),
            doc_ids=torch.as_tensor(doc_ids, device=dev),
            impact=torch.as_tensor(impact, device=dev),
            n_docs_padded=n_pad,
        )
        stats["nnz"] = nnz
        stats["max_df"] = int((indptr[1:] - indptr[:-1]).max()) if nnz else 0
        stats["appended_docs"] = int(stats.get("appended_docs", 0)) + m

        old_mask = (
            index.bm25_doc_mask
            if index.bm25_doc_mask is not None
            else np.ones(index.meta.n_docs_padded, bool)
        )
        bm25_doc_mask = np.zeros(n_pad, dtype=bool)
        bm25_doc_mask[:old_n] = old_mask[:old_n]
        bm25_doc_mask[old_n:n] = dl > 0

        # Same size gate as build_index for the derived dense impacts.
        dense_bytes = len(vocab) * n_pad * 4
        if (index.bm25_dense is not None
                and dense_bytes <= bm25_dense_max_bytes):
            bm25_dense = dense_impact_from_csr(
                bm25, dtype=str(index.bm25_dense.impact.dtype).split(".")[-1]
            )
        else:
            bm25_dense = None

    return ArrayIndex(
        meta=meta,
        dense=dense,
        bm25=bm25,
        vocab=vocab,
        bm25_stats=stats,
        bm25_doc_mask=bm25_doc_mask,
        bm25_dense=bm25_dense,
        dense_q=dense_q,
    )
