"""One-command migration from reference artifacts to the array index.

Counterpart of ``a_nice_rag_tpu/ingest/import_reference.py``. Takes the
reference deployment's on-disk state — per-model SQLite chunk DBs and
the BM25 pickle — and assembles the array-index artifact. The pickle's
BM25 rows follow ITS OWN document ordering (the non-empty-token subset,
src/processing/bm25_search.py:67); postings are remapped onto the chunk
DB's row space so dense and BM25 components share one document axis.
The remap is host numpy; the index is uploaded to ``device`` once.

Usage:
    python -m a_nice_rag_tpu_torch.ingest.import_reference \
        --chunk-db voyage-3-large=databases/voyage_3_large_nice_guidelines_2048.db \
        --bm25-pickle databases/bm25_index_nice_guidelines.pkl \
        --output artifacts/nice_index [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device
from a_nice_rag_tpu_torch.index.io import numpy_to_torch
from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays

logger = logging.getLogger(__name__)


def remap_bm25_rows(
    arrays: Bm25Arrays,
    row_map: Sequence[int],
    n_docs_padded: int,
) -> Bm25Arrays:
    """Renumber postings' document rows via ``row_map`` (old row -> new
    row, -1 drops the posting), re-sorting each term's postings by the
    new row id and repadding to ``n_docs_padded``. The result stays on
    the postings' device."""
    dev = arrays.indptr.device
    indptr = arrays.indptr.cpu().numpy()
    doc_ids = arrays.doc_ids.cpu().numpy()
    impact = arrays.impact.cpu().numpy()
    row_map = np.asarray(row_map, dtype=np.int64)
    v = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    new_ids = row_map[doc_ids[:nnz]]
    keep = new_ids >= 0

    out_ptr = np.zeros(v + 1, dtype=np.int32)
    ids_parts: List[np.ndarray] = []
    imp_parts: List[np.ndarray] = []
    for t in range(v):
        lo, hi = indptr[t], indptr[t + 1]
        sel = keep[lo:hi]
        ids_t = new_ids[lo:hi][sel]
        imp_t = impact[lo:hi][sel]
        order = np.argsort(ids_t, kind="stable")
        ids_parts.append(ids_t[order].astype(np.int32))
        imp_parts.append(imp_t[order])
        out_ptr[t + 1] = out_ptr[t] + ids_t.shape[0]
    new_nnz = int(out_ptr[-1])
    out_ids = np.empty(new_nnz + 1, dtype=np.int32)
    out_imp = np.empty(new_nnz + 1, dtype=np.float32)
    out_ids[:new_nnz] = np.concatenate(ids_parts) if new_nnz else []
    out_imp[:new_nnz] = np.concatenate(imp_parts) if new_nnz else []
    out_ids[new_nnz] = n_docs_padded
    out_imp[new_nnz] = 0.0
    return Bm25Arrays(
        indptr=numpy_to_torch(out_ptr, dev),
        doc_ids=numpy_to_torch(out_ids, dev),
        impact=numpy_to_torch(out_imp, dev),
        n_docs_padded=n_docs_padded,
    )


def assemble_index_from_reference(
    chunk_dbs: Dict[str, str],
    bm25_pickle: Optional[str] = None,
    pad_multiple: int = 128,
    device: DeviceLike = "cuda",
):
    """Build an ArrayIndex on ``device`` from reference chunk DBs (+
    optional pickle)."""
    from a_nice_rag_tpu_torch.index.array_index import (
        ArrayIndex,
        CorpusMeta,
        _pad_to,
        dense_impact_from_csr,
    )
    from a_nice_rag_tpu_torch.index.io import (
        load_reference_bm25_pickle,
        load_reference_chunk_db,
    )

    dev = resolve_device(device)
    base_model = next(iter(chunk_dbs))
    ids, contents, sources, urls, emb = load_reference_chunk_db(
        chunk_dbs[base_model]
    )
    n = len(ids)
    n_pad = _pad_to(n, pad_multiple)
    meta = CorpusMeta(
        ids=ids, sources=sources, contents=contents, urls=urls,
        n_docs=n, n_docs_padded=n_pad,
    )
    dense = {}
    for model, path in chunk_dbs.items():
        m_ids, _, _, _, m_emb = (
            (ids, None, None, None, emb)
            if model == base_model
            else load_reference_chunk_db(path)
        )
        pos = {cid: i for i, cid in enumerate(m_ids)}
        aligned = np.zeros((n_pad, m_emb.shape[1]), np.float32)
        for i, cid in enumerate(ids):
            r = pos.get(cid, -1)
            if r >= 0:
                aligned[i] = m_emb[r]
        dense[model] = numpy_to_torch(aligned, dev)

    bm25 = vocab = stats = None
    bm25_doc_mask = None
    bm25_dense = None
    if bm25_pickle:
        arrays, vocab, stats, section_ids, _, _ = load_reference_bm25_pickle(
            bm25_pickle, device=dev
        )
        row_map = np.full(len(section_ids), -1, np.int64)
        missing = 0
        for i, sid in enumerate(section_ids):
            row = meta.id_to_row.get(sid, -1)
            row_map[i] = row
            missing += row < 0
        if missing:
            logger.warning(
                "%d BM25 sections have no chunk-DB row; dropped", missing
            )
        bm25 = remap_bm25_rows(arrays, row_map, n_pad)
        bm25_doc_mask = np.zeros(n_pad, dtype=bool)
        bm25_doc_mask[row_map[row_map >= 0]] = True
        if len(vocab) * n_pad * 4 <= (4 << 30):
            bm25_dense = dense_impact_from_csr(bm25)

    return ArrayIndex(
        meta=meta, dense=dense, bm25=bm25, vocab=vocab, bm25_stats=stats,
        bm25_doc_mask=bm25_doc_mask, bm25_dense=bm25_dense,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--chunk-db", action="append", required=True,
                   help="model=path pairs")
    p.add_argument("--bm25-pickle", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device the index is assembled on")
    args = p.parse_args(argv)
    from a_nice_rag_tpu_torch.index import save_index

    chunk_dbs = dict(pair.split("=", 1) for pair in args.chunk_db)
    index = assemble_index_from_reference(chunk_dbs, args.bm25_pickle,
                                          device=args.device)
    save_index(index, args.output)
    logger.info(
        "imported %d docs (%d dense models, bm25=%s) -> %s",
        index.n_docs, len(index.dense), index.bm25 is not None, args.output,
    )


if __name__ == "__main__":
    main()
