"""BM25 corpus preprocessing and index building.

Covers the reference's preprocess_bm25.py (chunk token CSVs with regular
and lemmatized columns) and bm25_search.py (index construction with
k1=1.7, b=0.83, epsilon=0.05 defaults). The index product here is the
array-index BM25 component (CSR + eager impacts) rather than a pickled
rank_bm25 object; a CSV roundtrip keeps compatibility with the
reference's intermediate files.

Counterpart of ``a_nice_rag_tpu/ingest/bm25_build.py``; the arrays are
built on the device the caller names.
"""

from __future__ import annotations

import ast
import csv
import logging
from typing import Dict, List, Sequence, Tuple

from a_nice_rag_tpu_torch.device import DeviceLike
from a_nice_rag_tpu_torch.index.array_index import build_bm25_arrays
from a_nice_rag_tpu_torch.text import preprocess_text

logger = logging.getLogger(__name__)


def preprocess_chunks(
    chunks: Sequence[Dict],
) -> List[Dict]:
    """Per-chunk token lists (both tokenization variants), skipping chunks
    without title/content as the reference does (preprocess_bm25.py:63)."""
    rows = []
    for chunk in chunks:
        if not chunk.get("title") or not chunk.get("content"):
            continue
        content = chunk["content"]
        rows.append(
            {
                "id": chunk["title"],
                "source": chunk.get("source", "unknown"),
                "content": content,
                "tokens_regular": preprocess_text(content, False),
                "tokens_lemmatized": preprocess_text(content, True),
            }
        )
    return rows


def write_tokens_csv(rows: Sequence[Dict], path: str) -> None:
    with open(path, "w", encoding="utf-8", newline="") as f:
        writer = csv.DictWriter(
            f,
            fieldnames=["id", "source", "content", "tokens_regular",
                        "tokens_lemmatized"],
        )
        writer.writeheader()
        for row in rows:
            writer.writerow(row)


def read_tokens_csv(path: str) -> List[Dict]:
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            for col in ("tokens_regular", "tokens_lemmatized"):
                try:
                    row[col] = ast.literal_eval(row[col])
                except (ValueError, SyntaxError):
                    row[col] = []
            rows.append(row)
    return rows


def build_bm25_component(
    rows: Sequence[Dict],
    n_docs_padded: int,
    use_lemmatized: bool = True,
    k1: float = 1.7,
    b: float = 0.83,
    epsilon: float = 0.05,
    device: DeviceLike = "cuda",
) -> Tuple:
    """(Bm25Arrays, vocab, stats) on ``device`` from preprocessed rows;
    empty-token rows participate as zero-score docs (excluded from
    corpus stats)."""
    col = "tokens_lemmatized" if use_lemmatized else "tokens_regular"
    token_lists = [row[col] for row in rows]
    return build_bm25_arrays(
        token_lists, n_docs_padded, k1=k1, b=b, epsilon=epsilon,
        device=device,
    )
