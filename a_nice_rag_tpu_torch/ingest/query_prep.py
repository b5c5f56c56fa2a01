"""Query-set preprocessing (reference preprocess_queries.py /
preprocess_suggested.py): tokenize + lemmatize query CSVs and apply the
15/85 validation/test split with seed 42. Counterpart of
``a_nice_rag_tpu/ingest/query_prep.py``."""

from __future__ import annotations

import csv
from typing import Dict, List, Sequence, Tuple

from a_nice_rag_tpu_torch.evals.retrieval_eval import seed42_split
from a_nice_rag_tpu_torch.text import preprocess_text


def preprocess_queries(
    ids: Sequence[str], queries: Sequence[str]
) -> List[Dict]:
    return [
        {
            "id": qid,
            "query": q,
            "tokens_regular": preprocess_text(q, False),
            "tokens_lemmatized": preprocess_text(q, True),
        }
        for qid, q in zip(ids, queries)
    ]


def split_queries(
    rows: Sequence[Dict], test_size: float = 0.15
) -> Tuple[List[Dict], List[Dict]]:
    """(test 85%, validation 15%) with the reference's seeded split."""
    test_idx, val_idx = seed42_split(len(rows), test_size)
    return [rows[i] for i in test_idx], [rows[i] for i in val_idx]


def write_query_csv(rows: Sequence[Dict], path: str) -> None:
    with open(path, "w", encoding="utf-8", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["id", "query", "tokens_regular", "tokens_lemmatized"]
        )
        writer.writeheader()
        for row in rows:
            writer.writerow(row)
