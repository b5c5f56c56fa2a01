"""IR metrics over rank-of-gold results (a copy of the JAX package's
``evals/metrics.py``, which imports no jax).

Metric definitions match the reference's calculate_metrics
(src/retrieval_eval.py:90-116): MRR averages reciprocal ranks over ALL
queries (missing gold contributes 0), Recall@k over all queries,
mean/median rank over found queries only, max rank over all queries with
unfound queries taking the 100000 sentinel.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

UNFOUND_SENTINEL = 100_000


def calculate_metrics(
    ranks: Sequence[int], found: Optional[Sequence[bool]] = None
) -> Dict[str, float]:
    """ranks: 1-based rank of the gold chunk per query (<=0 = not found
    unless ``found`` is given explicitly)."""
    ranks = np.asarray(ranks, dtype=np.int64)
    if found is None:
        found = ranks > 0
    found = np.asarray(found, dtype=bool)
    total = len(ranks)
    if total == 0:
        return {"total": 0}
    found_ranks = ranks[found]
    all_ranks = np.where(found, ranks, UNFOUND_SENTINEL)
    recall = lambda k: float((found & (ranks <= k)).sum()) / total
    return {
        "total": int(total),
        "found": int(found.sum()),
        "success_rate": float(found.sum()) / total,
        "mean_rank": float(found_ranks.mean()) if found_ranks.size else None,
        "median_rank": float(np.median(found_ranks)) if found_ranks.size else None,
        "max_rank": int(all_ranks.max()),
        "mrr": float((1.0 / found_ranks).sum()) / total if total else 0.0,
        "recall@1": recall(1),
        "recall@5": recall(5),
        "recall@10": recall(10),
        "recall@15": recall(15),
    }


def metrics_csv_row(name: str, m: Dict[str, float]) -> str:
    """One CSV row in the reference's results format
    (src/retrieval_eval.py:292-294 header)."""
    med = f"{m['median_rank']}" if m.get("median_rank") is not None else "N/A"
    mean = f"{m['mean_rank']:.3f}" if m.get("mean_rank") is not None else "N/A"
    # Pool-limited evaluation (the rerank configs rank only within the
    # returned candidate pool) cannot bound a miss's true rank; the
    # reference emits N/A on those rows (its rerank path computes only
    # recalls — results/retrieval_evaluation_results.csv rows 9-10).
    mx = "N/A" if m["max_rank"] >= UNFOUND_SENTINEL else f"{m['max_rank']}"
    return (
        f"{name},{m['mrr']:.3f},{m['recall@1']:.3f},{m['recall@5']:.3f},"
        f"{m['recall@10']:.3f},{m['recall@15']:.3f},{med},{mean},"
        f"{mx}"
    )


CSV_HEADER = (
    "Model,MRR,Recall@1,Recall@5,Recall@10,Recall@15,"
    "Median_Rank,Mean_Rank,Max_Rank"
)
