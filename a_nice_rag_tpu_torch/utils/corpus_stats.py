"""Corpus statistics (reference notebooks/summary_stats.ipynb): word and
token counts per guideline and corpus-level summaries.

Counterpart of ``a_nice_rag_tpu/utils/corpus_stats.py`` (a copy: it
imports no jax).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np

from a_nice_rag_tpu_torch.ingest.tokens import TokenCounter


def corpus_stats(chunks: Sequence[Dict], token_counter=None) -> Dict:
    count = token_counter or TokenCounter()
    per_guideline: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"chunks": 0, "words": 0, "tokens": 0}
    )
    for c in chunks:
        g = c.get("source", "unknown")
        words = len(c.get("content", "").split())
        tokens = c.get("tokens") or count(c.get("content", ""))
        per_guideline[g]["chunks"] += 1
        per_guideline[g]["words"] += words
        per_guideline[g]["tokens"] += tokens
    token_counts = [c.get("tokens") or 0 for c in chunks]
    return {
        "n_chunks": len(chunks),
        "n_guidelines": len(per_guideline),
        "total_words": int(sum(g["words"] for g in per_guideline.values())),
        "total_tokens": int(sum(g["tokens"] for g in per_guideline.values())),
        "mean_chunk_tokens": float(np.mean(token_counts)) if chunks else 0.0,
        "median_chunk_tokens": float(np.median(token_counts)) if chunks else 0.0,
        "per_guideline": dict(per_guideline),
    }
