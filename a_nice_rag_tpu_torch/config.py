"""Configuration knobs of the retrieval layer.

Counterpart of ``a_nice_rag_tpu/config.py``, which imports no jax: the
``InfoSource`` enum, the default fusion weights of the reference system
(its ``src/config.py:30-36``), and the static postings budget of the CSR
BM25 scatter: the settings the port reads. The JAX package's TPU execution
policy (mesh axes, doc-axis padding) has no counterpart here; per-source
artifact paths come with the index manager.
"""

from __future__ import annotations

import enum
from typing import Dict


class InfoSource(enum.Enum):
    NICE = "nice"


class Config:
    """Global defaults, with the JAX package's names."""

    # Default fusion weights (reference src/config.py:30-36).
    DEFAULT_MODEL_WEIGHTS: Dict[str, float] = {
        "voyage-3-large": 5.0,
        "text-embedding-3-large": 0.0,
        "voyage-3.5": 0.0,
        "Qwen3": 0.0,
        "BM25": 1.0,
    }

    # Flattened postings per query of the CSR BM25 scatter
    # (ops/bm25.py's ``bm25_scores`` budget; the JAX package's
    # ``Config.TPU.bm25_postings_budget``).
    bm25_postings_budget: int = 16384
