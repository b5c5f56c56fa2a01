"""Hybrid retrieval over the array index (counterpart of
``a_nice_rag_tpu.retrieval``; ``FusedRetriever`` only so far)."""

from a_nice_rag_tpu_torch.retrieval.engine import FusedRetriever  # noqa: F401
