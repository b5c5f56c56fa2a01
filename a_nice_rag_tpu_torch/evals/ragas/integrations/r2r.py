"""R2R retrieval-system adapter.

Equivalent of ragas_modified/integrations/r2r.py: turns R2R RAG
responses into an EvaluationDataset. Duck-typed: accepts either the
R2R client's response objects (``.results.search_results.as_dict()`` /
``.results.generated_answer``) or plain dicts of the same shape.
"""

from __future__ import annotations

import warnings
from typing import Any, List, Optional, Sequence

from a_nice_rag_tpu_torch.evals.ragas.dataset import (
    EvaluationDataset,
    SingleTurnSample,
)


def _as_dict(obj: Any) -> dict:
    if isinstance(obj, dict):
        return obj
    if hasattr(obj, "as_dict"):
        return obj.as_dict()
    if hasattr(obj, "dict"):
        return obj.dict()
    return vars(obj)


def _process_search_results(search_results: dict) -> List[str]:
    """Aggregate chunk + web results; warn on unsupported result types."""
    contexts: List[str] = []
    for key in ("graph_search_results", "context_document_results"):
        if search_results.get(key):
            warnings.warn(
                f"{key} are not included in the aggregated "
                "retrieved_contexts"
            )
    for r in search_results.get("chunk_search_results", []) or []:
        if r.get("text"):
            contexts.append(r["text"])
    for r in search_results.get("web_search_results", []) or []:
        if r.get("snippet"):
            contexts.append(r["snippet"])
    return contexts


def transform_to_ragas_dataset(
    user_inputs: Sequence[str],
    r2r_responses: Sequence[Any],
    references: Optional[Sequence[str]] = None,
    reference_contexts: Optional[Sequence[List[str]]] = None,
) -> EvaluationDataset:
    if len(user_inputs) != len(r2r_responses):
        raise ValueError("user_inputs and r2r_responses length mismatch")
    samples = []
    for i, (q, resp) in enumerate(zip(user_inputs, r2r_responses)):
        results = _as_dict(resp).get("results", _as_dict(resp))
        results = _as_dict(results)
        search = _as_dict(results.get("search_results", {}) or {})
        samples.append(
            SingleTurnSample(
                user_input=q,
                retrieved_contexts=_process_search_results(search),
                response=results.get("generated_answer"),
                reference=references[i] if references else None,
                reference_contexts=(
                    reference_contexts[i] if reference_contexts else None
                ),
            )
        )
    return EvaluationDataset(samples=samples)
