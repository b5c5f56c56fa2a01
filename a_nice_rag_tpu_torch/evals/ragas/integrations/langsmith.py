"""LangSmith dataset upload / evaluation (import-gated).

Equivalent of ragas_modified/integrations/langsmith.py. Requires the
``langsmith`` client package; this image does not ship it, so the
functions raise an actionable ImportError at call time (not import
time) and otherwise mirror the upstream surface.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from a_nice_rag_tpu_torch.evals.ragas.dataset import EvaluationDataset
from a_nice_rag_tpu_torch.evals.ragas.integrations.langchain import EvaluatorChain


def _client():
    try:
        from langsmith import Client  # type: ignore
    except ImportError as e:
        raise ImportError(
            "langsmith is required: pip install langsmith"
        ) from e
    return Client()


def upload_dataset(
    dataset: EvaluationDataset, dataset_name: str,
    dataset_desc: str = "",
) -> Any:
    """Upload samples as a LangSmith dataset of (inputs, outputs) rows."""
    client = _client()
    ls_dataset = client.create_dataset(
        dataset_name=dataset_name, description=dataset_desc
    )
    for s in dataset.samples:
        client.create_example(
            inputs={"question": s.user_input},
            outputs={
                "ground_truth": s.reference,
                "contexts": s.reference_contexts,
            },
            dataset_id=ls_dataset.id,
        )
    return ls_dataset


def evaluate(
    dataset_name: str,
    llm_or_chain_factory: Any,
    metrics: Sequence[Any],
    experiment_name: Optional[str] = None,
) -> Any:
    """Run a LangSmith evaluation with metric evaluator chains."""
    client = _client()
    evaluators = [EvaluatorChain(m) for m in metrics]
    return client.run_on_dataset(  # pragma: no cover - needs langsmith
        dataset_name=dataset_name,
        llm_or_chain_factory=llm_or_chain_factory,
        evaluation={"custom_evaluators": evaluators},
        project_name=experiment_name,
    )
