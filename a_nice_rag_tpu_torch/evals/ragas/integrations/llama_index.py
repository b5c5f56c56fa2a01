"""LlamaIndex query-engine evaluation adapter.

Equivalent of ragas_modified/integrations/llama_index.py's evaluate():
runs every dataset question through a query engine and scores the
answers. Duck-typed on the engine surface (``aquery(q)`` or
``query(q)`` returning an object with ``.response`` and
``.source_nodes[*]`` each carrying text) — works with real LlamaIndex
engines and with any compatible object, no import needed.
"""

from __future__ import annotations

import asyncio
from typing import Any, Sequence

from a_nice_rag_tpu_torch.evals.ragas.dataset import (
    EvaluationDataset,
    SingleTurnSample,
)
from a_nice_rag_tpu_torch.evals.ragas.evaluation import evaluate as ragas_evaluate


def _node_text(node: Any) -> str:
    inner = getattr(node, "node", node)
    if hasattr(inner, "get_content"):
        return inner.get_content()
    return getattr(inner, "text", str(inner))


async def _answer(engine: Any, question: str):
    if hasattr(engine, "aquery"):
        resp = await engine.aquery(question)
    else:
        resp = await asyncio.to_thread(engine.query, question)
    contexts = [_node_text(n) for n in getattr(resp, "source_nodes", [])]
    return str(getattr(resp, "response", resp)), contexts


def evaluate_query_engine(
    query_engine: Any,
    dataset: EvaluationDataset,
    metrics: Sequence[Any],
    **evaluate_kwargs,
):
    """Answer every sample with the engine, then run the metric suite."""

    async def gather():
        return await asyncio.gather(
            *(_answer(query_engine, s.user_input) for s in dataset.samples)
        )

    answered = asyncio.run(gather())
    samples = []
    for sample, (response, contexts) in zip(dataset.samples, answered):
        samples.append(
            SingleTurnSample(
                user_input=sample.user_input,
                retrieved_contexts=contexts or sample.retrieved_contexts,
                response=response,
                reference=sample.reference,
            )
        )
    return ragas_evaluate(
        EvaluationDataset(samples=samples), metrics=list(metrics),
        **evaluate_kwargs,
    )
