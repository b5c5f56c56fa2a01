"""LangChain evaluator adapter.

Equivalent of ragas_modified/integrations/langchain.py's EvaluatorChain:
wraps a metric as a callable that scores run dicts. The reference
subclasses langchain's Chain; here the adapter is duck-type compatible
with langchain's evaluator protocol (``__call__`` over an inputs dict,
``evaluate_run``-style key remapping) without importing langchain — so
it also works standalone.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample

_KEY_ALIASES = {
    "question": "user_input",
    "query": "user_input",
    "answer": "response",
    "result": "response",
    "prediction": "response",
    "contexts": "retrieved_contexts",
    "source_documents": "retrieved_contexts",
    "ground_truth": "reference",
}


class EvaluatorChain:
    """metric -> callable evaluator over run/row dicts."""

    def __init__(self, metric, **metric_init):
        self.metric = metric
        for k, v in metric_init.items():
            setattr(self.metric, k, v)

    @property
    def name(self) -> str:
        return self.metric.name

    def _to_sample(self, inputs: Dict[str, Any]) -> SingleTurnSample:
        row: Dict[str, Any] = {}
        for k, v in inputs.items():
            key = _KEY_ALIASES.get(k, k)
            if key == "retrieved_contexts" and v and not isinstance(v[0], str):
                v = [getattr(d, "page_content", str(d)) for d in v]
            row[key] = v
        allowed = set(SingleTurnSample.model_fields)
        return SingleTurnSample(**{k: v for k, v in row.items() if k in allowed})

    def __call__(self, inputs: Dict[str, Any]) -> Dict[str, float]:
        sample = self._to_sample(inputs)
        score = asyncio.run(self.metric._single_turn_ascore(sample))
        return {self.metric.name: score}

    async def acall(self, inputs: Dict[str, Any]) -> Dict[str, float]:
        sample = self._to_sample(inputs)
        return {self.metric.name: await self.metric._single_turn_ascore(sample)}
