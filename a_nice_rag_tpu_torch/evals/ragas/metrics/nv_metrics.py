"""NVIDIA-style metrics (ragas_modified/metrics/_nv_metrics.py):
AnswerAccuracy, ContextRelevance, ResponseGroundedness. Each takes TWO
independent judge ratings on a small integer scale and averages the
normalized scores (dual-judge averaging reduces single-call variance).
"""

from __future__ import annotations

from typing import ClassVar

import numpy as np
from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class RatingIn(BaseModel):
    instruction: str
    payload: str


class RatingOut(BaseModel):
    rating: int = Field(description="The integer rating")


class RatingPrompt(StructuredPrompt[RatingIn, RatingOut]):
    instruction = "Follow the rating instruction for the payload exactly."
    input_model = RatingIn
    output_model = RatingOut
    examples = []


class _DualRatingMetric(MetricWithLLM, SingleTurnMetric):
    rating_instruction: ClassVar[str] = ""
    max_rating: ClassVar[int] = 2

    def __init__(self, llm=None):
        self.llm = llm
        self.prompt = RatingPrompt()

    def _payload(self, sample: SingleTurnSample) -> str:
        raise NotImplementedError

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        data = RatingIn(
            instruction=self.rating_instruction, payload=self._payload(sample)
        )
        outs = await self.prompt.generate_multiple(
            self.llm, data, n=2, temperature=0.1
        )
        ratings = [
            min(max(int(o.rating), 0), self.max_rating) for o in outs
        ]
        return float(np.mean(ratings)) / self.max_rating


class AnswerAccuracy(_DualRatingMetric):
    name: ClassVar[str] = "nv_accuracy"
    required_columns: ClassVar[set] = {"user_input", "response", "reference"}
    rating_instruction: ClassVar[str] = (
        "Rate how well the response matches the reference answer for the "
        "question: 0 = inaccurate/off-topic, 2 = partially aligned, "
        "4 = fully aligned."
    )
    max_rating: ClassVar[int] = 4

    def _payload(self, s):
        return (
            f"Question: {s.user_input}\nReference: {s.reference}\n"
            f"Response: {s.response}"
        )


class ContextRelevance(_DualRatingMetric):
    name: ClassVar[str] = "nv_context_relevance"
    required_columns: ClassVar[set] = {"user_input", "retrieved_contexts"}
    rating_instruction: ClassVar[str] = (
        "Rate how relevant the retrieved context is to the question: "
        "0 = not relevant, 1 = partially relevant, 2 = fully relevant."
    )
    max_rating: ClassVar[int] = 2

    def _payload(self, s):
        ctx = "\n".join(s.retrieved_contexts)
        return f"Question: {s.user_input}\nContext: {ctx}"


class ResponseGroundedness(_DualRatingMetric):
    name: ClassVar[str] = "nv_response_groundedness"
    required_columns: ClassVar[set] = {"response", "retrieved_contexts"}
    rating_instruction: ClassVar[str] = (
        "Rate how grounded the response is in the context: 0 = not "
        "grounded, 1 = partially grounded, 2 = fully grounded."
    )
    max_rating: ClassVar[int] = 2

    def _payload(self, s):
        ctx = "\n".join(s.retrieved_contexts)
        return f"Context: {ctx}\nResponse: {s.response}"
