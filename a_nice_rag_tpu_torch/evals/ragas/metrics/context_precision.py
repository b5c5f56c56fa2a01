"""Context precision: are the useful chunks ranked at the top?

Parity with ragas_modified/metrics/_context_precision.py (NICE-domain
few-shot at :62): the judge marks each retrieved context useful/not for
arriving at the reference (or response), and the score is the mean of
precision@k over the positions of useful chunks (average precision).
"""

from __future__ import annotations

from typing import ClassVar, List

import numpy as np
from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    Metric,
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class UsefulnessIn(BaseModel):
    question: str
    context: str
    answer: str


class UsefulnessOut(BaseModel):
    reason: str
    verdict: int = Field(description="1 if the context was useful, else 0")


class ContextUsefulnessPrompt(StructuredPrompt[UsefulnessIn, UsefulnessOut]):
    instruction = (
        "Decide whether the given guideline context was useful in "
        "arriving at the given answer to the clinical question. "
        "Verdict 1 for useful, 0 for not useful, with a brief reason."
    )
    input_model = UsefulnessIn
    output_model = UsefulnessOut
    examples = [
        (
            UsefulnessIn(
                question="What is the target blood pressure for adults under 80 on treatment?",
                context=(
                    "Reduce and maintain blood pressure below 140/90 mmHg "
                    "in adults under 80 with treated hypertension."
                ),
                answer="Below 140/90 mmHg for adults under 80.",
            ),
            UsefulnessOut(
                reason="The context states the exact target used in the answer.",
                verdict=1,
            ),
        ),
        (
            UsefulnessIn(
                question="What is the target blood pressure for adults under 80 on treatment?",
                context="ADHD is a neurodevelopmental condition.",
                answer="Below 140/90 mmHg for adults under 80.",
            ),
            UsefulnessOut(
                reason="The context is about an unrelated condition.",
                verdict=0,
            ),
        ),
    ]


def _average_precision(verdicts: List[int]) -> float:
    verdicts = [int(v) for v in verdicts]
    denominator = sum(verdicts)
    if denominator == 0:
        return 0.0
    score = 0.0
    hits = 0
    for i, v in enumerate(verdicts, start=1):
        if v:
            hits += 1
            score += hits / i
    return score / denominator


class LLMContextPrecisionWithReference(MetricWithLLM, SingleTurnMetric):
    """Usefulness judged against the reference answer."""

    name: ClassVar[str] = "llm_context_precision_with_reference"
    required_columns: ClassVar[set] = {
        "user_input",
        "retrieved_contexts",
        "reference",
    }

    def __init__(self, llm=None):
        self.llm = llm
        self.prompt = ContextUsefulnessPrompt()

    def _target(self, sample: SingleTurnSample) -> str:
        return sample.reference

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        verdicts = []
        for ctx in sample.retrieved_contexts:
            out = await self.prompt.generate(
                self.llm,
                UsefulnessIn(
                    question=sample.user_input,
                    context=ctx,
                    answer=self._target(sample),
                ),
            )
            verdicts.append(int(out.verdict))
        if not verdicts:
            return float("nan")
        return _average_precision(verdicts)


class LLMContextPrecisionWithoutReference(LLMContextPrecisionWithReference):
    """Usefulness judged against the generated response instead."""

    name: ClassVar[str] = "llm_context_precision_without_reference"
    required_columns: ClassVar[set] = {
        "user_input",
        "retrieved_contexts",
        "response",
    }

    def _target(self, sample: SingleTurnSample) -> str:
        return sample.response


class ContextPrecision(LLMContextPrecisionWithReference):
    """Upstream alias."""

    name: ClassVar[str] = "context_precision"


class ContextUtilization(LLMContextPrecisionWithoutReference):
    """Upstream alias (precision against the generated response)."""

    name: ClassVar[str] = "context_utilization"


class NonLLMContextPrecisionWithReference(SingleTurnMetric):
    """String-similarity variant: retrieved vs reference contexts."""

    name: ClassVar[str] = "non_llm_context_precision_with_reference"
    required_columns: ClassVar[set] = {
        "retrieved_contexts",
        "reference_contexts",
    }

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        from a_nice_rag_tpu_torch.evals.ragas.metrics.string_metrics import (
            string_similarity,
        )

        verdicts = []
        for ctx in sample.retrieved_contexts:
            best = max(
                string_similarity(ctx, ref)
                for ref in sample.reference_contexts
            )
            verdicts.append(int(best >= self.threshold))
        if not verdicts:
            return float("nan")
        return _average_precision(verdicts)
