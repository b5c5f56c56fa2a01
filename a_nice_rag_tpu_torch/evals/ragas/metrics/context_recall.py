"""Context recall: is everything the reference says retrievable from the
contexts? (ragas_modified/metrics/_context_recall.py)

The judge classifies each sentence of the reference answer as
attributable (1) or not (0) to the retrieved contexts; recall is the
attributed fraction. A non-LLM variant matches reference contexts to
retrieved ones by string similarity.
"""

from __future__ import annotations

from typing import ClassVar, List

from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    Metric,
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class RecallIn(BaseModel):
    question: str
    context: str
    answer: str


class SentenceAttribution(BaseModel):
    statement: str
    reason: str
    attributed: int = Field(description="1 if supported by context else 0")


class RecallOut(BaseModel):
    classifications: List[SentenceAttribution]


class RecallClassificationPrompt(StructuredPrompt[RecallIn, RecallOut]):
    instruction = (
        "Split the answer into its component statements and classify each "
        "as attributable to the given context (1) or not (0), with a "
        "brief reason. Use only the context to decide."
    )
    input_model = RecallIn
    output_model = RecallOut
    examples = [
        (
            RecallIn(
                question="How is stage 2 hypertension treated?",
                context=(
                    "Offer antihypertensive drug treatment to adults of any "
                    "age with stage 2 hypertension."
                ),
                answer=(
                    "Drug treatment is offered to adults with stage 2 "
                    "hypertension. Treatment starts with two drugs at once."
                ),
            ),
            RecallOut(
                classifications=[
                    SentenceAttribution(
                        statement="Drug treatment is offered to adults with stage 2 hypertension.",
                        reason="Stated directly in the context.",
                        attributed=1,
                    ),
                    SentenceAttribution(
                        statement="Treatment starts with two drugs at once.",
                        reason="The context says nothing about starting with two drugs.",
                        attributed=0,
                    ),
                ]
            ),
        )
    ]


class LLMContextRecall(MetricWithLLM, SingleTurnMetric):
    name: ClassVar[str] = "context_recall"
    required_columns: ClassVar[set] = {
        "user_input",
        "retrieved_contexts",
        "reference",
    }

    def __init__(self, llm=None):
        self.llm = llm
        self.prompt = RecallClassificationPrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        out = await self.prompt.generate(
            self.llm,
            RecallIn(
                question=sample.user_input,
                context="\n".join(sample.retrieved_contexts),
                answer=sample.reference,
            ),
        )
        if not out.classifications:
            return float("nan")
        hits = sum(1 for c in out.classifications if int(c.attributed) == 1)
        return hits / len(out.classifications)


class ContextRecall(LLMContextRecall):
    """Upstream alias."""


class NonLLMContextRecall(SingleTurnMetric):
    name: ClassVar[str] = "non_llm_context_recall"
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

        if not sample.reference_contexts:
            return float("nan")
        hits = 0
        for ref in sample.reference_contexts:
            best = max(
                (string_similarity(ref, ctx)
                 for ctx in sample.retrieved_contexts),
                default=0.0,
            )
            hits += int(best >= self.threshold)
        return hits / len(sample.reference_contexts)
