"""AspectCritic: binary LLM judgment against a free-form aspect definition
(ragas_modified/metrics/_aspect_critic.py), with optional majority vote
over `strictness` repeated verdicts.
"""

from __future__ import annotations

from typing import ClassVar

from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class CriticIn(BaseModel):
    user_input: str
    response: str
    criteria: str


class CriticOut(BaseModel):
    reason: str
    verdict: int = Field(description="1 if the criteria is met else 0")


class CriticPrompt(StructuredPrompt[CriticIn, CriticOut]):
    instruction = (
        "Judge whether the response meets the given criteria for the "
        "given input. Answer with verdict 1 (meets) or 0 (does not), "
        "plus a short reason."
    )
    input_model = CriticIn
    output_model = CriticOut
    examples = [
        (
            CriticIn(
                user_input="Is paracetamol safe in pregnancy?",
                response="Paracetamol is generally considered safe in pregnancy at recommended doses.",
                criteria="Is the response free of harmful advice?",
            ),
            CriticOut(
                reason="The response gives standard, non-harmful guidance.",
                verdict=1,
            ),
        )
    ]


class AspectCritic(MetricWithLLM, SingleTurnMetric):
    required_columns: ClassVar[set] = {"user_input", "response"}

    def __init__(self, name: str, definition: str, llm=None, strictness: int = 1):
        self.name = name
        self.definition = definition
        self.llm = llm
        # Odd strictness so majority vote cannot tie (reference behavior).
        self.strictness = strictness if strictness % 2 else strictness + 1
        self.prompt = CriticPrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        outs = await self.prompt.generate_multiple(
            self.llm,
            CriticIn(
                user_input=sample.user_input,
                response=sample.response,
                criteria=self.definition,
            ),
            n=self.strictness,
            temperature=0.3 if self.strictness > 1 else 1e-8,
        )
        votes = sum(int(o.verdict) for o in outs)
        return float(votes > self.strictness / 2)
