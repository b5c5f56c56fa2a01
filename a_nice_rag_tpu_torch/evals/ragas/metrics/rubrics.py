"""Rubric-based scoring (ragas_modified/metrics/_domain_specific_rubrics.py
and _simple_criteria.py): the judge scores 1-5 against per-score rubric
descriptions, or an integer range against a single criteria definition.
"""

from __future__ import annotations

from typing import ClassVar, Dict, Optional

from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt

DEFAULT_RUBRICS: Dict[str, str] = {
    "score1_description": "The response is entirely incorrect or unrelated to the question.",
    "score2_description": "The response is mostly incorrect with minor relevant fragments.",
    "score3_description": "The response is partially correct but incomplete or imprecise.",
    "score4_description": "The response is mostly correct and complete with minor issues.",
    "score5_description": "The response is fully correct, complete, and precise.",
}


class RubricIn(BaseModel):
    user_input: str
    response: str
    reference: Optional[str] = None
    rubrics: Dict[str, str]


class RubricOut(BaseModel):
    reason: str
    score: int = Field(description="The rubric score (1-5)")


class RubricPrompt(StructuredPrompt[RubricIn, RubricOut]):
    instruction = (
        "Score the response against the rubric descriptions (choose the "
        "single best-matching score), using the reference when given."
    )
    input_model = RubricIn
    output_model = RubricOut
    examples = []


class RubricsScore(MetricWithLLM, SingleTurnMetric):
    name: ClassVar[str] = "rubrics_score"
    required_columns: ClassVar[set] = {"user_input", "response"}

    def __init__(self, rubrics: Optional[Dict[str, str]] = None, llm=None):
        self.llm = llm
        self.rubrics = rubrics or DEFAULT_RUBRICS
        self.prompt = RubricPrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        out = await self.prompt.generate(
            self.llm,
            RubricIn(
                user_input=sample.user_input,
                response=sample.response,
                reference=sample.reference,
                rubrics=sample.rubrics or self.rubrics,
            ),
        )
        return float(out.score)


class CriteriaIn(BaseModel):
    user_input: str
    response: str
    reference: Optional[str] = None
    definition: str


class CriteriaOut(BaseModel):
    reason: str
    score: int


class CriteriaPrompt(StructuredPrompt[CriteriaIn, CriteriaOut]):
    instruction = (
        "Score the response on an integer scale according to the given "
        "criteria definition."
    )
    input_model = CriteriaIn
    output_model = CriteriaOut
    examples = []


class SimpleCriteriaScore(MetricWithLLM, SingleTurnMetric):
    required_columns: ClassVar[set] = {"user_input", "response"}

    def __init__(self, name: str, definition: str, llm=None):
        self.name = name
        self.definition = definition
        self.llm = llm
        self.prompt = CriteriaPrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        out = await self.prompt.generate(
            self.llm,
            CriteriaIn(
                user_input=sample.user_input,
                response=sample.response,
                reference=sample.reference,
                definition=self.definition,
            ),
        )
        return float(out.score)
