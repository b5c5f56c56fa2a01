"""Response/answer relevancy.

Pipeline parity with the reference's NICE-modified metric
(ragas_modified/metrics/_answer_relevance.py): generate `strictness`
questions the answer would be a complete response to, flag noncommittal
answers (the modified prompt treats "No relevant NICE guidelines were
found" as noncommittal, :39), embed generated vs original question, and
score the mean PLAIN DOT PRODUCT (the reference fork removes the norm
division, assuming unit-norm embeddings, :105-113), zeroed when any
generated turn is noncommittal. Reference strictness default is 1
(modified from upstream's 3, :103).
"""

from __future__ import annotations

from typing import ClassVar

import numpy as np
from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithEmbeddings,
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt

NOT_FOUND_SENTENCE = "No relevant NICE guidelines were found"


class GenQuestionIn(BaseModel):
    response: str


class GenQuestionOut(BaseModel):
    question: str
    noncommittal: int = Field(
        description="1 if the answer is evasive/noncommittal, else 0"
    )


class QuestionGenerationPrompt(StructuredPrompt[GenQuestionIn, GenQuestionOut]):
    instruction = (
        "Given an answer produced from NICE clinical guidelines, write "
        "the single clinical question this answer most completely "
        "responds to. Also set noncommittal=1 when the answer is "
        "evasive, vague, or states that no relevant guidance exists "
        '(for example "No relevant NICE guidelines were found"); '
        "otherwise 0."
    )
    input_model = GenQuestionIn
    output_model = GenQuestionOut
    examples = [
        (
            GenQuestionIn(
                response=(
                    "Offer antihypertensive drug treatment in addition to "
                    "lifestyle advice to adults under 80 with persistent "
                    "stage 2 hypertension."
                )
            ),
            GenQuestionOut(
                question="When should drug treatment be offered for stage 2 hypertension in adults under 80?",
                noncommittal=0,
            ),
        ),
        (
            GenQuestionIn(response="No relevant NICE guidelines were found."),
            GenQuestionOut(
                question="What do NICE guidelines recommend for this condition?",
                noncommittal=1,
            ),
        ),
    ]


class ResponseRelevancy(MetricWithLLM, MetricWithEmbeddings, SingleTurnMetric):
    name: ClassVar[str] = "answer_relevancy"
    required_columns: ClassVar[set] = {"user_input", "response"}

    def __init__(self, llm=None, embeddings=None, strictness: int = 1):
        self.llm = llm
        self.embeddings = embeddings
        self.strictness = strictness
        self.question_prompt = QuestionGenerationPrompt()

    def calculate_similarity(
        self, question_vec: np.ndarray, generated_vecs: np.ndarray
    ) -> np.ndarray:
        # Plain dot product (reference modification: unit-norm assumption).
        return generated_vecs @ np.asarray(question_vec).reshape(-1)

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        gens = await self.question_prompt.generate_multiple(
            self.llm,
            GenQuestionIn(response=sample.response),
            n=self.strictness,
            temperature=0.2 if self.strictness > 1 else 1e-8,
        )
        questions = [g.question for g in gens]
        if not any(q for q in questions):
            return float("nan")
        noncommittal = any(int(g.noncommittal) for g in gens)
        q_vec = await self.embeddings.aembed_query(sample.user_input)
        gen_vecs = await self.embeddings.aembed_texts(questions)
        sims = self.calculate_similarity(q_vec, gen_vecs)
        return float(sims.mean()) * int(not noncommittal)


class AnswerRelevancy(ResponseRelevancy):
    """Upstream alias kept for API parity."""
