"""SummarizationScore (ragas_modified/metrics/_summarization.py):
QA-based summary quality — extract keyphrases from the source, turn
them into yes-questions, answer them from the summary; score = correct
fraction, optionally blended with a conciseness term.
"""

from __future__ import annotations

from typing import ClassVar, List

from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class KeyphrasesIn(BaseModel):
    text: str


class KeyphrasesOut(BaseModel):
    keyphrases: List[str]


class KeyphrasePrompt(StructuredPrompt[KeyphrasesIn, KeyphrasesOut]):
    instruction = "Extract the important keyphrases from the text."
    input_model = KeyphrasesIn
    output_model = KeyphrasesOut
    examples = []


class QGenIn(BaseModel):
    text: str
    keyphrases: List[str]


class QGenOut(BaseModel):
    questions: List[str]


class QuestionsPrompt(StructuredPrompt[QGenIn, QGenOut]):
    instruction = (
        "For each keyphrase write one question about the text whose "
        "correct answer is 'yes' (a '1')."
    )
    input_model = QGenIn
    output_model = QGenOut
    examples = []


class QAIn(BaseModel):
    summary: str
    questions: List[str]


class QAOut(BaseModel):
    answers: List[int] = Field(
        description="1 if the summary supports a yes answer, else 0"
    )


class AnswersPrompt(StructuredPrompt[QAIn, QAOut]):
    instruction = (
        "Answer each question using ONLY the summary: 1 when the summary "
        "supports a yes answer, 0 otherwise."
    )
    input_model = QAIn
    output_model = QAOut
    examples = []


class SummarizationScore(MetricWithLLM, SingleTurnMetric):
    name: ClassVar[str] = "summary_score"
    required_columns: ClassVar[set] = {"reference_contexts", "response"}

    def __init__(self, llm=None, length_penalty: bool = True,
                 coeff: float = 0.5):
        self.llm = llm
        self.length_penalty = length_penalty
        self.coeff = coeff
        self.keyphrases = KeyphrasePrompt()
        self.questions = QuestionsPrompt()
        self.answers = AnswersPrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        text = "\n".join(sample.reference_contexts)
        kps = (
            await self.keyphrases.generate(self.llm, KeyphrasesIn(text=text))
        ).keyphrases
        if not kps:
            return float("nan")
        qs = (
            await self.questions.generate(
                self.llm, QGenIn(text=text, keyphrases=kps)
            )
        ).questions
        if not qs:
            return float("nan")
        ans = (
            await self.answers.generate(
                self.llm, QAIn(summary=sample.response, questions=qs)
            )
        ).answers
        if not ans:
            return float("nan")
        qa_score = sum(1 for a in ans if int(a) == 1) / len(ans)
        if not self.length_penalty:
            return qa_score
        conciseness = 1.0 - min(len(sample.response), len(text)) / (
            len(text) + 1e-10
        )
        return self.coeff * conciseness + (1 - self.coeff) * qa_score
