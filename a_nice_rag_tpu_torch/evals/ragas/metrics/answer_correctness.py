"""Answer correctness and factual correctness.

* AnswerCorrectness (ragas_modified/metrics/_answer_correctness.py):
  classify answer/reference statements into TP (in both), FP (answer
  only), FN (reference only); factuality F1 blended with semantic
  similarity by configurable weights (default 0.75/0.25).
* FactualCorrectness (_factual_correctness.py): claim decomposition +
  NLI verification, reported as precision, recall, or F1.
"""

from __future__ import annotations

from typing import ClassVar, List, Optional

import numpy as np
from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithEmbeddings,
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class ClassifyIn(BaseModel):
    question: str
    answer: str
    ground_truth: str


class StatementGroups(BaseModel):
    TP: List[str] = Field(default_factory=list)
    FP: List[str] = Field(default_factory=list)
    FN: List[str] = Field(default_factory=list)


class CorrectnessPrompt(StructuredPrompt[ClassifyIn, StatementGroups]):
    instruction = (
        "Compare the answer with the ground truth for the question. "
        "Classify each factual statement into: TP (present in both "
        "answer and ground truth), FP (in the answer but not the ground "
        "truth), FN (in the ground truth but missing from the answer)."
    )
    input_model = ClassifyIn
    output_model = StatementGroups
    examples = [
        (
            ClassifyIn(
                question="What is the BP target for treated adults under 80?",
                answer="Below 140/90 mmHg, checked annually.",
                ground_truth="Below 140/90 mmHg for adults under 80.",
            ),
            StatementGroups(
                TP=["The target is below 140/90 mmHg."],
                FP=["Blood pressure is checked annually."],
                FN=["The target applies to adults under 80."],
            ),
        )
    ]


class AnswerCorrectness(MetricWithLLM, MetricWithEmbeddings, SingleTurnMetric):
    name: ClassVar[str] = "answer_correctness"
    required_columns: ClassVar[set] = {"user_input", "response", "reference"}

    def __init__(self, llm=None, embeddings=None,
                 weights: Optional[List[float]] = None):
        self.llm = llm
        self.embeddings = embeddings
        self.weights = weights or [0.75, 0.25]
        self.prompt = CorrectnessPrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        groups = await self.prompt.generate(
            self.llm,
            ClassifyIn(
                question=sample.user_input,
                answer=sample.response,
                ground_truth=sample.reference,
            ),
        )
        tp, fp, fn = len(groups.TP), len(groups.FP), len(groups.FN)
        f1 = tp / (tp + 0.5 * (fp + fn)) if (tp + fp + fn) else float("nan")
        if self.weights[1] == 0:
            return f1
        vecs = await self.embeddings.aembed_texts(
            [sample.response, sample.reference]
        )
        a, b = np.asarray(vecs[0]), np.asarray(vecs[1])
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        sim = float(a @ b / denom) if denom else 0.0
        w = self.weights
        return (w[0] * f1 + w[1] * sim) / (w[0] + w[1])


class ClaimsIn(BaseModel):
    text: str


class ClaimsOut(BaseModel):
    claims: List[str]


class ClaimDecompositionPrompt(StructuredPrompt[ClaimsIn, ClaimsOut]):
    instruction = (
        "Break the text into standalone factual claims, one claim per "
        "entry, each understandable on its own."
    )
    input_model = ClaimsIn
    output_model = ClaimsOut
    examples = [
        (
            ClaimsIn(text="Offer an ACE inhibitor. Review after 4 weeks."),
            ClaimsOut(
                claims=[
                    "An ACE inhibitor should be offered.",
                    "A review should happen after 4 weeks.",
                ]
            ),
        )
    ]


class VerifyIn(BaseModel):
    premise: str
    claims: List[str]


class ClaimVerdict(BaseModel):
    claim: str
    verdict: int = Field(description="1 if the premise supports the claim")


class VerifyOut(BaseModel):
    verdicts: List[ClaimVerdict]


class ClaimVerificationPrompt(StructuredPrompt[VerifyIn, VerifyOut]):
    instruction = (
        "For each claim, verdict 1 if it can be inferred from the "
        "premise, else 0."
    )
    input_model = VerifyIn
    output_model = VerifyOut
    examples = []


class FactualCorrectness(MetricWithLLM, SingleTurnMetric):
    name: ClassVar[str] = "factual_correctness"
    required_columns: ClassVar[set] = {"response", "reference"}

    def __init__(self, llm=None, mode: str = "f1"):
        assert mode in ("precision", "recall", "f1")
        self.llm = llm
        self.mode = mode
        self.decompose = ClaimDecompositionPrompt()
        self.verify = ClaimVerificationPrompt()

    async def _verified_fraction(self, premise: str, text: str) -> float:
        claims = (
            await self.decompose.generate(self.llm, ClaimsIn(text=text))
        ).claims
        if not claims:
            return float("nan")
        out = await self.verify.generate(
            self.llm, VerifyIn(premise=premise, claims=claims)
        )
        if not out.verdicts:
            return float("nan")
        return sum(int(v.verdict) for v in out.verdicts) / len(out.verdicts)

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        precision = await self._verified_fraction(
            sample.reference, sample.response
        )
        if self.mode == "precision":
            return precision
        recall = await self._verified_fraction(
            sample.response, sample.reference
        )
        if self.mode == "recall":
            return recall
        if np.isnan(precision) or np.isnan(recall) or precision + recall == 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)
