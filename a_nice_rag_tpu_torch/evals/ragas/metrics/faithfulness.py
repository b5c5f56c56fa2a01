"""Faithfulness: are the answer's claims supported by the retrieved context?

Pipeline parity with the reference's medical-domain fork
(ragas_modified/metrics/_faithfulness.py, clinical prompts at :36-126):
1. decompose the answer into self-contained clinical statements,
2. judge each statement against the context (NLI, verdict 1/0),
3. score = supported statements / total statements (NaN when none).
"""

from __future__ import annotations

from typing import ClassVar, List

import numpy as np
from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class StatementsIn(BaseModel):
    question: str
    answer: str


class StatementsOut(BaseModel):
    statements: List[str]


class StatementGeneratorPrompt(StructuredPrompt[StatementsIn, StatementsOut]):
    instruction = (
        "You are given a medical question and an answer drawn from "
        "clinical guidelines. Decompose the answer into short, fully "
        "self-contained statements, each one a single clinical claim "
        "understandable without pronouns or references to other "
        "statements. Ignore greetings and disclaimers."
    )
    input_model = StatementsIn
    output_model = StatementsOut
    examples = [
        (
            StatementsIn(
                question="How should stage 1 hypertension be managed in adults under 80?",
                answer=(
                    "Offer lifestyle advice first. If the patient also has "
                    "diabetes, start an ACE inhibitor."
                ),
            ),
            StatementsOut(
                statements=[
                    "Adults under 80 with stage 1 hypertension should first be offered lifestyle advice.",
                    "Adults under 80 with stage 1 hypertension and diabetes should be started on an ACE inhibitor.",
                ]
            ),
        ),
        (
            StatementsIn(
                question="What is the first-line medication for ADHD in children?",
                answer="Methylphenidate is the recommended first-line medication for children with ADHD.",
            ),
            StatementsOut(
                statements=[
                    "Methylphenidate is the recommended first-line medication for children with ADHD.",
                ]
            ),
        ),
    ]


class NLIIn(BaseModel):
    context: str
    statements: List[str]


class StatementVerdict(BaseModel):
    statement: str
    reason: str
    verdict: int = Field(description="1 if supported by the context else 0")


class NLIOut(BaseModel):
    verdicts: List[StatementVerdict]


class NLIPrompt(StructuredPrompt[NLIIn, NLIOut]):
    instruction = (
        "Judge each clinical statement strictly against the provided "
        "guideline context. Verdict 1 only when the statement can be "
        "directly inferred from the context; verdict 0 otherwise. Give a "
        "brief reason per statement."
    )
    input_model = NLIIn
    output_model = NLIOut
    examples = [
        (
            NLIIn(
                context=(
                    "Offer an ACE inhibitor or ARB to adults with "
                    "hypertension and type 2 diabetes."
                ),
                statements=[
                    "ACE inhibitors are offered to adults with hypertension and type 2 diabetes.",
                    "Beta blockers are first-line for hypertension with diabetes.",
                ],
            ),
            NLIOut(
                verdicts=[
                    StatementVerdict(
                        statement="ACE inhibitors are offered to adults with hypertension and type 2 diabetes.",
                        reason="Directly stated in the context.",
                        verdict=1,
                    ),
                    StatementVerdict(
                        statement="Beta blockers are first-line for hypertension with diabetes.",
                        reason="The context recommends ACE inhibitors or ARBs, not beta blockers.",
                        verdict=0,
                    ),
                ]
            ),
        )
    ]


class Faithfulness(MetricWithLLM, SingleTurnMetric):
    name: ClassVar[str] = "faithfulness"
    required_columns: ClassVar[set] = {
        "user_input",
        "response",
        "retrieved_contexts",
    }

    def __init__(self, llm=None):
        self.llm = llm
        self.statement_prompt = StatementGeneratorPrompt()
        self.nli_prompt = NLIPrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        statements_out = await self.statement_prompt.generate(
            self.llm,
            StatementsIn(question=sample.user_input, answer=sample.response),
        )
        statements = statements_out.statements
        if not statements:
            return float("nan")
        nli_out = await self.nli_prompt.generate(
            self.llm,
            NLIIn(
                context="\n".join(sample.retrieved_contexts),
                statements=statements,
            ),
        )
        verdicts = nli_out.verdicts
        if not verdicts:
            return float("nan")
        supported = sum(1 for v in verdicts if int(v.verdict) == 1)
        return supported / len(verdicts)
