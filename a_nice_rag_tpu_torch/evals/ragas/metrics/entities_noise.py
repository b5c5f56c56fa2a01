"""ContextEntityRecall and NoiseSensitivity
(ragas_modified/metrics/_context_entities_recall.py, _noise_sensitivity.py).
"""

from __future__ import annotations

from typing import ClassVar, List

import numpy as np
from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.faithfulness import (
    NLIIn,
    NLIPrompt,
    StatementGeneratorPrompt,
    StatementsIn,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class EntitiesIn(BaseModel):
    text: str


class EntitiesOut(BaseModel):
    entities: List[str]


class EntityExtractionPrompt(StructuredPrompt[EntitiesIn, EntitiesOut]):
    instruction = (
        "Extract the named entities (conditions, drugs, organizations, "
        "thresholds, ages, places) mentioned in the text."
    )
    input_model = EntitiesIn
    output_model = EntitiesOut
    examples = [
        (
            EntitiesIn(
                text="NICE recommends metformin for type 2 diabetes in adults."
            ),
            EntitiesOut(entities=["NICE", "metformin", "type 2 diabetes",
                                  "adults"]),
        )
    ]


class ContextEntityRecall(MetricWithLLM, SingleTurnMetric):
    """|entities(contexts) ∩ entities(reference)| / |entities(reference)|."""

    name: ClassVar[str] = "context_entity_recall"
    required_columns: ClassVar[set] = {"reference", "retrieved_contexts"}

    def __init__(self, llm=None):
        self.llm = llm
        self.prompt = EntityExtractionPrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        ref = await self.prompt.generate(
            self.llm, EntitiesIn(text=sample.reference)
        )
        ctx = await self.prompt.generate(
            self.llm, EntitiesIn(text="\n".join(sample.retrieved_contexts))
        )
        ref_set = {e.lower() for e in ref.entities}
        ctx_set = {e.lower() for e in ctx.entities}
        if not ref_set:
            return float("nan")
        return len(ref_set & ctx_set) / len(ref_set)


class NoiseSensitivity(MetricWithLLM, SingleTurnMetric):
    """How often does the model make WRONG claims because of retrieved
    noise? Decompose the response into statements; a statement counts
    against the score when it is supported by the retrieved contexts but
    NOT by the ground-truth reference (mode='relevant'), or unsupported
    by the contexts entirely (mode='irrelevant')."""

    name: ClassVar[str] = "noise_sensitivity"
    required_columns: ClassVar[set] = {
        "user_input",
        "response",
        "reference",
        "retrieved_contexts",
    }

    def __init__(self, llm=None, mode: str = "relevant"):
        assert mode in ("relevant", "irrelevant")
        self.llm = llm
        self.mode = mode
        self.statement_prompt = StatementGeneratorPrompt()
        self.nli_prompt = NLIPrompt()

    async def _verdicts(self, context: str, statements: List[str]):
        out = await self.nli_prompt.generate(
            self.llm, NLIIn(context=context, statements=statements)
        )
        return np.array([int(v.verdict) for v in out.verdicts], dtype=bool)

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        statements = (
            await self.statement_prompt.generate(
                self.llm,
                StatementsIn(
                    question=sample.user_input, answer=sample.response
                ),
            )
        ).statements
        if not statements:
            return float("nan")
        in_ctx = await self._verdicts(
            "\n".join(sample.retrieved_contexts), statements
        )
        in_ref = await self._verdicts(sample.reference, statements)
        n = min(len(in_ctx), len(in_ref), len(statements))
        if n == 0:
            return float("nan")
        in_ctx, in_ref = in_ctx[:n], in_ref[:n]
        if self.mode == "relevant":
            noisy = in_ctx & ~in_ref
        else:
            noisy = ~in_ctx & ~in_ref
        return float(noisy.sum()) / n
