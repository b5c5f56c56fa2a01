"""Remaining metric-surface parity pieces: SQL semantic equivalence,
tabular-data comparison, and instance-specific rubrics
(ragas_modified/metrics/_sql_semantic_equivalence.py,
_datacompy_score.py, _instance_specific_rubrics.py).
"""

from __future__ import annotations

import io
from typing import ClassVar

from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.rubrics import RubricsScore
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class SQLEquivIn(BaseModel):
    reference_sql: str
    candidate_sql: str
    schema_description: str


class SQLEquivOut(BaseModel):
    reason: str
    equivalent: int = Field(description="1 if semantically equivalent")


class SQLEquivalencePrompt(StructuredPrompt[SQLEquivIn, SQLEquivOut]):
    instruction = (
        "Judge whether the two SQL queries are semantically equivalent "
        "over the described schema (same result set for any data)."
    )
    input_model = SQLEquivIn
    output_model = SQLEquivOut
    examples = []


class LLMSQLEquivalence(MetricWithLLM, SingleTurnMetric):
    name: ClassVar[str] = "llm_sql_equivalence_with_reference"
    required_columns: ClassVar[set] = {
        "response",
        "reference",
        "reference_contexts",
    }

    def __init__(self, llm=None):
        self.llm = llm
        self.prompt = SQLEquivalencePrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        out = await self.prompt.generate(
            self.llm,
            SQLEquivIn(
                reference_sql=sample.reference,
                candidate_sql=sample.response,
                schema_description="\n".join(sample.reference_contexts),
            ),
        )
        return float(int(out.equivalent))


class DataCompyScore(SingleTurnMetric):
    """Row-level precision/recall/F1 between two CSV tables (response vs
    reference), matched on full-row equality — a dependency-free
    equivalent of the datacompy comparison."""

    name: ClassVar[str] = "data_compare_score"
    required_columns: ClassVar[set] = {"response", "reference"}

    def __init__(self, mode: str = "row", metric: str = "f1"):
        assert metric in ("precision", "recall", "f1")
        self.metric = metric

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        import pandas as pd

        try:
            got = pd.read_csv(io.StringIO(sample.response))
            ref = pd.read_csv(io.StringIO(sample.reference))
        except Exception:  # noqa: BLE001 — unparseable tables score 0
            return 0.0
        cols = [c for c in ref.columns if c in got.columns]
        if not cols:
            return 0.0
        got_rows = {tuple(r) for r in got[cols].itertuples(index=False)}
        ref_rows = {tuple(r) for r in ref[cols].itertuples(index=False)}
        if not got_rows or not ref_rows:
            return 0.0
        inter = len(got_rows & ref_rows)
        precision = inter / len(got_rows)
        recall = inter / len(ref_rows)
        if self.metric == "precision":
            return precision
        if self.metric == "recall":
            return recall
        if precision + recall == 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)


class InstanceRubrics(RubricsScore):
    """Per-sample rubrics (sample.rubrics) instead of metric-level ones."""

    name: ClassVar[str] = "instance_rubrics"
    required_columns: ClassVar[set] = {"user_input", "response", "rubrics"}
