"""Evaluation dataset schema and result container.

Pydantic sample/dataset/result types with the reference's column
vocabulary (ragas_modified/dataset_schema.py: user_input,
retrieved_contexts, response, reference, ...), pandas import/export, and
an EvaluationResult with per-metric score lists, traces, and cost.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, field_validator


class SingleTurnSample(BaseModel):
    user_input: Optional[str] = None
    retrieved_contexts: Optional[List[str]] = None
    reference_contexts: Optional[List[str]] = None
    response: Optional[str] = None
    multi_responses: Optional[List[str]] = None
    reference: Optional[str] = None
    rubrics: Optional[Dict[str, str]] = None

    def get_features(self) -> List[str]:
        return [k for k, v in self.model_dump().items() if v is not None]


class Message(BaseModel):
    """Flat conversation turn. The typed subclasses below mirror the
    reference's message hierarchy
    (ragas_modified/messages.py:6-134) for the agentic metrics; this
    base stays accepted everywhere for plain role/content transcripts."""

    role: str
    content: str
    metadata: Optional[Dict[str, Any]] = None


class ToolCall(BaseModel):
    """A named tool invocation with its argument dict
    (ragas_modified/messages.py:22-36)."""

    name: str
    args: Dict[str, Any]


class HumanMessage(Message):
    """User turn (ragas_modified/messages.py:39-58)."""

    role: str = "human"
    type: str = "human"

    def pretty_repr(self) -> str:
        return f"Human: {self.content}"


class ToolMessage(Message):
    """Tool output turn (ragas_modified/messages.py:61-79)."""

    role: str = "tool"
    type: str = "tool"

    def pretty_repr(self) -> str:
        return f"ToolOutput: {self.content}"


class AIMessage(Message):
    """Assistant turn, optionally carrying typed tool calls
    (ragas_modified/messages.py:82-134)."""

    role: str = "ai"
    type: str = "ai"
    tool_calls: Optional[List[ToolCall]] = None

    def to_dict(self, **kwargs) -> Dict[str, Any]:
        content: Any = (
            self.content
            if self.tool_calls is None
            else {
                "text": self.content,
                "tool_calls": [tc.model_dump() for tc in self.tool_calls],
            }
        )
        return {"content": content, "type": self.type}

    def pretty_repr(self) -> str:
        lines = []
        if self.content != "":
            lines.append(f"AI: {self.content}")
        if self.tool_calls is not None:
            lines.append("Tools:")
            for tc in self.tool_calls:
                lines.append(f"  {tc.name}: {tc.args}")
        return "\n".join(lines)


# Subclasses FIRST: pydantic validates List[AnyMessage] left-to-right,
# and a bare Message annotation would coerce an AIMessage down to the
# base class, silently dropping its tool_calls.
AnyMessage = Union[HumanMessage, AIMessage, ToolMessage, Message]


class MultiTurnSample(BaseModel):
    user_input: List[AnyMessage]
    reference: Optional[str] = None
    reference_tool_calls: Optional[List[Dict[str, Any]]] = None
    rubrics: Optional[Dict[str, str]] = None

    @field_validator("user_input", mode="before")
    @classmethod
    def _route_dicts(cls, v):
        """Dicts route to the typed class by their type/role key —
        pydantic's left-to-right union would otherwise make every dict
        a HumanMessage (whose role field accepts any string)."""
        if not isinstance(v, list):
            return v
        routed = []
        by_kind = {
            "human": HumanMessage, "user": HumanMessage,
            "ai": AIMessage, "assistant": AIMessage,
            "tool": ToolMessage,
        }
        for m in v:
            if isinstance(m, dict):
                kind = m.get("type") or m.get("role")
                routed.append(by_kind.get(kind, Message)(**m))
            else:
                routed.append(m)
        return routed

    def pretty_repr(self) -> str:
        return "\n".join(
            m.pretty_repr()
            if hasattr(m, "pretty_repr")
            else f"{m.role}: {m.content}"
            for m in self.user_input
        )


Sample = Union[SingleTurnSample, MultiTurnSample]


class EvaluationDataset:
    def __init__(self, samples: Sequence[Sample]):
        if not samples:
            raise ValueError("EvaluationDataset requires at least one sample")
        kinds = {type(s) for s in samples}
        if len(kinds) > 1:
            raise ValueError("All samples must be the same type")
        self.samples: List[Sample] = list(samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def is_multi_turn(self) -> bool:
        return isinstance(self.samples[0], MultiTurnSample)

    @classmethod
    def from_list(cls, rows: Sequence[Dict]) -> "EvaluationDataset":
        return cls([SingleTurnSample(**row) for row in rows])

    @classmethod
    def from_pandas(cls, df) -> "EvaluationDataset":
        return cls.from_list(df.to_dict("records"))

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame([s.model_dump() for s in self.samples])


class EvaluationResult:
    """Per-sample, per-metric scores with aggregate view."""

    def __init__(
        self,
        scores: List[Dict[str, float]],
        dataset: Optional[EvaluationDataset] = None,
        traces: Optional[List[Dict]] = None,
        cost: Optional[Dict] = None,
    ):
        self.scores = scores
        self.dataset = dataset
        self.traces = traces or []
        self.cost = cost
        self._scores_dict: Dict[str, List[float]] = {}
        for row in scores:
            for name, value in row.items():
                self._scores_dict.setdefault(name, []).append(value)

    def __getitem__(self, metric: str) -> List[float]:
        return self._scores_dict[metric]

    def aggregate(self) -> Dict[str, float]:
        return {
            name: float(np.nanmean(vals)) if len(vals) else float("nan")
            for name, vals in self._scores_dict.items()
        }

    def __repr__(self) -> str:
        agg = ", ".join(f"'{k}': {v:.4f}" for k, v in self.aggregate().items())
        return "{" + agg + "}"

    def to_pandas(self):
        import pandas as pd

        base = (
            self.dataset.to_pandas()
            if self.dataset is not None
            else pd.DataFrame()
        )
        for name, vals in self._scores_dict.items():
            base[name] = vals
        return base
