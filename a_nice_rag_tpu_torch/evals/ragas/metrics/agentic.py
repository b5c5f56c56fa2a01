"""Agentic / multi-turn metrics (ragas_modified/metrics/_goal_accuracy.py,
_tool_call_accuracy.py, _topic_adherence.py): goal accuracy with/without
reference, tool-call accuracy against reference calls, and topic
adherence over a reference topic list.
"""

from __future__ import annotations

from typing import ClassVar, List

from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, Field

from a_nice_rag_tpu_torch.evals.ragas.dataset import MultiTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithLLM,
    MultiTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


class GoalIn(BaseModel):
    conversation: str
    goal: str


class GoalOut(BaseModel):
    reason: str
    achieved: int = Field(description="1 if the goal was achieved else 0")


class GoalJudgePrompt(StructuredPrompt[GoalIn, GoalOut]):
    instruction = (
        "Given a conversation transcript and the user's goal, judge "
        "whether the goal was achieved by the end (1) or not (0)."
    )
    input_model = GoalIn
    output_model = GoalOut
    examples = []


class GoalExtractIn(BaseModel):
    conversation: str


class GoalExtractOut(BaseModel):
    goal: str


class GoalExtractPrompt(StructuredPrompt[GoalExtractIn, GoalExtractOut]):
    instruction = "State the user's end goal implied by this conversation."
    input_model = GoalExtractIn
    output_model = GoalExtractOut
    examples = []


class AgentGoalAccuracyWithReference(MetricWithLLM, MultiTurnMetric):
    name: ClassVar[str] = "agent_goal_accuracy"
    required_columns: ClassVar[set] = set()

    def __init__(self, llm=None):
        self.llm = llm
        self.judge = GoalJudgePrompt()

    async def _multi_turn_ascore(self, sample: MultiTurnSample) -> float:
        out = await self.judge.generate(
            self.llm,
            GoalIn(conversation=sample.pretty_repr(), goal=sample.reference),
        )
        return float(int(out.achieved))


class AgentGoalAccuracyWithoutReference(MetricWithLLM, MultiTurnMetric):
    name: ClassVar[str] = "agent_goal_accuracy_without_reference"
    required_columns: ClassVar[set] = set()

    def __init__(self, llm=None):
        self.llm = llm
        self.extract = GoalExtractPrompt()
        self.judge = GoalJudgePrompt()

    async def _multi_turn_ascore(self, sample: MultiTurnSample) -> float:
        convo = sample.pretty_repr()
        goal = (
            await self.extract.generate(self.llm, GoalExtractIn(conversation=convo))
        ).goal
        out = await self.judge.generate(
            self.llm, GoalIn(conversation=convo, goal=goal)
        )
        return float(int(out.achieved))


class ToolCallAccuracy(MultiTurnMetric):
    """Sequence-aligned comparison of performed tool calls vs reference
    calls: name match gates the score, argument overlap scales it."""

    name: ClassVar[str] = "tool_call_accuracy"
    required_columns: ClassVar[set] = set()

    async def _multi_turn_ascore(self, sample: MultiTurnSample) -> float:
        performed = []
        for m in sample.user_input:
            # Typed AIMessage.tool_calls is the native channel
            # (reference ragas_modified/messages.py:82-134); the
            # role="tool_call" JSON-in-content form is kept as a
            # fallback for flat transcripts.
            for tc in getattr(m, "tool_calls", None) or []:
                performed.append({"name": tc.name, "args": tc.args})
            if m.role == "tool_call":
                import json

                try:
                    performed.append(json.loads(m.content))
                except ValueError:
                    performed.append({"name": m.content, "args": {}})
        reference = sample.reference_tool_calls or []
        if not reference:
            return float("nan")
        score = 0.0
        for i, ref in enumerate(reference):
            if i >= len(performed):
                break
            got = performed[i]
            if got.get("name") != ref.get("name"):
                continue
            ref_args = ref.get("args", {})
            got_args = got.get("args", {})
            if not ref_args:
                score += 1.0
            else:
                matched = sum(
                    1 for k, v in ref_args.items() if got_args.get(k) == v
                )
                score += matched / len(ref_args)
        return score / len(reference)


class TopicsIn(BaseModel):
    conversation: str


class TopicsOut(BaseModel):
    topics: List[str]


class TopicExtractPrompt(StructuredPrompt[TopicsIn, TopicsOut]):
    instruction = "List the topics the user asked about in the conversation."
    input_model = TopicsIn
    output_model = TopicsOut
    examples = []


class TopicMatchIn(BaseModel):
    topics: List[str]
    reference_topics: List[str]


class TopicVerdict(BaseModel):
    topic: str
    on_topic: int


class TopicMatchOut(BaseModel):
    verdicts: List[TopicVerdict]


class TopicMatchPrompt(StructuredPrompt[TopicMatchIn, TopicMatchOut]):
    instruction = (
        "For each topic, verdict 1 if it falls under any of the "
        "reference topics, else 0."
    )
    input_model = TopicMatchIn
    output_model = TopicMatchOut
    examples = []


class TopicAdherenceScore(MetricWithLLM, MultiTurnMetric):
    name: ClassVar[str] = "topic_adherence"
    required_columns: ClassVar[set] = set()

    def __init__(self, llm=None, mode: str = "precision"):
        assert mode in ("precision", "recall", "f1")
        self.llm = llm
        self.mode = mode
        self.extract = TopicExtractPrompt()
        self.match = TopicMatchPrompt()

    async def _multi_turn_ascore(self, sample: MultiTurnSample) -> float:
        topics = (
            await self.extract.generate(
                self.llm, TopicsIn(conversation=sample.pretty_repr())
            )
        ).topics
        reference = (
            list((sample.rubrics or {}).get("reference_topics", []))
            or ([sample.reference] if sample.reference else [])
        )
        if not topics or not reference:
            return float("nan")
        out = await self.match.generate(
            self.llm,
            TopicMatchIn(topics=topics, reference_topics=reference),
        )
        on = sum(int(v.on_topic) for v in out.verdicts)
        precision = on / len(out.verdicts) if out.verdicts else 0.0
        if self.mode == "precision":
            return precision
        recall = min(1.0, on / len(reference))
        if self.mode == "recall":
            return recall
        if precision + recall == 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)
