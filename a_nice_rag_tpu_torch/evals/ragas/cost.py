"""Token usage and cost accounting (ragas_modified/cost.py surface)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class TokenUsage:
    input_tokens: int = 0
    output_tokens: int = 0
    model: str = ""

    def __add__(self, other: "TokenUsage") -> "TokenUsage":
        return TokenUsage(
            self.input_tokens + other.input_tokens,
            self.output_tokens + other.output_tokens,
            self.model or other.model,
        )

    def cost(
        self,
        cost_per_input_token: float,
        cost_per_output_token: Optional[float] = None,
    ) -> float:
        out_rate = (
            cost_per_output_token
            if cost_per_output_token is not None
            else cost_per_input_token
        )
        return (
            self.input_tokens * cost_per_input_token
            + self.output_tokens * out_rate
        )


def parse_openai_usage(response: Dict) -> TokenUsage:
    usage = response.get("usage", {})
    return TokenUsage(
        input_tokens=usage.get("prompt_tokens", 0),
        output_tokens=usage.get("completion_tokens", 0),
        model=response.get("model", ""),
    )


class CostTracker:
    """Accumulates per-call TokenUsage across an evaluation run."""

    def __init__(self):
        self.usages: List[TokenUsage] = []

    def record(self, usage: TokenUsage) -> None:
        self.usages.append(usage)

    def total_tokens(self) -> TokenUsage:
        total = TokenUsage()
        for u in self.usages:
            total = total + u
        return total

    def total_cost(
        self,
        cost_per_input_token: float,
        cost_per_output_token: Optional[float] = None,
    ) -> float:
        return self.total_tokens().cost(
            cost_per_input_token, cost_per_output_token
        )
