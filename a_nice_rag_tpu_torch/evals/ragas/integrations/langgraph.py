"""LangGraph / langchain-core message converter.

Equivalent of ragas_modified/integrations/langgraph.py. Duck-typed on
the langchain-core message interface (``.type``, ``.content``, optional
``.tool_calls``) so the conversion works on real langchain messages when
that package is installed AND on any object exposing the same
attributes — no import required.
"""

from __future__ import annotations

import json
from typing import Any, List, Sequence

from a_nice_rag_tpu_torch.evals.ragas.dataset import (
    AIMessage,
    HumanMessage,
    Message,
    ToolCall,
    ToolMessage,
)

_TYPE_MAP = {
    "human": "human",
    "ai": "ai",
    "system": "system",
    "tool": "tool",
}


def convert_to_ragas_messages(messages: Sequence[Any]) -> List[Message]:
    out: List[Message] = []
    for m in messages:
        mtype = getattr(m, "type", None) or type(m).__name__.lower().replace(
            "message", ""
        )
        role = _TYPE_MAP.get(mtype, mtype)
        calls: List[ToolCall] = []
        for tc in getattr(m, "tool_calls", None) or []:
            name = (tc.get("name") if isinstance(tc, dict)
                    else getattr(tc, "name", ""))
            args = (tc.get("args") if isinstance(tc, dict)
                    else getattr(tc, "args", {}))
            calls.append(ToolCall(name=name or "", args=args or {}))
        content = getattr(m, "content", None)
        if content is not None and not isinstance(content, str):
            content = json.dumps(content)
        if role == "ai":
            if calls or content:
                out.append(AIMessage(content=content or "",
                                     tool_calls=calls or None))
            continue
        if calls:  # tool calls on a non-AI turn: keep them typed
            out.append(AIMessage(content="", tool_calls=calls))
        if content:
            if role == "human":
                out.append(HumanMessage(content=content))
            elif role == "tool":
                out.append(ToolMessage(content=content))
            else:
                out.append(Message(role=role, content=content))
    return out
