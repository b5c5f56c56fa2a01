"""OpenAI Swarm / chat-completions message-dict converter.

Equivalent of ragas_modified/integrations/swarm.py: turns a list of
OpenAI-style message dicts (role/content, optional tool_calls) into the
framework's TYPED message schema
(ragas_modified/messages.py:6-134): assistant turns become AIMessage
with structured ToolCall entries — the native channel
metrics/agentic.ToolCallAccuracy reads — user turns HumanMessage, tool
outputs ToolMessage.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from a_nice_rag_tpu_torch.evals.ragas.dataset import (
    AIMessage,
    HumanMessage,
    Message,
    ToolCall,
    ToolMessage,
)


def convert_to_ragas_messages(
    messages: List[Dict[str, Any]],
) -> List[Message]:
    out: List[Message] = []
    for m in messages:
        role = m.get("role", "user")
        calls: List[ToolCall] = []
        for tc in m.get("tool_calls") or []:
            fn = tc.get("function", tc)
            args = fn.get("arguments", {})
            if isinstance(args, str):
                try:
                    args = json.loads(args)
                except ValueError:
                    args = {"raw": args}
            calls.append(ToolCall(name=fn.get("name", ""), args=args))
        content = m.get("content")
        if role == "assistant":
            if calls or content:
                out.append(AIMessage(content=str(content or ""),
                                     tool_calls=calls or None))
            continue
        if calls:  # tool calls on a non-assistant turn: keep them typed
            out.append(AIMessage(content="", tool_calls=calls))
        if content:
            if role == "tool":
                out.append(ToolMessage(content=str(content)))
            elif role == "user":
                out.append(HumanMessage(content=str(content)))
            else:
                out.append(Message(role=role, content=str(content)))
    return out
