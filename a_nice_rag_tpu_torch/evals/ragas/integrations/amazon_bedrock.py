"""Amazon Bedrock agent-trace adapter.

Equivalent of ragas_modified/integrations/amazon_bedrock.py: pure dict
processing of Bedrock agent traces — extracts the conversation from the
last model invocation + final response, and knowledge-base lookup
groups as (user_input, retrieved_contexts, response) rows.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from a_nice_rag_tpu_torch.evals.ragas.dataset import Message

_ROLE_MAP = {"user": "human", "assistant": "ai"}


def _orchestration(trace: Dict[str, Any]) -> Dict[str, Any]:
    return trace.get("trace", {}).get("orchestrationTrace", {})


def _last(traces: List[Dict], key: str):
    idx, val = -1, None
    for i, t in enumerate(traces):
        o = _orchestration(t)
        if key in o:
            idx, val = i, o[key]
    return idx, val


def convert_to_ragas_messages(traces: List[Dict]) -> List[Message]:
    """Conversation from the last modelInvocationInput + finalResponse."""
    out: List[Message] = []
    inv_idx, inv = _last(traces, "modelInvocationInput")
    if inv is not None:
        try:
            payload = json.loads(inv.get("text", "{}"))
        except ValueError:
            payload = {}
        msgs = payload.get("messages", [])
        for m in msgs[:-1]:  # the trailing message is the pending turn
            role = _ROLE_MAP.get(m.get("role"), None)
            if role:
                out.append(Message(role=role, content=str(m.get("content", ""))))
    obs_idx, obs = _last(traces, "observation")
    if obs is not None and obs_idx > inv_idx:
        final = str(obs.get("finalResponse", {}).get("text", ""))
        out.append(Message(role="ai", content=final))
    return out


def extract_kb_trace(traces: List[Dict]) -> List[Dict[str, Any]]:
    """Knowledge-base lookup groups in invocation order.

    Each returned row has user_input / retrieved_contexts / response,
    matching the single-turn sample fields.
    """
    done: List[Dict[str, Any]] = []
    pending: List[Dict[str, Any]] = []
    for t in traces:
        o = _orchestration(t)
        inv = o.get("invocationInput")
        if inv and inv.get("invocationType") == "KNOWLEDGE_BASE":
            pending.append(
                {"user_input": inv.get("knowledgeBaseLookupInput", {}).get("text")}
            )
        obs = o.get("observation", {})
        if not obs:
            continue
        if "knowledgeBaseLookupOutput" in obs:
            for g in pending:
                if "retrieved_contexts" not in g:
                    g["retrieved_contexts"] = [
                        r.get("content", {}).get("text")
                        for r in obs["knowledgeBaseLookupOutput"].get(
                            "retrievedReferences", []
                        )
                    ]
                    break
        if "finalResponse" in obs:
            final = obs["finalResponse"].get("text")
            still = []
            for g in pending:
                if "retrieved_contexts" in g and "response" not in g:
                    g["response"] = final
                    done.append(g)
                else:
                    still.append(g)
            pending = still
    return done
