"""LLM provider clients and model routing.

The reference builds four env-keyed OpenAI-compatible clients (OpenAI,
Gemini via its OpenAI-compat endpoint, Anthropic via its OpenAI-compat
endpoint, OpenRouter; src/query_rag.py:32-61) and routes by model-name
substring (src/query_rag.py:434-507). This module implements the same
surface with a dependency-free OpenAI-compatible SSE streaming client,
plus a deterministic offline ``FakeLLMClient`` so the whole RAG stack
runs and tests hermetically.

Counterpart of ``a_nice_rag_tpu/rag/providers.py``. The JAX package's
on-device generation client (``LocalTpuLLMClient``) waits for the port
of its decoder; ``route_model`` keeps the ``"local"`` route for a client
registered under that name.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Dict, Generator, List, Optional, Protocol


class ChatClient(Protocol):
    def stream_chat(
        self, model: str, messages: List[Dict[str, str]], **params
    ) -> Generator[str, None, None]:
        """Yield response text deltas."""
        ...


class OpenAICompatClient:
    """Minimal OpenAI-compatible /chat/completions client with SSE
    streaming (no SDK dependency)."""

    def __init__(self, api_key: str, base_url: str = "https://api.openai.com/v1/",
                 timeout: float = 300.0):
        self.api_key = api_key
        self.base_url = base_url.rstrip("/") + "/"
        self.timeout = timeout

    def stream_chat(self, model, messages, **params):
        payload = {
            "model": model,
            "messages": messages,
            "stream": True,
            **params,
        }
        req = urllib.request.Request(
            self.base_url + "chat/completions",
            data=json.dumps(payload).encode("utf-8"),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            for raw in resp:
                line = raw.decode("utf-8").strip()
                if not line.startswith("data:"):
                    continue
                data = line[len("data:"):].strip()
                if data == "[DONE]":
                    break
                try:
                    chunk = json.loads(data)
                except json.JSONDecodeError:
                    continue
                choices = chunk.get("choices") or []
                if not choices:
                    continue
                delta = (choices[0].get("delta") or {}).get("content")
                if delta:
                    yield delta


class FakeLLMClient:
    """Deterministic offline client: streams a canned or scripted answer.

    Used by tests and offline serving; also accepts a ``responder``
    callable (messages -> text) so eval harnesses can fake judge models.
    """

    def __init__(self, responder=None, chunk_size: int = 7):
        self.responder = responder
        self.chunk_size = chunk_size
        self.calls: List[Dict] = []

    def stream_chat(self, model, messages, **params):
        self.calls.append({"model": model, "messages": messages, **params})
        if self.responder is not None:
            text = self.responder(messages)
        else:
            user = messages[-1]["content"] if messages else ""
            text = f"[fake:{model}] {user[:160]}"
        for i in range(0, len(text), self.chunk_size):
            yield text[i : i + self.chunk_size]


def build_default_clients(env: Optional[Dict[str, str]] = None) -> Dict[str, ChatClient]:
    """Env-keyed client set mirroring the reference's provider matrix."""
    env = env if env is not None else os.environ
    clients: Dict[str, ChatClient] = {}
    if env.get("OPENAI_API_KEY"):
        clients["openai"] = OpenAICompatClient(env["OPENAI_API_KEY"])
    if env.get("GEMINI_API_KEY"):
        clients["gemini"] = OpenAICompatClient(
            env["GEMINI_API_KEY"],
            "https://generativelanguage.googleapis.com/v1beta/openai/",
        )
    if env.get("ANTHROPIC_API_KEY"):
        clients["anthropic"] = OpenAICompatClient(
            env["ANTHROPIC_API_KEY"], "https://api.anthropic.com/v1/"
        )
    if env.get("OPENROUTER_API_KEY"):
        clients["openrouter"] = OpenAICompatClient(
            env["OPENROUTER_API_KEY"], "https://openrouter.ai/api/v1/"
        )
    return clients


def route_model(
    llm_model: str, clients: Dict[str, ChatClient]
) -> Optional[tuple]:
    """Substring routing with per-model params (parity with
    src/query_rag.py:434-507). Returns (client, params) or None."""
    name = llm_model.lower()
    if "fake" in name or "echo" in name:
        client = clients.get("fake")
        return (client, {"temperature": 0}) if client else None
    if ("local" in name or "tpu" in name) and "local" in clients:
        return clients["local"], {"temperature": 0}
    if "gemini" in name and "gemini" in clients:
        return clients["gemini"], {"temperature": 0}
    if "gpt-4" in name and "openai" in clients:
        return clients["openai"], {"temperature": 0}
    if "gpt-5" in name and "openai" in clients:
        return clients["openai"], {"reasoning_effort": "minimal"}
    if "o4-mini" in name and "openai" in clients:
        return clients["openai"], {}
    if "claude" in name and "openrouter" in clients:
        return clients["openrouter"], {"temperature": 0}
    return None
