"""Judge LLM wrappers.

Protocol + adapters covering the reference's LLM wrapper layer
(ragas_modified/llms/base.py): retrying generation, truncation
detection (LLMDidNotFinish), an OpenAI-compatible REST judge, and a
deterministic fake for hermetic tests.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import urllib.request
from typing import AsyncIterator, Callable, List, Optional


class LLMDidNotFinishException(Exception):
    """The judge stopped for a non-'stop' reason (truncation etc.)."""


# Strong references to in-flight streaming worker tasks (asyncio holds
# tasks weakly; see serving/scheduler.py for the same pattern).
_STREAM_TASKS: set = set()


class BaseJudgeLLM:
    async def agenerate(
        self, prompt: str, n: int = 1, temperature: float = 1e-8
    ) -> List[str]:
        raise NotImplementedError

    def generate(self, prompt: str, n: int = 1, temperature: float = 1e-8):
        # asyncio.run, not get_event_loop(): the latter can return a
        # closed loop left behind by an earlier asyncio.run in the same
        # process and fail with "Event loop is closed".
        return asyncio.run(self.agenerate(prompt, n, temperature))

    async def astream(
        self, prompt: str, temperature: float = 1e-8
    ) -> AsyncIterator[str]:
        """Yield response text deltas as they arrive.

        Default implementation degrades to one chunk (the full
        response), so every judge supports the streaming surface;
        clients with true server-side streaming override this.
        """
        yield (await self.agenerate(prompt, 1, temperature))[0]


class OpenAICompatJudgeLLM(BaseJudgeLLM):
    """Non-streaming chat-completions judge (default judge model mirrors
    the reference's llm_factory default)."""

    def __init__(
        self,
        model: str = "gpt-4o-mini",
        api_key: Optional[str] = None,
        base_url: str = "https://api.openai.com/v1/",
        timeout: float = 180.0,
        cost_tracker=None,
    ):
        self.model = model
        self.api_key = api_key or os.getenv("OPENAI_API_KEY")
        if not self.api_key:
            raise ValueError("OPENAI_API_KEY not set")
        self.base_url = base_url.rstrip("/") + "/"
        self.timeout = timeout
        self.cost_tracker = cost_tracker

    def _call(self, prompt: str, n: int, temperature: float) -> List[str]:
        payload = {
            "model": self.model,
            "messages": [{"role": "user", "content": prompt}],
            "n": n,
            "temperature": temperature,
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
            out = json.loads(resp.read().decode("utf-8"))
        if self.cost_tracker is not None:
            from a_nice_rag_tpu_torch.evals.ragas.cost import parse_openai_usage

            self.cost_tracker.record(parse_openai_usage(out))
        texts = []
        for choice in out.get("choices", []):
            if choice.get("finish_reason") not in (None, "stop"):
                raise LLMDidNotFinishException(
                    f"finish_reason={choice.get('finish_reason')}"
                )
            texts.append(choice["message"]["content"])
        return texts

    async def agenerate(self, prompt, n=1, temperature=1e-8):
        return await asyncio.to_thread(self._call, prompt, n, temperature)

    def _stream_call(self, prompt: str, temperature: float, emit) -> None:
        """Blocking SSE read; calls ``emit(delta)`` per content chunk."""
        payload = {
            "model": self.model,
            "messages": [{"role": "user", "content": prompt}],
            "temperature": temperature,
            "stream": True,
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
            for raw_line in resp:
                line = raw_line.decode("utf-8").strip()
                if not line.startswith("data:"):
                    continue
                data = line[5:].strip()
                if data == "[DONE]":
                    break
                try:
                    event = json.loads(data)
                except ValueError:
                    continue
                for choice in event.get("choices", []):
                    fr = choice.get("finish_reason")
                    if fr not in (None, "stop"):
                        raise LLMDidNotFinishException(f"finish_reason={fr}")
                    delta = (choice.get("delta") or {}).get("content")
                    if delta:
                        emit(delta)

    async def astream(self, prompt, temperature=1e-8):
        """True server-side streaming (SSE chat completions).

        Abandoning the generator early (break / wait_for timeout) must
        not block on the rest of the server stream: the blocking SSE
        read cannot be cancelled mid-recv, so cleanup sets a closed
        flag that makes the NEXT delta raise inside the worker thread
        (tearing the connection down via the response context manager)
        and returns immediately without awaiting the worker.
        """
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        closed = False
        _END = object()

        class _Abandoned(Exception):
            pass

        def emit(delta):
            if closed:
                raise _Abandoned()
            loop.call_soon_threadsafe(queue.put_nowait, delta)

        def worker():
            try:
                self._stream_call(prompt, temperature, emit)
                tail = _END
            except _Abandoned:
                return  # consumer went away; nothing to deliver
            except BaseException as e:  # delivered to the consumer
                tail = e
            if not closed:
                try:
                    loop.call_soon_threadsafe(queue.put_nowait, tail)
                except RuntimeError:
                    pass  # loop already gone

        # Strong reference so the event loop's weak task refs cannot GC
        # the wrapper mid-flight (the thread itself always runs on).
        task = asyncio.ensure_future(asyncio.to_thread(worker))
        _STREAM_TASKS.add(task)
        task.add_done_callback(_STREAM_TASKS.discard)
        try:
            while True:
                item = await queue.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            closed = True


class FakeJudgeLLM(BaseJudgeLLM):
    """Scripted judge for tests: responder(prompt) -> str or list[str]."""

    def __init__(self, responder: Optional[Callable[[str], object]] = None):
        self.responder = responder
        self.prompts: List[str] = []

    async def agenerate(self, prompt, n=1, temperature=1e-8):
        self.prompts.append(prompt)
        if self.responder is None:
            return ["{}"] * n
        out = self.responder(prompt)
        if isinstance(out, list):
            return (out * n)[:n]
        return [out] * n

    async def astream(self, prompt, temperature=1e-8):
        """Stream the scripted response in small chunks so consumers'
        partial-parse paths get exercised in tests."""
        text = (await self.agenerate(prompt, 1, temperature))[0]
        step = max(1, len(text) // 7)
        for i in range(0, len(text), step):
            yield text[i : i + step]


_IMAGE_MD = re.compile(r"!\[[^\]]*\]\((https?://[^\s)]+|data:image/[^\s)]+)\)")


def prompt_to_content_parts(prompt: str) -> List[dict]:
    """Split a prompt with markdown image refs into OpenAI content parts.

    ``![...](url-or-data-uri)`` becomes an image_url part in place; the
    surrounding text stays ordered around it. A prompt with no images
    yields a single text part.
    """
    parts: List[dict] = []
    pos = 0
    for m in _IMAGE_MD.finditer(prompt):
        text = prompt[pos:m.start()]
        if text.strip():
            parts.append({"type": "text", "text": text})
        parts.append(
            {"type": "image_url", "image_url": {"url": m.group(1)}}
        )
        pos = m.end()
    tail = prompt[pos:]
    if tail.strip() or not parts:
        parts.append({"type": "text", "text": tail})
    return parts


class MultimodalJudgeLLM(OpenAICompatJudgeLLM):
    """Vision-capable chat-completions judge.

    The multimodal metrics (metrics/multimodal.py) render image contexts
    as markdown image references; a text-only judge sees the URLs, this
    client instead ships them as proper image_url content parts so the
    model actually looks at the pixels. Text-only prompts degrade to a
    single text part (safe as the default judge for mixed suites).
    """

    def _call(self, prompt: str, n: int, temperature: float) -> List[str]:
        parts = prompt_to_content_parts(prompt)
        if len(parts) == 1 and parts[0]["type"] == "text":
            return super()._call(prompt, n, temperature)
        payload = {
            "model": self.model,
            "messages": [{"role": "user", "content": parts}],
            "n": n,
            "temperature": temperature,
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
            out = json.loads(resp.read().decode("utf-8"))
        if self.cost_tracker is not None:
            from a_nice_rag_tpu_torch.evals.ragas.cost import parse_openai_usage

            self.cost_tracker.record(parse_openai_usage(out))
        texts = []
        for choice in out.get("choices", []):
            if choice.get("finish_reason") not in (None, "stop"):
                raise LLMDidNotFinishException(
                    f"finish_reason={choice.get('finish_reason')}"
                )
            texts.append(choice["message"]["content"])
        return texts


class LocalGuidedJudgeLLM(BaseJudgeLLM):
    """On-device judge over the continuous-batching GenerationServer
    with GUIDED decoding: every completion is DFA-masked to the
    registered constraint (default the bounded-depth JSON grammar,
    models/constrain.py), so structured outputs ALWAYS parse — the
    FixOutputFormat repair loop (prompt.py, mirroring the reference's
    post-hoc LLM repair) becomes a no-op instead of an extra LLM
    round-trip. Fully local: no API keys, no SaaS.

    When the caller provides the prompt's OUTPUT SCHEMA
    (StructuredPrompt passes its pydantic ``model_json_schema()``
    automatically), the judge compiles it to a schema DFA on first use
    and registers it on the server under a content-hash name
    (``server.register_constraint``), so the completion is guaranteed
    to VALIDATE, not merely parse. Otherwise the named ``constraint``
    (default the generic JSON grammar — register it at server build or
    it is auto-registered here) is used. Truncation
    (finish_reason == "length": the sentence did not complete within
    ``max_tokens``) raises LLMDidNotFinishException, matching the REST
    judges' semantics.
    """

    def __init__(self, server, constraint: str = "json",
                 max_tokens: int = 256, tokenizer=None,
                 auto_schema: bool = True,
                 default_temperature: float = None,
                 max_string_len: int = None,
                 max_items: int = None):
        from a_nice_rag_tpu_torch.models.decoder import ByteTokenizer

        self.server = server
        self.constraint = constraint
        self.max_tokens = max_tokens
        self.tokenizer = tokenizer or ByteTokenizer()
        self.auto_schema = auto_schema
        # Near-greedy decoding under a DFA can LOOP inside free-form
        # JSON string states (the mask allows almost every byte there,
        # and a weak model's argmax may never emit the closing quote
        # until the budget dies of finish_reason=length). A default
        # sampling temperature gives such models a stochastic exit;
        # callers that pass an explicit temperature are never
        # overridden.
        self.default_temperature = default_temperature
        # Cap undeclared string lengths in compiled schema DFAs so a
        # weak model cannot spend its whole budget inside one string
        # field (the DFA itself closes the string at the cap).
        self.max_string_len = max_string_len
        self.max_items = max_items
        self._schema_names: dict = {}

    def _constraint_for(self, schema) -> str:
        if schema is None or not self.auto_schema:
            if (
                self.constraint in ("json", "json_object", "json_array")
                and self.constraint
                not in self.server.stats()["constraints"]
            ):
                # The generic JSON grammars self-register on demand;
                # any other name must already be on the server (submit
                # raises otherwise).
                self.server.register_constraint(
                    self.constraint, self.constraint
                )
            return self.constraint
        key = json.dumps(schema, sort_keys=True)
        name = self._schema_names.get(key)
        if name is None:
            import hashlib

            from a_nice_rag_tpu_torch.models.constrain import schema_dfa

            name = "schema:" + hashlib.sha1(
                (key + f":{self.max_string_len}:{self.max_items}")
                .encode()
            ).hexdigest()[:12]
            # compact=True: no inter-token whitespace, so the budget is
            # spent on content, never on runs of spaces.
            self.server.register_constraint(
                name, schema_dfa(
                    schema, compact=True,
                    default_max_string=self.max_string_len,
                    default_max_items=self.max_items,
                )
            )
            self._schema_names[key] = name
        return name

    def _one(self, prompt: str, temperature: float,
             constraint: str) -> str:
        from a_nice_rag_tpu_torch.models.decoder import ByteDecoder

        out = self.server.complete(
            self.tokenizer.encode(prompt),
            max_new_tokens=self.max_tokens,
            temperature=float(temperature),
            constraint=constraint,
        )
        if out["finish_reason"] != "stop":
            raise LLMDidNotFinishException(
                f"finish_reason={out['finish_reason']} "
                f"(raise max_tokens: the constrained sentence did not "
                f"complete within {self.max_tokens})"
            )
        dec = ByteDecoder()
        text = "".join(filter(None, map(dec.feed, out["tokens"])))
        return text + dec.flush()

    async def agenerate(self, prompt, n=1, temperature=1e-8,
                        schema=None):
        if self.default_temperature is not None and temperature <= 1e-6:
            temperature = self.default_temperature
        loop = asyncio.get_running_loop()
        con = self._constraint_for(schema)
        return list(await asyncio.gather(*[
            loop.run_in_executor(None, self._one, prompt, temperature,
                                 con)
            for _ in range(n)
        ]))
