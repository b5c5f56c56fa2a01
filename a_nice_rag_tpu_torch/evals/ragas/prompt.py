"""Structured-output prompt engine.

Equivalent of the reference's PydanticPrompt
(ragas_modified/prompt/pydantic_prompt.py): an instruction, typed
input/output pydantic models, few-shot examples, and a rendered prompt
that pins the output to a JSON schema. Parsing failures trigger an LLM
repair loop (FixOutputFormat) with up to 3 retries. Prompts can be
saved/loaded as JSON and language-adapted by translating their examples.
"""

from __future__ import annotations

import json
import os
import re
from typing import Generic, List, Tuple, Type, TypeVar

from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel, ValidationError

from a_nice_rag_tpu_torch.evals.ragas.llm import BaseJudgeLLM

InT = TypeVar("InT", bound=BaseModel)
OutT = TypeVar("OutT", bound=BaseModel)


def extract_json(text: str) -> str:
    """Pull the first JSON object/array out of an LLM response.

    A response that is one JSON document (a guided judge's always is) is
    returned as it is. Otherwise code fences are dropped and the first
    balanced object or array is cut out, skipping brackets inside JSON
    strings. (The JAX package's scan counts those too, so there a verdict
    whose string holds a brace reads as malformed and goes to repair.)"""
    stripped = text.strip()
    try:
        json.loads(stripped)
        return stripped
    except ValueError:
        pass
    text = re.sub(r"```(?:json)?", "", text).strip().strip("`")
    for opener, closer in (("{", "}"), ("[", "]")):
        start = text.find(opener)
        if start < 0:
            continue
        depth = 0
        in_str = escape = False
        for i in range(start, len(text)):
            ch = text[i]
            if in_str:
                if escape:
                    escape = False
                elif ch == "\\":
                    escape = True
                elif ch == '"':
                    in_str = False
            elif ch == '"':
                in_str = True
            elif ch == opener:
                depth += 1
            elif ch == closer:
                depth -= 1
                if depth == 0:
                    return text[start : i + 1]
    return text


def _close_json_prefix(s: str):
    """Append whatever closers balance the prefix ``s``; None if malformed."""
    stack = []
    in_str = escape = False
    for ch in s:
        if in_str:
            if escape:
                escape = False
            elif ch == "\\":
                escape = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch in "{[":
            stack.append("}" if ch == "{" else "]")
        elif ch in "}]":
            if not stack or stack[-1] != ch:
                return None
            stack.pop()
    if escape:
        s = s[:-1]
    if in_str:
        s += '"'
    return s + "".join(reversed(stack))


_MAX_PARTIAL_BACKTRACK = 256


def parse_partial_json(text: str):
    """Best-effort parse of a PREFIX of a streamed JSON document.

    Closes open strings/containers, and walks the cut point backwards
    (bounded) past half-written tokens — a dangling ``"key":``, a bare
    ``tru``, a trailing comma — until a parse succeeds. Returns the
    parsed snapshot or None when nothing parses yet. Powers streaming
    structured outputs: each delta yields a progressively larger
    snapshot of the final object.
    """
    start = min(
        (i for i in (text.find("{"), text.find("[")) if i >= 0),
        default=-1,
    )
    if start < 0:
        return None
    text = text[start:]
    lo = max(1, len(text) - _MAX_PARTIAL_BACKTRACK)
    for cut in range(len(text), lo - 1, -1):
        head = text[:cut].rstrip()
        if not head:
            break
        if head[-1] in ",:":
            continue  # dangling separator: never closeable, keep walking
        candidate = _close_json_prefix(head)
        if candidate is None:
            return None  # structurally malformed, not just incomplete
        try:
            return json.loads(candidate)
        except ValueError:
            continue
    return None


class StructuredPrompt(Generic[InT, OutT]):
    instruction: str = ""
    input_model: Type[InT]
    output_model: Type[OutT]
    examples: List[Tuple[InT, OutT]] = []
    name: str = ""

    def __init__(self):
        self.name = self.name or type(self).__name__
        self.examples = list(type(self).examples)

    # -- rendering ---------------------------------------------------------

    def render(self, data: InT) -> str:
        parts = [
            self.instruction,
            (
                "Return ONLY a JSON object matching this schema "
                "(no prose, no code fences):\n"
                + json.dumps(self.output_model.model_json_schema(), indent=None)
            ),
        ]
        if self.examples:
            shown = []
            for i, (ex_in, ex_out) in enumerate(self.examples, 1):
                shown.append(
                    f"Example {i}\nInput: {ex_in.model_dump_json()}\n"
                    f"Output: {ex_out.model_dump_json()}"
                )
            parts.append("Examples:\n" + "\n\n".join(shown))
        parts.append(f"Now process this input:\nInput: {data.model_dump_json()}\nOutput: ")
        return "\n\n".join(p for p in parts if p)

    # -- generation with repair loop ----------------------------------------

    async def generate(
        self,
        llm: BaseJudgeLLM,
        data: InT,
        temperature: float = 1e-8,
        retries: int = 3,
    ) -> OutT:
        return (
            await self.generate_multiple(llm, data, 1, temperature, retries)
        )[0]

    async def generate_multiple(
        self,
        llm: BaseJudgeLLM,
        data: InT,
        n: int = 1,
        temperature: float = 1e-8,
        retries: int = 3,
    ) -> List[OutT]:
        # Judges that accept ``schema=`` (LocalGuidedJudgeLLM) get the
        # output model's JSON Schema: guided decoding then guarantees
        # the completion VALIDATES and the repair loop below is a no-op.
        kw = {}
        try:
            import inspect

            if "schema" in inspect.signature(llm.agenerate).parameters:
                kw["schema"] = self.output_model.model_json_schema()
        except (TypeError, ValueError):
            pass
        raw = await llm.agenerate(self.render(data), n=n,
                                  temperature=temperature, **kw)
        out: List[OutT] = []
        for text in raw:
            out.append(await self._parse_with_repair(llm, text, retries))
        return out

    async def generate_stream(
        self,
        llm: BaseJudgeLLM,
        data: InT,
        temperature: float = 1e-8,
        retries: int = 3,
    ):
        """Stream structured output: yields dict SNAPSHOTS of the object
        as deltas arrive (each a parse of the JSON prefix seen so far),
        then the validated ``OutT`` instance as the FINAL item. The
        repair loop still guards the final parse, so the end state is
        exactly ``generate()``'s. Works with any judge: clients without
        server-side streaming yield one snapshot then the final object.
        """
        buf = ""
        last_snapshot = None
        async for delta in llm.astream(self.render(data), temperature):
            buf += delta
            snapshot = parse_partial_json(buf)
            if snapshot is not None and snapshot != last_snapshot:
                last_snapshot = snapshot
                yield snapshot
        yield await self._parse_with_repair(llm, buf, retries)

    async def _parse_with_repair(
        self, llm: BaseJudgeLLM, text: str, retries: int
    ) -> OutT:
        attempt = text
        for _ in range(retries + 1):
            try:
                return self.output_model.model_validate_json(
                    extract_json(attempt)
                )
            except (ValidationError, ValueError) as err:
                fix_prompt = (
                    "The following output failed JSON schema validation.\n"
                    f"Schema: {json.dumps(self.output_model.model_json_schema())}\n"
                    f"Output: {attempt}\nError: {err}\n"
                    "Reply with ONLY the corrected JSON."
                )
                attempt = (await llm.agenerate(fix_prompt, n=1))[0]
        raise ValueError(
            f"{self.name}: could not parse output after {retries} repairs"
        )

    # -- persistence / adaptation -------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "name": self.name,
            "instruction": self.instruction,
            "examples": [
                {"input": i.model_dump(), "output": o.model_dump()}
                for i, o in self.examples
            ],
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)

    def load(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            payload = json.load(f)
        self.instruction = payload["instruction"]
        self.examples = [
            (
                self.input_model.model_validate(ex["input"]),
                self.output_model.model_validate(ex["output"]),
            )
            for ex in payload["examples"]
        ]

    async def adapt(
        self, llm: BaseJudgeLLM, target_language: str
    ) -> "StructuredPrompt[InT, OutT]":
        """Translate example values to another language via the judge."""
        new_examples = []
        for ex_in, ex_out in self.examples:
            prompt = (
                f"Translate every string value in this JSON to "
                f"{target_language}; keep keys and structure identical. "
                "Reply with ONLY the JSON.\n"
                f"{json.dumps({'input': ex_in.model_dump(), 'output': ex_out.model_dump()})}"
            )
            raw = (await llm.agenerate(prompt, n=1))[0]
            data = json.loads(extract_json(raw))
            new_examples.append(
                (
                    self.input_model.model_validate(data["input"]),
                    self.output_model.model_validate(data["output"]),
                )
            )
        clone = type(self)()
        clone.examples = new_examples
        return clone
