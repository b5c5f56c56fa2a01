"""Prompt construction and context assembly (a copy of the JAX
package's ``rag/prompts.py``, which imports no jax).

Keeps the reference's prompt CONTRACT (src/query_rag.py:145-233) while
the instruction text is this framework's own:

* answers must come strictly from the retrieved guideline context,
* markdown lists/links/tables, never raw URLs or invented URLs,
* the exact fallback sentence "No relevant NICE guidelines were found."
  (the evaluation framework's answer-relevancy metric treats this exact
  sentence as noncommittal — it must not drift),
* context chunks carry a source header
  ``Source Information: [Identifier: {source} - Section ID: {id}]`` so
  the LLM can cite, joined by ``---`` separators.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

NOT_FOUND_SENTENCE = "No relevant NICE guidelines were found."

_SECTION_SEP = "\n\n---\n\n"
_RAW_SEP = "\n\n--- Context Chunk ---\n\n"


def clean_section_id(section_id: str, source: str) -> str:
    """Human-readable section id: drop the '{source}_' prefix, map
    underscores to spaces, collapse whitespace (parity with
    src/query_rag.py:247-261)."""
    if not section_id or section_id == "Unknown section":
        return section_id
    out = section_id
    prefix = f"{source}_"
    if out.startswith(prefix):
        out = out[len(prefix):]
    out = out.replace("_", " ")
    return re.sub(r"\s+", " ", out).strip()


def build_context_text(docs: Sequence[Dict]) -> Tuple[str, str]:
    """(formatted context with source headers, raw chunk text)."""
    formatted, raw = [], []
    for doc in docs:
        section_id = doc.get("id", "Unknown section")
        source = doc.get("source", "Unknown file")
        text = doc.get("document", "")
        raw.append(text)
        formatted.append(
            "Source Information: "
            f"[Identifier: {source} - Section ID: "
            f"{clean_section_id(section_id, source)}]\n"
            f"Context: {text}"
        )
    return _SECTION_SEP.join(formatted), _RAW_SEP.join(raw)


_SYSTEM_TEMPLATE = """\
You are a clinical assistant that answers medical questions using ONLY the \
{context_description} excerpts supplied with each question.

Rules you must always follow:

1. Grounding: every statement in your answer must be supported by the \
supplied context. Never add, infer, or speculate beyond it.
2. Formatting: write plain prose with markdown. Use `-` or `*` bullets for \
lists, one bullet per line, with a blank line before the first bullet when \
a list follows a sentence. Do not use code blocks.
3. Tables: when a markdown table in the context is relevant, reproduce it \
in your answer with its structure and contents intact.
4. Links: when the context contains URLs that are relevant, weave them into \
your sentences as markdown links where only the bracketed text is visible \
(for example [guideline name](https://www.nice.org.uk/guidance/ng136)). \
Never show a bare URL and never fabricate one.
5. No answer: if nothing in the context is relevant to the question, reply \
with exactly: "{not_found_sentence}"

Keep answers concise, clinically precise, and faithful to the context."""


def build_system_prompt(
    context_description: str = "NICE guidelines",
    not_found_sentence: str = NOT_FOUND_SENTENCE,
) -> str:
    return _SYSTEM_TEMPLATE.format(
        context_description=context_description,
        not_found_sentence=not_found_sentence,
    )


def build_chat_messages(
    context_text: str,
    query_text: str,
    context_description: str = "NICE guidelines",
    not_found_sentence: str = NOT_FOUND_SENTENCE,
) -> List[Dict[str, str]]:
    """OpenAI-format message list: system rules + user question-with-context
    (same two-message shape as the reference, src/query_rag.py:170-233)."""
    return [
        {
            "role": "system",
            "content": build_system_prompt(
                context_description, not_found_sentence
            ),
        },
        {
            "role": "user",
            "content": (
                f"{query_text}\n\n"
                f"Context from {context_description}:\n{context_text}"
            ),
        },
    ]


def sources_string(docs: Sequence[Dict]) -> str:
    """'{source} - Section {clean id}' per line (src/query_rag.py:235-245)."""
    lines = []
    for doc in docs:
        section_id = doc.get("id", "Unknown section")
        source = doc.get("source", "Unknown file")
        lines.append(f"{source} - Section {clean_section_id(section_id, source)}")
    return "\n".join(lines)


def sources_data(docs: Sequence[Dict]) -> List[Dict[str, str]]:
    return [
        {
            "source": doc.get("source", "Unknown"),
            "section_id": doc.get("id", "Unknown"),
            "url": doc.get("url", "Unknown"),
        }
        for doc in docs
    ]
