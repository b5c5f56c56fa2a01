"""Token counting for chunk sizing.

The reference measures chunk lengths with the voyage-3-large HF tokenizer
(src/processing/chunk_mds.py:20, :31-34). Tokenizer downloads are not
always possible (hermetic environments), so counting is pluggable:

* ``hf``        — the real tokenizer, when its files are cached locally
* ``heuristic`` — deterministic approximation: one token per word piece,
  long words pro-rated at ~4 chars/token (BPE-ish), punctuation counted
  — tracks real subword counts within ~10-15% on English prose, which is
  accurate enough for chunk-boundary placement.

Counterpart of ``a_nice_rag_tpu/ingest/tokens.py`` (a copy: it imports no
jax). ``transformers`` is imported only when a counter asks for the real
tokenizer, and a machine without it counts with the heuristic.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

_WORD_RE = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")


def heuristic_token_count(text: str) -> int:
    if not text:
        return 0
    n = 0
    for piece in _WORD_RE.findall(text):
        if piece[0].isalnum():
            n += max(1, (len(piece) + 3) // 4) if len(piece) > 7 else 1
        else:
            n += 1
    return n


class TokenCounter:
    """Pluggable token counter with memoization (chunking recounts the
    same lines many times)."""

    def __init__(
        self,
        mode: str = "auto",
        hf_name: str = "voyageai/voyage-3-large",
        fn: Optional[Callable[[str], int]] = None,
    ):
        self._cache: dict = {}
        if fn is not None:
            self._fn = fn
        elif mode in ("auto", "hf"):
            self._fn = self._try_hf(hf_name) or heuristic_token_count
            if mode == "hf" and self._fn is heuristic_token_count:
                raise RuntimeError(f"HF tokenizer {hf_name} unavailable")
        else:
            self._fn = heuristic_token_count

    @staticmethod
    def _try_hf(name: str):
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
            return lambda text: len(tok.encode(text))
        except Exception:
            return None

    def __call__(self, text: str) -> int:
        if text not in self._cache:
            if len(self._cache) > 200_000:
                self._cache.clear()
            self._cache[text] = self._fn(text)
        return self._cache[text]
