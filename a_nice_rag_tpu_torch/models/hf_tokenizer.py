"""HF ``tokenizer.json`` byte maps (dependency-free; the port of the JAX
package's ``models/hf_tokenizer.py``, a copy).

Guided decoding (models/constrain.py) lowers a byte-level DFA onto a
tokenizer by walking each token's BYTE string — for the local byte
tokenizer that map is trivial (id i < 256 IS byte i), but a real
checkpoint (e.g. Qwen3: byte-level BPE, reference
src/query_rag_retrieval.py loads it via SaaS/torch) encodes tokens as
unicode strings under the GPT-2 byte-to-unicode remapping. This module
reads the HF fast-tokenizer ``tokenizer.json`` and inverts that
remapping to produce ``{token_id: bytes}``, which plugs straight into
:func:`a_nice_rag_tpu_torch.models.constrain.vocab_table` /
``compile_constraint(token_bytes=...)`` — no transformers import, so it
works in hermetic serving processes.

Only byte-level BPE vocabularies are supported (ByteLevel
pre-tokenizer/decoder — the GPT/Llama/Qwen family). Added tokens
(specials like ``<|im_end|>``) carry no byte content and are reported
separately; constraint tables leave them forbidden, which is exactly
right — a grammar-constrained completion must not emit control tokens.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Set, Tuple

__all__ = [
    "bytes_to_unicode",
    "hf_token_bytes",
    "load_token_bytes",
    "HFStreamDecoder",
    "HFTokenizer",
]


def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte -> unicode-char remapping (printable bytes map to
    themselves; the rest to U+0100.. offsets), as used by every
    ByteLevel BPE tokenizer."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _is_byte_level(tok: dict) -> bool:
    def types(node):
        if not isinstance(node, dict):
            return []
        if node.get("type") == "Sequence":
            out = []
            for sub in node.get("pretokenizers", node.get("decoders", [])):
                out.extend(types(sub))
            return out
        return [node.get("type")]

    kinds = types(tok.get("pre_tokenizer") or {}) + types(
        tok.get("decoder") or {}
    )
    return "ByteLevel" in kinds


def hf_token_bytes(tokenizer_json: dict) -> Tuple[Dict[int, bytes],
                                                  Set[int]]:
    """Invert a parsed ``tokenizer.json`` to ``({id: bytes}, specials)``.

    ``specials`` are added tokens (no byte content — they are control
    tokens, not text); they are omitted from the byte map so constraint
    tables keep them forbidden.
    """
    if not _is_byte_level(tokenizer_json):
        raise NotImplementedError(
            "only ByteLevel (byte-level BPE) tokenizers are supported "
            "for constraint lowering; this tokenizer.json has "
            "pre_tokenizer/decoder "
            f"{[(tokenizer_json.get(k) or {}).get('type') for k in ('pre_tokenizer', 'decoder')]}"
        )
    vocab = tokenizer_json["model"]["vocab"]
    char_to_byte = {c: b for b, c in bytes_to_unicode().items()}
    specials = {
        int(t["id"]) for t in tokenizer_json.get("added_tokens", [])
    }
    out: Dict[int, bytes] = {}
    for token, tid in vocab.items():
        tid = int(tid)
        if tid in specials:
            continue
        try:
            out[tid] = bytes(char_to_byte[ch] for ch in token)
        except KeyError:
            # Not representable as raw bytes (an added/special token
            # string stored in the main vocab): leave it forbidden.
            specials.add(tid)
    return out, specials


def load_token_bytes(path: str) -> Tuple[Dict[int, bytes], Set[int]]:
    """``path`` is a ``tokenizer.json`` file or a checkpoint directory
    containing one."""
    if os.path.isdir(path):
        path = os.path.join(path, "tokenizer.json")
    with open(path, "r", encoding="utf-8") as f:
        return hf_token_bytes(json.load(f))


class HFStreamDecoder:
    """Incremental text decode over a ``{token_id: bytes}`` map: feed
    ids, get back only the text that is complete so far (a codepoint
    split across two BPE pieces buffers until its continuation bytes
    arrive). Special/control ids carry no bytes and decode to ``""``.

    Drop-in for models/decoder.ByteDecoder where the vocabulary is
    multi-byte (real checkpoints) rather than raw bytes."""

    def __init__(self, token_bytes: Dict[int, bytes]):
        import codecs

        self._tb = token_bytes
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def feed(self, token_id: int) -> str:
        data = self._tb.get(int(token_id))
        if not data:
            return ""
        return self._dec.decode(data)

    def flush(self) -> str:
        return self._dec.decode(b"", final=True)


class HFTokenizer:
    """Serving tokenizer for an HF fast-tokenizer checkpoint: EXACT
    encode via the ``tokenizers`` runtime (already in the image as a
    transformers dependency — the merge walk is its Rust core, the one
    part not worth reimplementing), decode/streaming-decode via this
    module's dependency-free byte map so token-level paths (guided
    decoding, logprob accounting, SSE deltas) all see one consistent
    ``{id: bytes}`` view.

    Replaces the demo ByteTokenizer at the serving boundary when a real
    checkpoint is mounted (the reference tokenizes inside its SaaS
    providers — reference src/query_rag.py:434-513; here the serving
    process owns the hop). Same duck-typed surface as ByteTokenizer:
    ``encode(text, add_bos=...)`` / ``decode(ids)`` plus
    ``stream_decoder()``.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        try:
            from tokenizers import Tokenizer
        except ImportError as e:  # pragma: no cover - present in image
            raise ImportError(
                "HFTokenizer needs the 'tokenizers' package (ships with "
                "transformers); for demo weights use ByteTokenizer"
            ) from e
        self._tok = Tokenizer.from_file(path)
        with open(path, "r", encoding="utf-8") as f:
            self.token_bytes, self.specials = hf_token_bytes(json.load(f))
        self.vocab_size = int(
            self._tok.get_vocab_size(with_added_tokens=True)
        )
        # The checkpoint's declared chat template (tokenizer_config.json
        # or the newer chat_template.json), when present. This — not
        # marker presence in the vocab — decides the serving prompt
        # format: Qwen BASE tokenizers also carry <|im_start|>/<|im_end|>
        # as specials, so vocabulary alone over-claims ChatML support.
        self.chat_template = None
        self._has_tok_config = False
        d = os.path.dirname(path)
        for name, key in (("tokenizer_config.json", "chat_template"),
                          ("chat_template.json", "chat_template")):
            p = os.path.join(d, name)
            if not os.path.exists(p):
                continue
            try:
                with open(p, "r", encoding="utf-8") as f:
                    cfg = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if name == "tokenizer_config.json":
                self._has_tok_config = True
            tpl = cfg.get(key)
            if isinstance(tpl, str) and self.chat_template is None:
                self.chat_template = tpl

    def encode(self, text: str, add_bos: bool = True):
        # The Qwen/GPT BPE family has no BOS; accept the flag for
        # ByteTokenizer signature compatibility.
        del add_bos
        return list(self._tok.encode(text, add_special_tokens=False).ids)

    def decode(self, ids) -> str:
        dec = self.stream_decoder()
        out = "".join(filter(None, (dec.feed(int(i)) for i in ids)))
        return out + dec.flush()

    def stream_decoder(self) -> HFStreamDecoder:
        return HFStreamDecoder(self.token_bytes)

    def token_to_id(self, token: str):
        """Id of an exact vocabulary/special piece, or None."""
        return self._tok.token_to_id(token)


def supports_chatml(tokenizer) -> bool:
    """True when the checkpoint should be prompted with ChatML turn
    markers. Decided, in order:

    1. An explicit override: ``tokenizer.force_chatml`` (set by e.g. a
       ``--chat-template`` serve flag) wins outright.
    2. The checkpoint's declared ``chat_template`` (from
       tokenizer_config.json / chat_template.json): ChatML iff the
       template itself renders ``<|im_start|>`` turns. A declared
       non-ChatML template → the plain role-prefix fallback.
    3. A tokenizer_config.json WITHOUT a chat_template marks a BASE
       checkpoint (Qwen base tokenizers carry the ChatML specials in
       their vocab but were not instruction-trained on them) → False.
    4. No config at all: fall back to the marker-in-vocab heuristic
       (the `tokenizers` runtime extracts added tokens from input text
       even with add_special_tokens=False, so encoding a
       ChatML-rendered prompt yields the single special ids)."""
    force = getattr(tokenizer, "force_chatml", None)
    if force is not None:
        return bool(force)
    tpl = getattr(tokenizer, "chat_template", None)
    if isinstance(tpl, str):
        return "<|im_start|>" in tpl
    if getattr(tokenizer, "_has_tok_config", False):
        return False
    t2i = getattr(tokenizer, "token_to_id", None)
    return t2i is not None and None not in (
        t2i("<|im_start|>"), t2i("<|im_end|>")
    )


def render_chatml(messages) -> str:
    """Chat messages -> ChatML prompt text (the Qwen instruct template,
    reference checkpoints' expected markup), ending with an open
    assistant turn. Encoding this with the checkpoint's tokenizer maps
    the markers onto their special ids."""
    return "".join(
        f"<|im_start|>{m.get('role', 'user')}\n{m.get('content', '')}"
        f"<|im_end|>\n"
        for m in messages
    ) + "<|im_start|>assistant\n"
