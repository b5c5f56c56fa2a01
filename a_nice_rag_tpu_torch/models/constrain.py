"""Constrained (guided) decoding: byte-level DFAs compiled to dense
transition tables, applied as logit masks inside the decode chunk (the
port of the JAX package's ``models/constrain.py``; numpy only, a copy).

The reference repairs malformed structured LLM output *after* the fact
with an LLM round-trip (reference ragas_modified/prompt.py FixOutputFormat
usage); vLLM/outlines-style guided decoding prevents it instead: every
sampled token is masked to the set the grammar allows, so the output
ALWAYS matches. The whole automaton lives on the device as one dense
``int32 [n_states, vocab]`` next-state tensor — the decode chunk
carries the per-slot DFA state, gathers one table row per step, masks
the logits, samples, and advances the state, with no host round-trip
mid-chunk (the host only seeds the state at admission).

Three front-ends, one artifact (:class:`ByteDFA`):

- :func:`regex_dfa` — a byte-alphabet regex engine (literals, classes,
  escapes incl. ``\\xHH``, ``.``, ``* + ? {m,n}``, ``|``, groups) via
  Thompson NFA + subset construction, dead-state trimmed so every live
  state can still reach acceptance.
- :func:`json_dfa` — strict JSON with nesting bounded at ``max_depth``,
  built DIRECTLY by exploring (mode, container-stack) states: ~25 modes
  x 2^depth stacks stays a few thousand states where the equivalent
  regex expansion explodes combinatorially.
- :func:`choice_dfa` / :func:`literal_dfa` — fixed alternatives.

:func:`vocab_table` lowers a ByteDFA onto a tokenizer by WALKING each
token's byte string from every state (vectorized over states), so
multi-byte tokens work, not just the byte-level local LM. EOS is a
first-class column: allowed exactly in accepting states (the stream may
also end early on budget — callers see finish_reason == "length").

Tables are dense: ``4 * n_states * vocab`` bytes. Byte-level vocabs are
trivially cheap; a 150k-token vocab costs ~0.6 MB per state-thousand —
keep ``max_depth`` moderate for real tokenizers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ByteDFA",
    "regex_dfa",
    "json_dfa",
    "choice_dfa",
    "literal_dfa",
    "schema_regex",
    "schema_dfa",
    "vocab_table",
    "Constraint",
    "compile_constraint",
    "unconstrained",
]

DEAD = -1
_WS = (0x20, 0x09, 0x0A, 0x0D)
_DIGITS = tuple(range(0x30, 0x3A))


@dataclasses.dataclass
class ByteDFA:
    """Deterministic automaton over the byte alphabet.

    ``next[s, b]`` is the successor state or ``DEAD``; ``accept[s]``
    marks states where the matched prefix is a complete sentence.
    State 0 is the start. Trimmed: every live state reaches acceptance.
    """

    next: np.ndarray  # int32 [S, 256]
    accept: np.ndarray  # bool [S]

    @property
    def n_states(self) -> int:
        return int(self.next.shape[0])

    def matches(self, data: bytes) -> bool:
        s = 0
        for b in data:
            s = int(self.next[s, b])
            if s < 0:
                return False
        return bool(self.accept[s])


# ---------------------------------------------------------------------------
# Regex front-end: parser -> NFA -> DFA
# ---------------------------------------------------------------------------

_CLS = {
    "d": set(_DIGITS),
    "w": set(_DIGITS)
    | set(range(0x41, 0x5B))
    | set(range(0x61, 0x7B))
    | {0x5F},
    "s": {0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C},
}
_ESC_CHAR = {"n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "v": 0x0B,
             "0": 0x00, "a": 0x07, "b": 0x08}


class _RegexParser:
    """Recursive-descent parser producing an AST of tuples:
    ("lit", frozenset) | ("cat", [..]) | ("alt", [..]) |
    ("rep", node, m, n|None) — n=None means unbounded."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _eat(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"trailing input at {self.i}: {self.p!r}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self._eat()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts: List = []
        while self._peek() not in (None, "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return ("cat", [])
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self._eat()
                node = ("rep", node, 0, None)
            elif c == "+":
                self._eat()
                node = ("rep", node, 1, None)
            elif c == "?":
                self._eat()
                node = ("rep", node, 0, 1)
            elif c == "{":
                j = self.p.find("}", self.i)
                if j < 0:
                    raise ValueError("unclosed {")
                body = self.p[self.i + 1 : j]
                self.i = j + 1
                if "," in body:
                    lo, hi = body.split(",", 1)
                    m = int(lo or 0)
                    n = int(hi) if hi.strip() else None
                else:
                    m = n = int(body)
                node = ("rep", node, m, n)
            else:
                return node

    def _atom(self):
        c = self._eat()
        if c == "(":
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
            node = self._alt()
            if self._peek() != ")":
                raise ValueError("unclosed group")
            self._eat()
            return node
        if c == "[":
            return ("lit", self._char_class())
        if c == ".":
            return ("lit", frozenset(range(256)) - {0x0A})
        if c == "\\":
            return ("lit", self._escape())
        if c in "*+?{":
            raise ValueError(f"dangling quantifier {c!r}")
        return ("lit", frozenset({ord(c)}))

    def _escape(self) -> frozenset:
        c = self._eat()
        if c in _CLS:
            return frozenset(_CLS[c])
        if c.lower() in _CLS and c.isupper():
            return frozenset(range(256)) - frozenset(_CLS[c.lower()])
        if c == "x":
            h = self.p[self.i : self.i + 2]
            self.i += 2
            return frozenset({int(h, 16)})
        if c in _ESC_CHAR:
            return frozenset({_ESC_CHAR[c]})
        return frozenset({ord(c)})

    def _char_class(self) -> frozenset:
        negate = self._peek() == "^"
        if negate:
            self._eat()
        items: set = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise ValueError("unclosed [")
            if c == "]" and not first:
                self._eat()
                break
            first = False
            if c == "\\":
                self._eat()
                chars = self._escape()
                if len(chars) > 1:  # class escape: no range semantics
                    items |= chars
                    continue
                lo = next(iter(chars))
            else:
                lo = ord(self._eat())
            if self._peek() == "-" and self.p[self.i + 1 : self.i + 2] not in (
                "]",
                "",
            ):
                self._eat()
                c2 = self._eat()
                if c2 == "\\":
                    hi = next(iter(self._escape()))
                else:
                    hi = ord(c2)
                items |= set(range(lo, hi + 1))
            else:
                items.add(lo)
        return frozenset(range(256)) - items if negate else frozenset(items)


class _NFA:
    """Thompson construction: states with epsilon edges and one
    byte-set edge each."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.edge: List[Optional[Tuple[frozenset, int]]] = []

    def new(self) -> int:
        self.eps.append([])
        self.edge.append(None)
        return len(self.eps) - 1

    def build(self, node) -> Tuple[int, int]:
        kind = node[0]
        if kind == "lit":
            a, b = self.new(), self.new()
            self.edge[a] = (node[1], b)
            return a, b
        if kind == "cat":
            if not node[1]:
                a = self.new()
                return a, a
            s, e = self.build(node[1][0])
            for part in node[1][1:]:
                s2, e2 = self.build(part)
                self.eps[e].append(s2)
                e = e2
            return s, e
        if kind == "alt":
            a, b = self.new(), self.new()
            for br in node[1]:
                s, e = self.build(br)
                self.eps[a].append(s)
                self.eps[e].append(b)
            return a, b
        if kind == "rep":
            _, inner, m, n = node
            a = self.new()
            cur = a
            for _ in range(m):
                s, e = self.build(inner)
                self.eps[cur].append(s)
                cur = e
            if n is None:
                s, e = self.build(inner)
                self.eps[cur].append(s)
                self.eps[e].append(s)  # loop
                end = self.new()
                self.eps[cur].append(end)
                self.eps[e].append(end)
                return a, end
            end = self.new()
            self.eps[cur].append(end)
            for _ in range(n - m):
                s, e = self.build(inner)
                self.eps[cur].append(s)
                cur = e
                self.eps[cur].append(end)
            return a, end
        raise ValueError(f"bad node {kind}")


def _eps_closure(nfa: _NFA, states: Iterable[int]) -> frozenset:
    stack = list(states)
    seen = set(stack)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _trim(next_tab: np.ndarray, accept: np.ndarray) -> ByteDFA:
    """Kill states that cannot reach acceptance, then renumber.

    Guarantees the decode-time invariant: a live non-accepting state
    always has at least one allowed byte."""
    n = next_tab.shape[0]
    rev: List[List[int]] = [[] for _ in range(n)]
    for s in range(n):
        for t in set(int(x) for x in next_tab[s] if x >= 0):
            rev[t].append(s)
    live = set(int(i) for i in np.nonzero(accept)[0])
    stack = list(live)
    while stack:
        t = stack.pop()
        for s in rev[t]:
            if s not in live:
                live.add(s)
                stack.append(s)
    if 0 not in live:
        raise ValueError("constraint matches nothing")
    order = [0] + sorted(live - {0})
    remap = {old: new for new, old in enumerate(order)}
    out = np.full((len(order), 256), DEAD, np.int32)
    acc = np.zeros(len(order), bool)
    for old in order:
        acc[remap[old]] = accept[old]
        for b in range(256):
            t = int(next_tab[old, b])
            if t >= 0 and t in live:
                out[remap[old], b] = remap[t]
    return ByteDFA(out, acc)


def regex_dfa(pattern: str) -> ByteDFA:
    """Compile a byte-alphabet regex (full-match semantics) to a DFA."""
    nfa = _NFA()
    start, end = nfa.build(_RegexParser(pattern).parse())
    start_set = _eps_closure(nfa, [start])
    ids: Dict[frozenset, int] = {start_set: 0}
    rows: List[np.ndarray] = []
    accept: List[bool] = []
    work = [start_set]
    while work:
        cur = work.pop(0)
        row = np.full(256, DEAD, np.int32)
        # Partition: all bytes sharing the same NFA move set share a
        # target; group by the set of (byteset, target) edges hit.
        edges = [nfa.edge[s] for s in cur if nfa.edge[s] is not None]
        if edges:
            # Compute per-byte target sets only over bytes any edge covers.
            covered = set()
            for byteset, _ in edges:
                covered |= byteset
            by_key: Dict[frozenset, List[int]] = {}
            for b in covered:
                tgt = frozenset(t for bs, t in edges if b in bs)
                by_key.setdefault(tgt, []).append(b)
            for tgt, bs in by_key.items():
                dst = _eps_closure(nfa, tgt)
                if dst not in ids:
                    ids[dst] = len(ids)
                    work.append(dst)
                row[list(bs)] = ids[dst]
        rows.append(row)
        accept.append(end in cur)
    return _trim(np.stack(rows), np.asarray(accept, bool))


def literal_dfa(text: str) -> ByteDFA:
    data = text.encode("utf-8")
    nxt = np.full((len(data) + 1, 256), DEAD, np.int32)
    for i, b in enumerate(data):
        nxt[i, b] = i + 1
    acc = np.zeros(len(data) + 1, bool)
    acc[-1] = True
    return ByteDFA(nxt, acc)


def choice_dfa(options: Sequence[str]) -> ByteDFA:
    """DFA accepting exactly the given strings (byte trie)."""
    if not options:
        raise ValueError("empty choice")
    trie: Dict[bytes, int] = {b"": 0}
    acc_keys = set()
    for opt in options:
        data = opt.encode("utf-8")
        for i in range(1, len(data) + 1):
            trie.setdefault(data[:i], len(trie))
        acc_keys.add(data)
    nxt = np.full((len(trie), 256), DEAD, np.int32)
    acc = np.zeros(len(trie), bool)
    for prefix, sid in trie.items():
        if prefix in acc_keys:
            acc[sid] = True
        for b in range(256):
            child = prefix + bytes([b])
            if child in trie:
                nxt[sid, b] = trie[child]
    return _trim(nxt, acc)


# ---------------------------------------------------------------------------
# Direct JSON DFA (bounded nesting)
# ---------------------------------------------------------------------------

def json_dfa(max_depth: int = 6, top_level: str = "any") -> ByteDFA:
    """Strict-JSON value DFA with container nesting capped at
    ``max_depth``. ``top_level`` restricts the outermost value:
    "any" | "object" | "array".

    States are explored lazily as (mode, ctx, stack) tuples — mode is
    one of ~25 micro-machine labels, stack the open-container string
    (e.g. ``"{["``) — so the table stays O(modes * 2^depth) instead of
    the combinatorial regex expansion. Number termination is handled by
    delegating terminator bytes to the after-value machine, and numbers
    at stack depth 0 accept mid-state (JSON ends at EOF).
    """
    if max_depth < 1:
        raise ValueError("max_depth >= 1")

    # State: (mode, ctx, stack). ctx: "k" while lexing an object key,
    # "v" otherwise. stack: string of '{' / '['.
    def after(stack: str) -> Tuple[str, str, str]:
        return ("A", "v", stack)

    def moves(state):
        mode, ctx, stack = state
        out: Dict[int, Tuple[str, str, str]] = {}

        def ws(target):
            for b in _WS:
                out[b] = target

        if mode == "V" or mode == "V1":
            # V1: just after '[' — a ']' may close the (empty) array.
            ws((mode, ctx, stack))
            out[0x22] = ("S", "v", stack)  # "
            out[0x2D] = ("NM", "v", stack)  # -
            out[0x30] = ("NZ", "v", stack)
            for b in range(0x31, 0x3A):
                out[b] = ("NI", "v", stack)
            out[0x74] = ("Lrue", "v", stack)  # t
            out[0x66] = ("Lalse", "v", stack)  # f
            out[0x6E] = ("Lull", "v", stack)  # n
            if len(stack) < max_depth:
                out[0x7B] = ("K1", "v", stack + "{")
                out[0x5B] = ("V1", "v", stack + "[")
            if mode == "V1" and stack and stack[-1] == "[":
                out[0x5D] = after(stack[:-1])
        elif mode == "A":
            ws(after(stack))
            if stack and stack[-1] == "{":
                out[0x2C] = ("K2", "v", stack)  # ,
                out[0x7D] = after(stack[:-1])  # }
            elif stack and stack[-1] == "[":
                out[0x2C] = ("V", "v", stack)
                out[0x5D] = after(stack[:-1])  # ]
        elif mode in ("K1", "K2"):
            ws((mode, ctx, stack))
            out[0x22] = ("S", "k", stack)
            if mode == "K1":
                out[0x7D] = after(stack[:-1])
        elif mode == "C":
            ws((mode, ctx, stack))
            out[0x3A] = ("V", "v", stack)  # :
        elif mode == "S":
            for b in range(256):
                if b in (0x22, 0x5C) or b < 0x20:
                    continue
                out[b] = ("S", ctx, stack)
            out[0x5C] = ("SE", ctx, stack)
            out[0x22] = ("C", "v", stack) if ctx == "k" else after(stack)
        elif mode == "SE":
            for b in b'"\\/bfnrt':
                out[b] = ("S", ctx, stack)
            out[0x75] = ("SU1", ctx, stack)
        elif mode in ("SU1", "SU2", "SU3", "SU4"):
            nxt_mode = {"SU1": "SU2", "SU2": "SU3", "SU3": "SU4",
                        "SU4": "S"}[mode]
            for b in (*_DIGITS, *range(0x41, 0x47), *range(0x61, 0x67)):
                out[b] = (nxt_mode, ctx, stack)
        elif mode.startswith("L"):
            rest = mode[1:]
            out[ord(rest[0])] = (
                after(stack) if len(rest) == 1
                else ("L" + rest[1:], ctx, stack)
            )
        elif mode in ("NM", "NZ", "NI", "ND0", "ND", "NE", "NES", "NED"):
            if mode == "NM":
                out[0x30] = ("NZ", ctx, stack)
                for b in range(0x31, 0x3A):
                    out[b] = ("NI", ctx, stack)
            else:
                complete = mode in ("NZ", "NI", "ND", "NED")
                if mode in ("NI", "ND", "NED"):
                    for b in _DIGITS:
                        out[b] = (mode, ctx, stack)
                if mode in ("ND0",):
                    for b in _DIGITS:
                        out[b] = ("ND", ctx, stack)
                if mode in ("NE", "NES"):
                    for b in _DIGITS:
                        out[b] = ("NED", ctx, stack)
                if mode == "NE":
                    out[0x2B] = ("NES", ctx, stack)
                    out[0x2D] = ("NES", ctx, stack)
                if mode in ("NZ", "NI"):
                    out[0x2E] = ("ND0", ctx, stack)  # .
                if complete and mode != "NED":
                    out[0x65] = ("NE", ctx, stack)  # e
                    out[0x45] = ("NE", ctx, stack)
                if complete:
                    # Terminators: delegate to the after-value machine.
                    for b, tgt in moves(after(stack)).items():
                        out.setdefault(b, tgt)
        else:  # pragma: no cover
            raise AssertionError(mode)
        return out

    if top_level == "object":
        start = ("TO", "v", "")
    elif top_level == "array":
        start = ("TA", "v", "")
    else:
        start = ("V", "v", "")

    def moves_top(state):
        mode, ctx, stack = state
        if mode in ("TO", "TA"):
            out: Dict[int, Tuple[str, str, str]] = {}
            for b in _WS:
                out[b] = state
            if mode == "TO":
                out[0x7B] = ("K1", "v", "{")
            else:
                out[0x5B] = ("V1", "v", "[")
            return out
        return moves(state)

    ids: Dict[Tuple[str, str, str], int] = {start: 0}
    work = [start]
    rows: List[Dict[int, int]] = []
    order: List[Tuple[str, str, str]] = []
    while work:
        st = work.pop(0)
        order.append(st)
        row: Dict[int, int] = {}
        for b, tgt in moves_top(st).items():
            if tgt not in ids:
                ids[tgt] = len(ids)
                work.append(tgt)
            row[b] = ids[tgt]
        rows.append(row)
    n = len(order)
    nxt = np.full((n, 256), DEAD, np.int32)
    acc = np.zeros(n, bool)
    for sid, (st, row) in enumerate(zip(order, rows)):
        mode, _, stack = st
        acc[sid] = stack == "" and (
            mode == "A" or mode in ("NZ", "NI", "ND", "NED")
        )
        for b, t in row.items():
            nxt[sid, b] = t
    return _trim(nxt, acc)


# ---------------------------------------------------------------------------
# Vocab lowering + the server-facing Constraint artifact
# ---------------------------------------------------------------------------

def vocab_table(
    dfa: ByteDFA,
    vocab_size: int,
    eos_id: int,
    token_bytes: Optional[Dict[int, bytes]] = None,
) -> np.ndarray:
    """Lower a byte DFA to a dense ``int32 [S, vocab_size]`` next-state
    table by walking each token's byte string from every state
    (vectorized over states). ``token_bytes=None`` means the byte-level
    local tokenizer: token id i < 256 IS byte i; all other specials are
    forbidden. ``table[s, eos_id] = s`` iff ``accept[s]`` — EOS is an
    ordinary column, so the decode mask needs no separate accept input.
    """
    S = dfa.n_states
    table = np.full((S, vocab_size), DEAD, np.int32)
    if token_bytes is None:
        table[:, :256] = dfa.next[:, :vocab_size if vocab_size < 256
                                  else 256]
    else:
        states = np.arange(S, dtype=np.int64)
        for tok, data in token_bytes.items():
            if tok == eos_id or not data:
                continue
            cur = states
            for b in data:
                safe = np.maximum(cur, 0)
                cur = np.where(cur >= 0, dfa.next[safe, b], DEAD)
            table[:, tok] = cur
    table[:, eos_id] = np.where(
        dfa.accept, np.arange(S, dtype=np.int32), DEAD
    )
    return table


@dataclasses.dataclass
class Constraint:
    """A compiled, vocab-lowered decoding constraint.

    ``table[s, v] >= 0`` means token v is allowed in state s (EOS column
    included). Produced by :func:`compile_constraint`; consumed by
    GenerationServer / the constrained decode program.
    """

    table: np.ndarray  # int32 [S, V]
    name: str = "constraint"

    @property
    def n_states(self) -> int:
        return int(self.table.shape[0])

    def allowed0(self) -> np.ndarray:
        """Boolean allowed-token mask for the start state (the host
        applies this to the prefill's first sampled token)."""
        return self.table[0] >= 0

    def advance(self, state: int, token: int) -> int:
        return int(self.table[state, token])


def unconstrained(vocab_size: int) -> Constraint:
    """The identity constraint: one always-accepting state allowing
    every token. Slot 0 of every constrained server program."""
    return Constraint(np.zeros((1, vocab_size), np.int32), "none")


def compile_constraint(
    spec,
    vocab_size: int,
    eos_id: int,
    token_bytes: Optional[Dict[int, bytes]] = None,
    name: Optional[str] = None,
) -> Constraint:
    """Compile a spec to a :class:`Constraint`.

    ``spec`` may be a :class:`ByteDFA`, a regex string, the sentinel
    ``"json"`` / ``"json_object"`` / ``"json_array"`` (bounded-depth
    JSON), or a list of choice strings.
    """
    if isinstance(spec, ByteDFA):
        dfa = spec
        label = name or "dfa"
    elif isinstance(spec, (list, tuple)):
        dfa = choice_dfa(list(spec))
        label = name or "choice"
    elif spec in ("json", "json_object", "json_array"):
        top = {"json": "any", "json_object": "object",
               "json_array": "array"}[spec]
        dfa = json_dfa(top_level=top)
        label = name or spec
    elif isinstance(spec, str):
        dfa = regex_dfa(spec)
        label = name or "regex"
    else:
        raise TypeError(f"bad constraint spec: {type(spec)}")
    return Constraint(
        vocab_table(dfa, vocab_size, eos_id, token_bytes), label
    )


# ---------------------------------------------------------------------------
# JSON-Schema front-end (outlines-style): schema -> regex -> DFA
# ---------------------------------------------------------------------------

_RE_SPECIALS = set("\\.[](){}*+?|^$-")
_WS_RE = r"[ \t\n\r]*"
_STR_RE = r'"([^"\\\x00-\x1f]|\\(["\\/bfnrt]|u[0-9a-fA-F]{4}))*"'
_STR_CHAR_RE = r'([^"\\\x00-\x1f]|\\(["\\/bfnrt]|u[0-9a-fA-F]{4}))'
_INT_RE = r"-?(0|[1-9][0-9]*)"
_NUM_RE = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?"


def _re_escape(text: str) -> str:
    out = []
    for ch in text:
        b = ord(ch)
        if ch in _RE_SPECIALS:
            out.append("\\" + ch)
        elif b < 0x20:
            out.append(f"\\x{b:02x}")
        else:
            out.append(ch)
    return "".join(out)


def _any_value_regex(depth: int) -> str:
    """Generic JSON value at bounded nesting (fallback for untyped /
    additionalProperties fields)."""
    scalar = f"({_STR_RE}|{_NUM_RE}|true|false|null)"
    v = scalar
    for _ in range(depth):
        pair = f"{_STR_RE}{_WS_RE}:{_WS_RE}{v}"
        obj = (f"\\{{{_WS_RE}({pair}({_WS_RE},{_WS_RE}{pair})*)?"
               f"{_WS_RE}\\}}")
        arr = (f"\\[{_WS_RE}({v}({_WS_RE},{_WS_RE}{v})*)?"
               f"{_WS_RE}\\]")
        v = f"({scalar}|{obj}|{arr})"
    return v


def schema_regex(schema: dict, any_depth: int = 2,
                 compact: bool = False,
                 default_max_string: Optional[int] = None,
                 default_max_items: Optional[int] = None) -> str:
    """Regex for JSON documents conforming to a (subset of a) JSON
    Schema — enough for pydantic ``model_json_schema()`` output:
    typed scalars, enums/consts, Literal, arrays with min/maxItems,
    nested objects via $defs/$ref, anyOf/oneOf unions, Optional
    (null union). Objects emit ALL listed properties in schema order
    (pydantic accepts any order, so the canonical order always
    validates); additionalProperties / untyped fields fall back to a
    generic bounded-depth value.

    ``default_max_string`` caps strings that declare no ``maxLength``
    of their own (adds ~cap states per string field): a weak model in
    a free-form string state may never sample the closing quote, and
    an unbounded string then eats the whole token budget
    (finish_reason=length) — the cap forces the DFA itself to end the
    string. Capped outputs still validate (pydantic str has no length
    constraint unless the schema declares one).
    """
    defs = schema.get("$defs", schema.get("definitions", {}))
    ws = "" if compact else _WS_RE

    def val(s: dict, depth: int) -> str:
        if depth > 16:
            raise ValueError("schema recursion too deep (cyclic $ref?)")
        if "$ref" in s:
            name = s["$ref"].split("/")[-1]
            if name not in defs:
                raise ValueError(f"unresolved $ref {s['$ref']!r}")
            return val(defs[name], depth + 1)
        for key in ("anyOf", "oneOf"):
            if key in s:
                return ("(" + "|".join(
                    val(branch, depth + 1) for branch in s[key]
                ) + ")")
        if "allOf" in s and len(s["allOf"]) == 1:
            return val(s["allOf"][0], depth + 1)
        if "const" in s:
            import json as _json

            return _re_escape(_json.dumps(s["const"]))
        if "enum" in s:
            import json as _json

            return ("(" + "|".join(
                _re_escape(_json.dumps(v)) for v in s["enum"]
            ) + ")")
        t = s.get("type")
        if isinstance(t, list):
            return ("(" + "|".join(
                val({**s, "type": one}, depth + 1) for one in t
            ) + ")")
        if t == "string":
            lo = s.get("minLength")
            hi = s.get("maxLength")
            if hi is None:
                hi = default_max_string
            if lo is None and hi is None:
                return f"({_STR_RE})"
            return (f'("{_STR_CHAR_RE}'
                    + "{" + f"{lo or 0},{hi if hi is not None else ''}"
                    + '}")')
        if t == "integer":
            if default_max_string is not None:
                # Caps requested: bound digit runs too (an unbounded
                # integer is the same weak-model budget sink as an
                # unbounded string — "noncommittal": 47293749... ).
                return r"(-?(0|[1-9][0-9]{0,8}))"
            return f"({_INT_RE})"
        if t == "number":
            if default_max_string is not None:
                return (r"(-?(0|[1-9][0-9]{0,8})(\.[0-9]{1,6})?"
                        r"([eE][+-]?[0-9]{1,2})?)")
            return f"({_NUM_RE})"
        if t == "boolean":
            return "(true|false)"
        if t == "null":
            return "(null)"
        if t == "array":
            item = val(s.get("items", {}), depth + 1)
            lo = int(s.get("minItems", 0))
            hi = s.get("maxItems")
            if hi is None:
                hi = default_max_items  # same rationale as strings
            if hi is not None:
                hi = int(hi)
                if hi == 0:
                    return f"(\\[{ws}\\])"
                body = (f"{item}({ws},{ws}{item})"
                        + "{" + f"{max(lo - 1, 0)},{hi - 1}" + "}")
                core = f"\\[{ws}{body}{ws}\\]"
                if lo == 0:
                    return f"(\\[{ws}\\]|{core})"
                return f"({core})"
            body = f"{item}({ws},{ws}{item})*"
            if lo <= 0:
                return f"(\\[{ws}({body})?{ws}\\])"
            req = (f"{item}({ws},{ws}{item})"
                   + "{" + f"{lo - 1}," + "}")
            return f"(\\[{ws}{req}{ws}\\])"
        if t == "object" or "properties" in s:
            props = s.get("properties")
            if not props:
                return _any_value_regex(any_depth)
            pairs = []
            for key, sub in props.items():
                pairs.append(
                    f'"{_re_escape(key)}"{ws}:{ws}'
                    + val(sub, depth + 1)
                )
            body = f"{ws},{ws}".join(pairs)
            return f"(\\{{{ws}{body}{ws}\\}})"
        return _any_value_regex(any_depth)

    return ws + val(schema, 0) + ws


def schema_dfa(schema: dict, any_depth: int = 2,
               compact: bool = False,
               default_max_string: Optional[int] = None,
               default_max_items: Optional[int] = None) -> ByteDFA:
    """Compile a pydantic-style JSON Schema to a ByteDFA: every
    accepted sentence both parses as JSON AND validates against the
    schema's types/keys — guided decoding then guarantees
    ``model_validate_json`` succeeds with zero repair round-trips.

    ``compact=True`` bans inter-token whitespace (canonical compact
    JSON, which every JSON parser accepts): strictly better for guided
    GENERATION — whitespace self-loop states otherwise let a weak model
    burn budget on runs of spaces — and it shrinks the table.
    ``default_max_string`` / ``default_max_items`` bound undeclared
    string lengths and array lengths (see :func:`schema_regex`)."""
    return regex_dfa(schema_regex(
        schema, any_depth, compact=compact,
        default_max_string=default_max_string,
        default_max_items=default_max_items,
    ))
