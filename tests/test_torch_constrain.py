"""The port's copy of the constrained-decoding automata
(a_nice_rag_tpu_torch/models/constrain.py) against the JAX package's.

Mirrors tests/test_constrain.py: each automaton the JAX package's tests
build is built by both packages and its transition table, acceptance
vector and the vocab-lowered tables are held ``np.array_equal``; the
port's regex engine agrees with Python's ``re`` (full match), its JSON
DFA accepts strict JSON, and the schema DFAs validate with pydantic.
"""

import json
import random
import re

import numpy as np
import pytest

from a_nice_rag_tpu.models import constrain as jc
from a_nice_rag_tpu_torch.models import constrain as tc

PATTERNS = [
    r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?",
    r"(abc|ab*d)+",
    r"[a-f0-9]{4,8}",
    r"yes|no|maybe",
    r'"([^"\\]|\\.)*"',
    r"\w+@\w+\.(com|org)",
    r"a{2,4}b?",
    r"[^x]*x",
    r"(?:ab|a)(?:c|bc)",
]
SCHEMA = {
    "type": "object",
    "properties": {
        "label": {"enum": ["yes", "no", 3]},
        "tags": {"type": "array", "items": {"type": "string"},
                 "minItems": 1, "maxItems": 2},
    },
}


def _same_dfa(a, b):
    np.testing.assert_array_equal(a.next, b.next)
    np.testing.assert_array_equal(a.accept, b.accept)


@pytest.mark.parametrize("pat", PATTERNS)
def test_regex_dfa_equal_jax_and_matches_re(pat):
    dfa = tc.regex_dfa(pat)
    _same_dfa(dfa, jc.regex_dfa(pat))
    rng = random.Random(0)
    alpha = 'ab01cdef9."\\@-+eE xyesnomaybe'
    cre = re.compile("(?s)" + pat)
    for _ in range(500):
        s = "".join(rng.choice(alpha) for _ in range(rng.randint(0, 10)))
        assert dfa.matches(s.encode()) == (cre.fullmatch(s) is not None)
    # No dead-end states: every live non-accepting state has an exit.
    assert np.all((dfa.next >= 0).any(axis=1) | dfa.accept)


@pytest.mark.parametrize("kw", [dict(max_depth=6), dict(top_level="object"),
                                dict(top_level="array"), dict(max_depth=3)])
def test_json_dfa_equal_jax(kw):
    _same_dfa(tc.json_dfa(**kw), jc.json_dfa(**kw))


def test_json_dfa_accepts_strict_json():
    d = tc.json_dfa(max_depth=6)
    for g in ['{"a": [1, 2.5e-3, "x\\n", true, null]}', "[]", " 42 ",
              '"hi"', '{"k": {"n": {"d": [[1]]}}}', "-0.5",
              '[{"a":1},{"b":[false]}]', '{"u": "\\u00e9"}']:
        assert d.matches(g.encode()), g
    for b in ["{a:1}", "[1,]", '{"a":}', "01", '"unterminated', '{"a" 1}',
              "tru", "[1 2]", "{,}", "+5", "--1", '{"a":1,}', "1.e3",
              '["\\q"]']:
        assert not d.matches(b.encode()), b
    assert d.matches(("[" * 6 + "1" + "]" * 6).encode())
    assert not d.matches(("[" * 7 + "1" + "]" * 7).encode())
    for i in range(100):
        r = random.Random(i)

        def gen(depth):
            c = r.randint(0, 5 if depth < 3 else 3)
            if c == 0:
                return r.randint(-99, 99)
            if c == 1:
                return round(r.uniform(-5, 5), 3)
            if c == 2:
                return r.choice([True, False, None])
            if c == 3:
                return 'a"b\\c\n'[: r.randint(0, 5)]
            if c == 4:
                return [gen(depth + 1) for _ in range(r.randint(0, 3))]
            return {f"k{j}": gen(depth + 1) for j in range(r.randint(0, 3))}

        s = json.dumps(gen(0))
        assert d.matches(s.encode()), s


def test_choice_and_literal_equal_jax():
    c = tc.choice_dfa(["alpha", "beta", "alp"])
    _same_dfa(c, jc.choice_dfa(["alpha", "beta", "alp"]))
    assert c.matches(b"alp") and not c.matches(b"alph")
    _same_dfa(tc.literal_dfa("héllo"), jc.literal_dfa("héllo"))


@pytest.mark.parametrize("spec", ["json", "json_object", "json_array",
                                  ["a", "b"], r"[0-9]+"])
def test_compiled_tables_equal_jax(spec):
    """compile_constraint's int32 [n_states, vocab] table and its first-
    token mask, byte-level vocab of 512 with EOS 257."""
    got = tc.compile_constraint(spec, 512, 257)
    want = jc.compile_constraint(spec, 512, 257)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.allowed0(), want.allowed0())


def test_vocab_table_byte_level():
    con = tc.compile_constraint("json_object", vocab_size=512, eos_id=257)
    assert con.table[0, ord("{")] >= 0 and con.table[0, ord("}")] == -1
    assert con.table[0, 257] == -1
    assert (con.table[:, 256] == -1).all()
    assert (con.table[:, 258:] == -1).all()
    s = 0
    for b in b'{"a": 1}':
        s = int(con.table[s, b])
        assert s >= 0
    assert int(con.table[s, 257]) == s


def test_vocab_table_multibyte_tokens_equal_jax():
    tb = {300: b'{"', 301: b'a":', 302: b"1}", 303: b"}"}
    vt = tc.vocab_table(tc.json_dfa(top_level="object"), 512, 257, tb)
    np.testing.assert_array_equal(
        vt, jc.vocab_table(jc.json_dfa(top_level="object"), 512, 257, tb))
    s3 = int(vt[int(vt[int(vt[0, 300]), 301]), 302])
    assert s3 >= 0 and int(vt[s3, 257]) == s3
    assert int(vt[0, 303]) == -1


def test_unconstrained_identity():
    u = tc.unconstrained(512)
    assert u.table.shape == (1, 512) and (u.table == 0).all()


@pytest.mark.parametrize("compact", [False, True])
def test_schema_dfa_equal_jax(compact):
    _same_dfa(tc.schema_dfa(SCHEMA, compact=compact),
              jc.schema_dfa(SCHEMA, compact=compact))
    d = tc.schema_dfa(SCHEMA, compact=compact)
    assert d.matches(b'{"label":3,"tags":["a","b"]}')
    assert not d.matches(b'{"label":"yes","tags":[]}')


def test_schema_dfa_pydantic_roundtrip():
    """Accepted documents validate against the pydantic model; type and
    key violations are rejected at the automaton level; the default caps
    close free-form strings and arrays."""
    from typing import List as TList, Optional as TOpt

    from pydantic import BaseModel

    class Verdict(BaseModel):
        statement: str
        verdict: int

    class Out(BaseModel):
        statements: TList[Verdict]
        score: float
        ok: bool
        note: TOpt[str] = None

    dfa = tc.schema_dfa(Out.model_json_schema())
    _same_dfa(dfa, jc.schema_dfa(Out.model_json_schema()))
    good = '{"statements": [{"statement": "a", "verdict": 0}], ' \
        '"score": -2.5e3, "ok": false, "note": "x"}'
    assert dfa.matches(good.encode())
    Out.model_validate_json(good)
    assert not dfa.matches(b'{"score": 1, "ok": true, "note": null}')
    capped = tc.schema_dfa(Out.model_json_schema(), compact=True,
                           default_max_string=20, default_max_items=2)
    _same_dfa(capped, jc.schema_dfa(Out.model_json_schema(), compact=True,
                                    default_max_string=20,
                                    default_max_items=2))
