"""Guided decoding through the port's continuous-batching server
(a_nice_rag_tpu_torch/serving/genserver.py with
a_nice_rag_tpu_torch/models/constrain.py), against the JAX package's.

Mirrors tests/test_constrained_serving.py: constrained slots only emit
sequences the registered DFA accepts (greedy constrained streams equal
the JAX package's constrained server's, token for token, on the same
weights carried across with ``decoder_state_dict``), and unconstrained
slots on the same server equal a plain server's and the JAX package's
``generate_stream``. Sampled constrained streams use the port's own
generator and are held to the grammar.
"""

import functools
import json

import jax
import pytest

from a_nice_rag_tpu.models.decoder import (
    generate_stream,
    init_decoder,
    small_lm_config,
)
from a_nice_rag_tpu.serving.genserver import (
    GenerationServer as JaxGenerationServer,
)
from a_nice_rag_tpu_torch.models import decoder as td
from a_nice_rag_tpu_torch.models.constrain import json_dfa, regex_dfa
from a_nice_rag_tpu_torch.models.convert import (
    decoder_state_dict,
    load_decoder_state,
)
from a_nice_rag_tpu_torch.serving.genserver import _END, GenerationServer

CONSTRAINTS = {
    "json": "json",
    "json_object": "json_object",
    "digits": r"[0-9]{1,3}",
    "yesno": ["yes", "no"],
}


@functools.lru_cache(maxsize=None)
def _pair():
    model, params = init_decoder(small_lm_config())
    port = load_decoder_state(td.small_lm_config(),
                              decoder_state_dict(jax.device_get(params)),
                              device="cpu")
    return model, params, port


def _setup():
    return _pair()[2]


def _jax_constrained(prompt, budget, name):
    model, params, _ = _pair()
    srv = JaxGenerationServer(model, params, slots=2, max_len=96, chunk=4,
                              constraints=CONSTRAINTS)
    req = srv.submit(prompt, budget, constraint=name)
    srv.drain()
    out = []
    while not req.out.empty():
        item = req.out.get_nowait()
        if isinstance(item, int):
            out.append(item)
    return out


def _decode_bytes(tokens):
    return bytes(t for t in tokens if t < 256)


def test_choice_constraint_emits_exactly_one_option():
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=96, chunk=4,
                           constraints=CONSTRAINTS)
    for prompt in ([256, 10, 11], [256, 40, 2, 7], [256, 99]):
        out = srv.complete(prompt, 16, constraint="yesno")
        # Greedy under the mask: the JAX package's constrained server's
        # tokens.
        assert out["tokens"] == _jax_constrained(prompt, 16, "yesno")
        text = _decode_bytes(out["tokens"]).decode()
        assert text in ("yes", "no"), text
        # The trie's accept states have no outgoing bytes: after the
        # option completes, only EOS is allowed -> natural stop.
        assert out["finish_reason"] == "stop"
    srv.stop()


def test_regex_constraint_sampled():
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=96, chunk=4,
                           constraints=CONSTRAINTS)
    dfa = regex_dfa(r"[0-9]{1,3}")
    for i in range(4):
        out = srv.complete([256, 5 + i], 8, constraint="digits",
                           temperature=1.0)
        text = _decode_bytes(out["tokens"]).decode()
        assert out["finish_reason"] == "stop"  # <=3 digits, budget 8
        assert dfa.matches(text.encode()), text
    srv.stop()


def test_json_constraint_prefix_invariant():
    """Every emitted byte sequence is a live prefix of strict JSON
    (the DFA never dies); completed streams parse with json.loads."""
    port = _setup()
    srv = GenerationServer(port, slots=3, max_len=128, chunk=4,
                           constraints=CONSTRAINTS)
    dfa = json_dfa()
    stops = 0
    for i in range(6):
        out = srv.complete([256, 20 + i], 24, constraint="json",
                           temperature=1.0, top_k=0, top_p=0.0)
        data = _decode_bytes(out["tokens"])
        s = 0
        for b in data:
            s = int(dfa.next[s, b])
            assert s >= 0, (data, b)
        if out["finish_reason"] == "stop":
            stops += 1
            assert bool(dfa.accept[s])
            json.loads(data.decode())
    # Not all six need to finish within budget, but the machinery must
    # be exercised on at least one completed sentence.
    assert stops >= 1


def test_json_object_starts_with_brace():
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=96, chunk=4,
                           constraints=CONSTRAINTS)
    out = srv.complete([256, 33], 12, constraint="json_object",
                       temperature=1.0)
    data = _decode_bytes(out["tokens"])
    body = data.lstrip(b" \t\n\r")
    assert body[:1] == b"{", data
    srv.stop()


def test_unconstrained_rows_identical_to_plain_server():
    """A constraints-enabled server must not perturb unconstrained
    requests: greedy streams bit-identical to the plain server, even
    when a constrained request shares the batch."""
    port = _setup()
    plain = GenerationServer(port, slots=3, max_len=128,
                             chunk=4)
    guided = GenerationServer(port, slots=3, max_len=128,
                              chunk=4, constraints=CONSTRAINTS)
    prompts = [[256, 7, 8, 9], [256, 50, 51], [256, 3, 1, 4, 1, 5]]
    want = []
    for p in prompts:
        r = plain.submit(p, 10)
        plain.drain()
        toks = []
        while True:
            item = r.out.get_nowait()
            if item is _END:
                break
            toks.append(item)
        want.append(toks)
    reqs = [guided.submit(p, 10) for p in prompts]
    busy = guided.submit([256, 60], 20, constraint="json",
                         temperature=1.0)
    guided.drain()
    for r, w in zip(reqs, want):
        got = []
        while True:
            item = r.out.get_nowait()
            if item is _END:
                break
            got.append(item)
        assert got == w
        model, params, _ = _pair()
        assert got == list(generate_stream(model, params, r.prompt_ids,
                                           max_new_tokens=10))


def test_constraint_validation():
    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=96, chunk=4,
                           constraints=CONSTRAINTS)
    with pytest.raises(ValueError, match="unknown constraint"):
        srv.submit([256, 1], 4, constraint="nope")
    plain = GenerationServer(port, slots=1, max_len=96, chunk=4)
    with pytest.raises(ValueError, match="no constraints registered"):
        plain.submit([256, 1], 4, constraint="json")
    assert "digits" in srv.stats()["constraints"]


def test_http_generate_constraint_and_response_format():
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=96, chunk=4,
                           constraints=CONSTRAINTS)
    srv.start()
    try:
        api = ServingAPI(None, gen_server=srv)
        out = api.generate({"prompt": "q", "max_tokens": 12,
                            "constraint": "yesno"})
        assert out["text"] in ("yes", "no")
        out2 = api.generate({
            "prompt": "q", "max_tokens": 16, "temperature": 1.0,
            "logprobs": True,
            "response_format": {"type": "json_object"},
        })
        body = out2["text"].lstrip(" \t\n\r")
        assert body[:1] == "{"
        assert len(out2["token_logprobs"]) == len(out2["tokens"])
    finally:
        srv.stop()


def test_constraint_with_chunked_prefill():
    """Incremental prefill composes with guided decoding: the first
    sampled token is already masked."""
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4,
                           prefill_chunk=4, constraints=CONSTRAINTS)
    prompt = [256] + list(range(1, 14))  # multi-chunk prefill
    out = srv.complete(prompt, 16, constraint="yesno")
    assert _decode_bytes(out["tokens"]).decode() in ("yes", "no")
    srv.stop()
