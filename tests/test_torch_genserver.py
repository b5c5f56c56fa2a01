"""The port's continuous-batching generation server
(a_nice_rag_tpu_torch/serving/genserver.py) against the JAX package's
decoder, on the CPU.

Mirrors tests/test_genserver.py case by case: every greedy stream the
server emits — under staggered admission, slot reuse, wave, per-slot,
chunked and prefix-cached prefill, speculative ticks, cancellation and
retained prefixes — equals the JAX package's ``generate_stream`` for the
same weights (2 layers, hidden 128, the byte vocabulary, float32; params
carried across with ``decoder_state_dict``) token for token. Sampled
streams use the port's own generator, so they are held to their own
reproducibility and validity; log-probabilities within 1e-4 of a direct
forward. Tensor parallelism (``mesh=``) is in test_torch_lm_tp.py.
"""

import functools

import jax
import pytest
import torch

from a_nice_rag_tpu.models.decoder import generate_stream
from a_nice_rag_tpu.models.decoder import init_decoder as jax_init
from a_nice_rag_tpu.models.decoder import small_lm_config as jax_config
from a_nice_rag_tpu_torch.models.convert import (
    decoder_state_dict,
    load_decoder_state,
)
from a_nice_rag_tpu_torch.models.decoder import (
    ByteTokenizer,
    init_caches,
    small_lm_config,
)
from a_nice_rag_tpu_torch.serving.genserver import _END, GenerationServer

DRAFT = dict(num_layers=1, hidden_size=64, num_heads=2, num_kv_heads=1,
             head_dim=32, intermediate_size=128)


@functools.lru_cache(maxsize=None)
def _jax_pair(seed=0, draft=False):
    cfg = jax_config(**DRAFT) if draft else jax_config()
    model, params = jax_init(cfg, seed=seed)
    port = load_decoder_state(
        small_lm_config(**DRAFT) if draft else small_lm_config(),
        decoder_state_dict(jax.device_get(params)), device="cpu")
    return model, params, port


def _setup():
    return _jax_pair()[2]


def _draft_setup():
    return _jax_pair(7, True)[2]


@functools.lru_cache(maxsize=None)
def _jax_ref(prompt, budget, eos_id):
    model, params, _ = _jax_pair()
    kw = {} if eos_id is None else dict(eos_id=eos_id)
    return tuple(generate_stream(model, params, list(prompt),
                                 max_new_tokens=budget, **kw))


def _ref(prompt, budget, eos_id=None):
    """The JAX package's greedy stream for ``prompt``."""
    return list(_jax_ref(tuple(prompt), budget, eos_id))


def _collect(req):
    out = []
    while True:
        item = req.out.get_nowait()
        if item is _END:
            return out, True
        out.append(item)


def test_concurrent_requests_match_single_stream():
    port = _setup()
    srv = GenerationServer(port, slots=3, max_len=128, chunk=4)
    prompts = [
        list(range(10, 22)),
        [256, 40, 41],
        list(range(60, 84)),
        list(range(5, 9)),  # 4th waits for a free slot
    ]
    budgets = [9, 17, 5, 13]
    reqs = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    srv.drain()
    for p, b, req in zip(prompts, budgets, reqs):
        ref = _ref(p, b)
        got, ended = _collect(req)
        assert ended and got == ref, (p[:2], ref, got)


def test_staggered_admission_mid_decode():
    """A request admitted while others are mid-decode must not perturb
    them (rows are independent), and must itself decode exactly."""
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4)
    r1 = srv.submit(list(range(10, 30)), 12)
    srv.tick()
    srv.tick()
    r2 = srv.submit([256, 7, 8, 9], 12)  # lands in slot 1 mid-flight
    srv.drain()
    for p, req in [(list(range(10, 30)), r1), ([256, 7, 8, 9], r2)]:
        ref = _ref(p, 12)
        got, ended = _collect(req)
        assert ended and got == ref


def test_slot_reuse_after_retirement():
    """More requests than slots: retired slots get reused and later
    requests still decode exactly (stale cache rows fully overwritten)."""
    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=96, chunk=4)
    prompts = [list(range(10 + i, 20 + 2 * i)) for i in range(4)]
    reqs = [srv.submit(p, 7) for p in prompts]
    srv.drain()
    for p, req in zip(prompts, reqs):
        ref = _ref(p, 7)
        got, ended = _collect(req)
        assert ended and got == ref


def test_budget_and_capacity_guard():
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=64, chunk=8)
    try:
        srv.submit(list(range(40)), 32)
        raise AssertionError("capacity guard did not trip")
    except ValueError:
        pass
    req = srv.submit([256, 3, 4], 1)  # budget of exactly one token
    srv.drain()
    got, ended = _collect(req)
    assert ended and len(got) == 1


def test_background_thread_stream_text():
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4)
    srv.start()
    try:
        text = "".join(srv.stream_text("hello", max_new_tokens=8))
        tok = ByteTokenizer()
        # Text comes from the same ids (untrained weights: arbitrary but
        # deterministic bytes).
        assert text == tok.decode(_ref(tok.encode("hello"), 8))
    finally:
        srv.stop()


def test_prefix_cache_parity_and_hits():
    """cache_prefix precomputes a shared prompt prefix's KV rows;
    admissions that start with it prefill only their suffix and must
    produce the exact same greedy stream as uncached requests."""
    port = _setup()
    prefix = list(range(30, 70))  # 40-token shared system prompt
    tails = [[256, 5, 6, 7], list(range(80, 95)), [256, 9]]
    prompts = [prefix + t for t in tails]
    refs = [_ref(p, 10)
            for p in prompts]

    srv = GenerationServer(port, slots=2, max_len=160, chunk=4)
    srv.cache_prefix(prefix)
    reqs = [srv.submit(p, 10) for p in prompts]
    srv.drain()
    for ref, req in zip(refs, reqs):
        got, ended = _collect(req)
        assert ended and got == ref
    assert srv.prefix_hits == len(prompts)

    # A prompt NOT starting with the prefix takes the full-prefill path.
    other = list(range(200, 230))
    ref = _ref(other, 6)
    req = srv.submit(other, 6)
    srv.drain()
    got, ended = _collect(req)
    assert ended and got == ref
    assert srv.prefix_hits == len(prompts)  # unchanged


def test_prefix_cache_lru_eviction():
    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=96, chunk=4)
    srv.prefix_cache_max = 2
    p1, p2, p3 = [list(range(i, i + 20)) for i in (10, 40, 70)]
    srv.cache_prefix(p1)
    srv.cache_prefix(p2)
    srv.cache_prefix(p3)  # evicts p1
    assert len(srv._prefix_cache) == 2
    assert tuple(p1) not in srv._prefix_cache
    # Evicted prefix still decodes correctly via the full path.
    ref = _ref(p1 + [256], 5)
    req = srv.submit(p1 + [256], 5)
    srv.drain()
    got, ended = _collect(req)
    assert ended and got == ref


def test_speculative_server_matches_single_stream():
    """Batched speculation (draft proposes, target verifies, every slot
    at its own offset in one dispatch) must leave every greedy stream
    bit-identical to target-only decoding — including staggered
    admission and slot reuse, where per-slot accept counts differ."""
    port = _setup()
    draft = _draft_setup()
    srv = GenerationServer(port, slots=2, max_len=128,
                           draft_model=draft,
                           gamma=3)
    prompts = [
        list(range(10, 22)),
        [256, 40, 41],
        list(range(60, 84)),  # waits for a retired slot
    ]
    budgets = [9, 17, 5]
    reqs = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    srv.tick()
    late = srv.submit([256, 7, 8, 9], 12)  # admitted mid-flight
    srv.drain()
    checks = list(zip(prompts + [[256, 7, 8, 9]], budgets + [12],
                      reqs + [late]))
    for p, b, req in checks:
        ref = _ref(p, b)
        got, ended = _collect(req)
        assert ended and got == ref, (p[:2], ref, got)


def test_speculative_server_self_draft_full_accept():
    """With draft == target every greedy proposal verifies, so each
    tick advances an active row by exactly gamma+1 tokens."""
    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=128,
                           draft_model=port,
                           gamma=4)
    req = srv.submit(list(range(10, 20)), 11)
    srv.tick()  # admission (1 token) + first spec round
    assert req.emitted == 1 + 5
    srv.drain()
    got, ended = _collect(req)
    ref = _ref(list(range(10, 20)), 11)
    assert ended and got == ref


def test_speculative_server_capacity_guard_and_sampled_smoke():
    port = _setup()
    draft = _draft_setup()
    srv = GenerationServer(port, slots=1, max_len=32,
                           draft_model=draft,
                           gamma=4)
    try:
        srv.submit(list(range(20)), 10)  # 20 + 10 + 4 > 32
        raise AssertionError("spec capacity guard did not trip")
    except ValueError:
        pass
    srv2 = GenerationServer(port, slots=2, max_len=96,
                            temperature=0.8, top_k=40,
                            draft_model=draft,
                            gamma=3, seed=3)
    reqs = [srv2.submit(list(range(10 + i, 18 + i)), 9)
            for i in range(3)]
    srv2.drain()
    for req in reqs:
        got, ended = _collect(req)
        assert ended and 0 <= len(got) <= 9
        assert all(0 <= t < 260 for t in got)


def test_chunked_prefill_matches_unchunked():
    """prefill_chunk=C prefills C tokens per tick into partial rows;
    the resulting streams must be identical to whole-prompt prefill."""
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=256,
                           chunk=4, prefill_chunk=16)
    prompts = [
        list(range(10, 60)),   # 50 tokens: 4 chunks
        [256, 3, 4],           # shorter than one chunk
        list(range(5, 40)),    # waits for a slot, 3 chunks
    ]
    budgets = [9, 12, 7]
    reqs = [srv.submit(p, b) for p, b in zip(prompts, budgets)]
    srv.drain()
    for p, b, req in zip(prompts, budgets, reqs):
        ref = _ref(p, b)
        got, ended = _collect(req)
        assert ended and got == ref, (len(p), ref, got)


def test_chunked_prefill_does_not_stall_active_streams():
    """While a long prompt prefills chunk-by-chunk, already-active
    streams keep emitting every tick (the whole point)."""
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=256,
                           chunk=4, prefill_chunk=8)
    p1 = [256, 5, 6, 7]
    r1 = srv.submit(p1, 60)
    srv.tick()  # admits + completes p1's (single-chunk) prefill, decodes
    assert r1.emitted >= 1
    p2 = list(range(10, 74))  # 64 tokens = 8 chunks
    r2 = srv.submit(p2, 6)
    for _ in range(7):  # prefill in progress the whole time
        before = r1.emitted
        srv.tick()
        assert r1.emitted > before, "active stream stalled during prefill"
        assert r2.emitted == 0
    srv.drain()
    ref1 = _ref(p1, 60)
    ref2 = _ref(p2, 6)
    got1, _ = _collect(r1)
    got2, _ = _collect(r2)
    assert got1 == ref1 and got2 == ref2


def test_chunked_prefill_near_full_row_no_clamp():
    """A near-full prompt whose final chunk extends past max_len must
    still decode exactly: chunk writes land in the partial rows' slack
    region instead of being clamped backwards (which silently shifted
    the last tokens and corrupted the row). 250 tokens at chunk=24 puts
    the final write at offset 240 with extent 264 > max_len=256."""
    port = _setup()
    prompt = [10 + (i % 200) for i in range(250)]
    ref = _ref(prompt, 3)
    srv = GenerationServer(port, slots=1, max_len=256,
                           chunk=4, prefill_chunk=24)
    req = srv.submit(prompt, 3)
    srv.drain()
    got, ended = _collect(req)
    assert ended and got == ref, (ref, got)


def test_chunked_prefill_near_full_row_with_prefix_cache():
    """Same overflow scenario through the cached-prefix path: the
    stored prefix rows are padded with slack before chunking resumes
    at a non-chunk-aligned offset (100 + k*16 reaches 244+16 > 256)."""
    port = _setup()
    prefix = [30 + (i % 150) for i in range(100)]
    tail = [256] + [5 + (i % 90) for i in range(149)]
    prompt = prefix + tail  # 250 tokens
    ref = _ref(prompt, 3)
    srv = GenerationServer(port, slots=1, max_len=256,
                           chunk=4, prefill_chunk=16)
    srv.cache_prefix(prefix)
    req = srv.submit(prompt, 3)
    srv.drain()
    assert srv.prefix_hits == 1
    got, ended = _collect(req)
    assert ended and got == ref, (ref, got)


def test_prefill_chunk_validation():
    port = _setup()
    for bad in (0, -4, 129):
        try:
            GenerationServer(port, max_len=128,
                             prefill_chunk=bad)
            raise AssertionError(f"prefill_chunk={bad} accepted")
        except ValueError:
            pass


def test_short_prompt_not_blocked_behind_long_prefill():
    """A single-chunk prompt arriving while a long incremental prefill
    is in flight is admitted via whole-prompt prefill into a free slot
    instead of waiting for the long prefill to finish."""
    port = _setup()
    srv = GenerationServer(port, slots=3, max_len=256,
                           chunk=4, prefill_chunk=8)
    busy_p = [256, 1, 2]
    r_busy = srv.submit(busy_p, 60)
    srv.tick()  # slot 0 actively decoding -> prefills stay paced
    long_p = list(range(10, 74))  # 64 tokens = 8 chunks
    r_long = srv.submit(long_p, 6)
    srv.tick()  # starts the chunked prefill (not yet done)
    assert srv._pf is not None
    short_p = [256, 5, 6]
    r_short = srv.submit(short_p, 8)
    srv.tick()
    assert srv._pf is not None, "long prefill should still be in flight"
    assert r_short.emitted >= 1, "short prompt head-of-line blocked"
    assert r_long.emitted == 0
    srv.drain()
    for p, b, req in [(busy_p, 60, r_busy), (long_p, 6, r_long),
                      (short_p, 8, r_short)]:
        ref = _ref(p, b)
        got, ended = _collect(req)
        assert ended and got == ref


def test_idle_server_runs_prefill_to_completion_in_one_tick():
    """With no active streams to protect, chunked prefill must not pace
    itself at one chunk per tick (each tick is a dispatch round-trip):
    a single tick on an idle server completes the whole prefill and
    starts decoding."""
    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=256,
                           chunk=4, prefill_chunk=8)
    req = srv.submit(list(range(10, 74)), 6)  # 8 chunks
    srv.tick()
    assert srv._pf is None
    assert req.emitted >= 1


def test_chunked_prefill_with_prefix_cache_and_draft():
    """Chunked prefill composes with prefix caching (only the suffix is
    chunked) and with speculative decode (draft prefills on completion)."""
    port = _setup()
    draft = _draft_setup()
    srv = GenerationServer(port, slots=2, max_len=256,
                           prefill_chunk=8, draft_model=draft, gamma=3)
    prefix = list(range(30, 62))  # 32 tokens
    srv.cache_prefix(prefix)
    prompt = prefix + [256, 9, 8, 7]
    req = srv.submit(prompt, 10)
    srv.drain()
    assert srv.prefix_hits == 1
    got, ended = _collect(req)
    ref = _ref(prompt, 10)
    assert ended and got == ref


def test_cancel_pending_request_never_admitted():
    """A request cancelled while still queued is discarded at admission
    (no prefill dispatch) and its consumer is unblocked with the end
    sentinel; later requests still decode exactly."""
    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=96, chunk=4)
    r1 = srv.submit([256, 3, 4, 5], 6)
    r2 = srv.submit(list(range(10, 20)), 6)   # waits behind r1
    r3 = srv.submit(list(range(40, 50)), 6)   # waits behind r2
    srv.cancel(r2)
    srv.drain()
    got2, ended2 = _collect(r2)
    assert ended2 and got2 == [] and r2.cancelled
    for p, req in [([256, 3, 4, 5], r1), (list(range(40, 50)), r3)]:
        ref = _ref(p, 6)
        got, ended = _collect(req)
        assert ended and got == ref


def test_cancel_active_request_frees_slot_mid_decode():
    """Cancelling an active request retires its slot immediately; the
    other slot's stream is unperturbed and a queued request gets the
    freed slot."""
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4)
    p1, p2, p3 = list(range(10, 30)), [256, 7, 8, 9], list(range(50, 60))
    r1 = srv.submit(p1, 16)
    r2 = srv.submit(p2, 16)
    r3 = srv.submit(p3, 8)  # queued: both slots busy
    srv.tick()
    assert r1.emitted >= 1 and r2.emitted >= 1 and r3.emitted == 0
    srv.cancel(r1)
    assert srv._active[r1.slot] is None  # slot freed immediately
    srv.drain()
    got1, ended1 = _collect(r1)
    ref1 = _ref(p1, 16)
    assert ended1 and 1 <= len(got1) < 16
    assert got1 == ref1[: len(got1)]  # a clean prefix, then the sentinel
    for p, b, req in [(p2, 16, r2), (p3, 8, r3)]:
        ref = _ref(p, b)
        got, ended = _collect(req)
        assert ended and got == ref


def test_stream_generator_close_cancels():
    """Closing a stream() generator early (what the SSE handler does on
    client disconnect) cancels the request and frees its slot."""
    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=128, chunk=4)
    srv.start()
    try:
        gen = srv.stream(list(range(10, 20)), 40)
        got = [next(gen), next(gen)]
        gen.close()  # consumer walks away after two tokens
        assert len(got) == 2
        # The slot must free up for the next request promptly.
        out = list(srv.stream([256, 4, 5], 5))
        ref = _ref([256, 4, 5], 5)
        assert out == ref
        assert srv.cancelled_count == 1
    finally:
        srv.stop()


def test_cancel_during_chunked_prefill_drops_inflight():
    """Cancelling the request whose incremental prefill is in flight
    drops the partial rows and frees the slot; queued work proceeds."""
    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=256,
                           chunk=4, prefill_chunk=8)
    long_p = list(range(10, 74))  # 8 chunks
    r1 = srv.submit(long_p, 6)
    r2 = srv.submit([256, 3, 4], 6)
    # Occupy the loop so prefill paces one chunk per tick: add an
    # active decode first? slots=1, so instead advance two partial
    # chunks by hand via tick with pending decode absent -> idle server
    # completes in one tick. Start the prefill state directly.
    srv._admit()
    assert srv._pf is not None and srv._pf["req"] is r1
    srv._advance_prefill()  # one chunk done, prefill still in flight
    assert srv._pf is not None
    srv.cancel(r1)
    assert srv._pf is None and srv._active[0] is None
    srv.drain()
    got1, ended1 = _collect(r1)
    assert ended1 and got1 == []
    got2, ended2 = _collect(r2)
    ref2 = _ref([256, 3, 4], 6)
    assert ended2 and got2 == ref2


def test_stats_counters():
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4)
    s0 = srv.stats()
    assert s0["active"] == 0 and s0["pending"] == 0 and s0["ticks"] == 0
    r1 = srv.submit([256, 3, 4], 9)
    r2 = srv.submit(list(range(10, 20)), 9)
    r3 = srv.submit(list(range(30, 40)), 9)
    s1 = srv.stats()
    assert s1["pending"] == 3
    srv.tick()
    s2 = srv.stats()
    assert s2["active"] == 2 and s2["pending"] == 1
    assert s2["ticks"] == 1 and s2["tokens_emitted"] >= 2
    srv.cancel(r3)
    srv.drain()
    s3 = srv.stats()
    assert s3["active"] == 0 and s3["pending"] == 0
    assert s3["cancelled"] == 1
    assert s3["tokens_emitted"] == r1.emitted + r2.emitted
    assert s3["slots"] == 2 and s3["speculative"] is False
    assert s3["tensor_parallel"] == 1
    for req in (r1, r2):
        got, ended = _collect(req)
        assert ended and len(got) == 9


def test_per_request_sampling_mixed_batch():
    """A greedy request and sampled requests share one decode program;
    the greedy stream stays bit-identical to the single-stream
    reference, and sampled requests with degenerate truncation
    (top_k=1, or a tiny nucleus) must ALSO equal the greedy stream —
    an exact end-to-end check of the per-row truncation path."""
    port = _setup()
    srv = GenerationServer(port, slots=3, max_len=128, chunk=4)
    p1, p2, p3 = list(range(10, 22)), [256, 40, 41], list(range(60, 70))
    r1 = srv.submit(p1, 9)                                   # greedy
    r2 = srv.submit(p2, 9, temperature=1.0, top_k=1)         # == greedy
    r3 = srv.submit(p3, 9, temperature=2.0, top_p=1e-6)      # == greedy
    srv.drain()
    for p, req in [(p1, r1), (p2, r2), (p3, r3)]:
        ref = _ref(p, 9)
        got, ended = _collect(req)
        assert ended and got == ref, (p[:2], ref, got)


def test_per_request_sampling_is_reproducible_and_per_slot():
    """Same seed + same submission order -> same sampled streams; a
    genuinely sampled request (temperature only) produces valid tokens
    and does not perturb a concurrent greedy stream."""
    port = _setup()

    def run():
        srv = GenerationServer(port, slots=2, max_len=128,
                               chunk=4, seed=11)
        g = srv.submit(list(range(10, 20)), 8)
        s = srv.submit([256, 5, 6], 8, temperature=0.9, top_k=12)
        srv.drain()
        return _collect(g)[0], _collect(s)[0]

    g1, s1 = run()
    g2, s2 = run()
    assert g1 == g2 and s1 == s2
    ref = _ref(list(range(10, 20)), 8)
    assert g1 == ref                       # greedy row unperturbed
    assert all(0 <= t < 260 for t in s1)   # sampled row valid


def test_per_request_sampling_rejected_in_speculative_mode():
    port = _setup()
    draft = _draft_setup()
    srv = GenerationServer(port, slots=2, max_len=128,
                           draft_model=draft,
                           gamma=2)
    try:
        srv.submit([256, 3], 4, temperature=0.5)
        raise AssertionError("override accepted in speculative mode")
    except ValueError:
        pass
    # Overrides equal to the server defaults are fine.
    srv.submit([256, 3], 4, temperature=0.0, top_k=0, top_p=0.0)


def test_generate_payload_sampling_knobs():
    """/v1/generate payload temperature/top_k/top_p reach the server:
    top_k=1 at temperature 1.0 equals the greedy completion."""
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4)
    srv.start()
    try:
        api = ServingAPI(None, gen_server=srv)
        greedy = api.generate({"prompt": "hi", "max_tokens": 6})["text"]
        pinned = api.generate({"prompt": "hi", "max_tokens": 6,
                               "temperature": 1.0, "top_k": 1})["text"]
        assert pinned == greedy
    finally:
        srv.stop()


def test_stop_token_ids_truncate_stream():
    """A per-request stop token retires the request without emitting
    the stop token; other requests with no stop set are unaffected."""
    port = _setup()
    p = list(range(10, 22))
    ref = _ref(p, 12)
    # First token that has not occurred earlier in the stream (the
    # untrained LM repeats tokens; the stop must match at its index).
    i = next(j for j in range(1, len(ref)) if ref[j] not in ref[:j])
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4)
    r_stop = srv.submit(p, 12, stop_token_ids=[ref[i]])
    r_full = srv.submit(p, 12)
    srv.drain()
    got_s, ended_s = _collect(r_stop)
    got_f, ended_f = _collect(r_full)
    assert ended_s and got_s == ref[:i]
    assert ended_f and got_f == ref


def test_stop_strings_in_stream_text():
    """String stop sequences end the text stream just before the
    earliest match (the match is never emitted), including matches that
    straddle chunk boundaries, and cancel the underlying request."""
    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=128, chunk=4)
    srv.start()
    try:
        full = "".join(srv.stream_text("hello", max_new_tokens=24))
        assert len(full) >= 6
        # Use a mid-text substring as the stop sequence.
        cut = len(full) // 2
        stop = full[cut:cut + 3]
        first = full.find(stop)  # may appear earlier than `cut`
        out = "".join(srv.stream_text("hello", max_new_tokens=24,
                                      stop=[stop]))
        assert out == full[:first], (full, stop, out)
        # Multiple stops: the earliest match wins.
        out2 = "".join(srv.stream_text("hello", max_new_tokens=24,
                                       stop=[full[cut:cut + 3],
                                             full[2:4]]))
        assert out2 == full[:min(first, full.find(full[2:4]))]
        # A stop that never occurs changes nothing.
        out3 = "".join(srv.stream_text("hello", max_new_tokens=24,
                                       stop=["\x00ZZZ\x00"]))
        assert out3 == full
    finally:
        srv.stop()


def test_max_pending_backpressure():
    from a_nice_rag_tpu_torch.serving.genserver import ServerBusy

    port = _setup()
    srv = GenerationServer(port, slots=1, max_len=96, chunk=4,
                           max_pending=2)
    r1 = srv.submit([256, 3, 4], 5)
    r2 = srv.submit([256, 5, 6], 5)
    try:
        srv.submit([256, 7, 8], 5)
        raise AssertionError("ServerBusy not raised at max_pending")
    except ServerBusy:
        pass
    srv.drain()  # queued work still completes
    for prompt, req in [([256, 3, 4], r1), ([256, 5, 6], r2)]:
        ref = _ref(prompt, 5)
        got, ended = _collect(req)
        assert ended and got == ref
    # Queue drained: submissions are accepted again.
    r3 = srv.submit([256, 9], 5)
    srv.drain()
    assert _collect(r3)[1]


def test_logprobs_and_finish_reason():
    """Every emitted token carries its raw-distribution logprob; greedy
    logprobs are the max log-softmax entry; finish_reason reflects how
    the stream ended."""
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4)
    p = list(range(10, 22))
    out = srv.complete(p, 9)
    srv.stop()
    assert len(out["logprobs"]) == len(out["tokens"])
    assert out["finish_reason"] in ("stop", "length")
    assert all(lp <= 0.0 for lp in out["logprobs"])
    ref = _ref(p, 9)
    assert out["tokens"] == ref
    # Recompute the first decode-step logprob independently: run the
    # prompt + first token through the raw forward and compare.
    if len(out["tokens"]) >= 2:
        ids = torch.tensor([p + out["tokens"][:1]])
        with torch.no_grad():
            logits = port(ids, *init_caches(port.cfg, 1, 128, "cpu"), 0)[0]
        lsm = torch.log_softmax(logits[0, -1], dim=-1)
        expect = float(lsm[out["tokens"][1]])
        assert abs(out["logprobs"][1] - expect) < 1e-4
    # finish_reason: budget exhaustion is "length"; cancellation is
    # "cancelled".
    srv2 = GenerationServer(port, slots=1, max_len=96, chunk=4)
    r = srv2.submit([256, 3, 4], 2)
    srv2.drain()
    got, _ = _collect(r)
    if len(got) == 2:
        assert r.finish_reason == "length"
    else:
        assert r.finish_reason == "stop"
    r2 = srv2.submit(list(range(10, 20)), 50)
    srv2.tick()
    assert not r2.finished  # still mid-decode (long budget)
    srv2.cancel(r2)
    assert r2.finish_reason == "cancelled"


def test_complete_with_stop_token_matches_stream():
    port = _setup()
    p = [256, 40, 41]
    ref = _ref(p, 10)
    i = next((j for j in range(1, len(ref)) if ref[j] not in ref[:j]),
             None)
    srv = GenerationServer(port, slots=1, max_len=96, chunk=4)
    if i is not None:
        out = srv.complete(p, 10, stop_token_ids=[ref[i]])
        assert out["tokens"] == ref[:i]
        assert out["finish_reason"] == "stop"
        assert len(out["logprobs"]) == i
    srv.stop()


def test_generate_payload_logprobs():
    """'logprobs': true returns tokens + per-token logprobs +
    finish_reason alongside the text."""
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4)
    srv.start()
    try:
        api = ServingAPI(None, gen_server=srv)
        out = api.generate({"prompt": "hi", "max_tokens": 6,
                            "logprobs": True})
        assert len(out["token_logprobs"]) == len(out["tokens"])
        assert out["finish_reason"] in ("stop", "length")
        plain = api.generate({"prompt": "hi", "max_tokens": 6})
        assert out["text"] == plain["text"]
        try:
            api.generate({"prompt": "hi", "logprobs": True,
                          "stop": ["x"]})
            raise AssertionError("stop+logprobs not rejected")
        except ValueError:
            pass
    finally:
        srv.stop()


def test_top_logprobs():
    """logprob_topk=K: every emitted token carries its top-K raw
    alternatives; the chosen greedy token is always rank 0 with a
    matching logprob; streams are unchanged by the knob."""
    port = _setup()
    base = GenerationServer(port, slots=2, max_len=128, chunk=4)
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4,
                           logprob_topk=3)
    p = list(range(30, 40))
    want = srv_out = None
    try:
        want = base.complete(p, 8)
        out = srv.complete(p, 8)
        assert out["tokens"] == want["tokens"]  # knob changes nothing
        tls = out["top_logprobs"]
        assert len(tls) == len(out["tokens"])
        for tok, lp, alts in zip(out["tokens"], out["logprobs"], tls):
            assert len(alts) == 3
            ids = [a[0] for a in alts]
            lps = [a[1] for a in alts]
            assert lps == sorted(lps, reverse=True)
            # Greedy choice == argmax == rank-0 alternative.
            assert ids[0] == tok
            assert abs(lps[0] - lp) < 1e-5
    finally:
        base.stop()
        srv.stop()


def test_top_logprobs_http():
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4,
                           logprob_topk=4)
    srv.start()
    try:
        api = ServingAPI(None, gen_server=srv)
        out = api.generate({"prompt": "hi", "max_tokens": 5,
                            "logprobs": True, "top_logprobs": 2})
        assert len(out["top_logprobs"]) == len(out["tokens"])
        assert all(len(alts) == 2 for alts in out["top_logprobs"])
        assert all("token" in a and "logprob" in a
                   for alts in out["top_logprobs"] for a in alts)
        # Server without the knob: clear 400-mapped error.
        plain = GenerationServer(port, slots=1, max_len=96,
                                 chunk=4)
        plain.start()
        try:
            api2 = ServingAPI(None, gen_server=plain)
            try:
                api2.generate({"prompt": "x", "logprobs": True,
                               "top_logprobs": 2})
                raise AssertionError("not rejected")
            except ValueError:
                pass
        finally:
            plain.stop()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Automatic prefix retention (retain_prefixes=N): retired rows become
# cached prefixes, so a follow-up request carrying the conversation so
# far prefills only its new tail — and decodes BIT-IDENTICALLY to a
# retention-free server (the cached-key rule covers exactly the
# positions whose KV the row holds).
# ---------------------------------------------------------------------------


def _complete(srv, prompt, budget):
    req = srv.submit(list(prompt), budget)
    srv.drain()
    toks, _ = _collect(req)
    return toks, req.finish_reason


def test_retained_prefix_multiturn_exact_stop_and_length():
    port = _setup()
    fresh = GenerationServer(port, slots=2, max_len=256, chunk=4)
    srv = GenerationServer(port, slots=2, max_len=256, chunk=4,
                           retain_prefixes=4)

    for budget in (40, 7):  # natural EOS stop and budget-truncated
        p1 = list(range(20, 44))
        t1, fr = _complete(srv, p1, budget)
        assert srv.prefix_retained >= 1
        # Turn 2: the conversation so far plus a new user turn.
        p2 = p1 + t1 + [50, 51, 52, 53]
        hits0 = srv.prefix_hits
        t2, _ = _complete(srv, p2, 12)
        assert srv.prefix_hits == hits0 + 1, fr
        ref, _ = _complete(fresh, p2, 12)
        assert t2 == ref, (fr, t2, ref)


def test_retained_prefix_lru_bound_and_cancel_excluded():
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4,
                           retain_prefixes=2)
    for base in (10, 60, 110, 160):
        _complete(srv, list(range(base, base + 8)), 5)
    assert len(srv._prefix_cache) <= 2  # LRU bound holds
    assert srv.prefix_retained >= 4

    # A cancelled stream must not poison the cache with a wrong key.
    retained0 = srv.prefix_retained
    gen = srv.stream(list(range(200, 214)), 30)
    next(gen)
    gen.close()  # cancel
    srv.drain()
    assert srv.prefix_retained == retained0


def test_retained_prefix_respects_stop_token_ids():
    """Custom stop tokens retire with reason 'stop'; the retained key
    must still reproduce the retention-free decode exactly."""
    port = _setup()
    fresh = GenerationServer(port, slots=1, max_len=256, chunk=4)
    srv = GenerationServer(port, slots=1, max_len=256, chunk=4,
                           retain_prefixes=4)
    p1 = list(range(30, 50))
    ref1, _ = _complete(fresh, p1, 16)
    stop_at = ref1[5]  # stop mid-stream on a token the model will emit
    t1, fr = _complete_stop(srv, p1, 16, stop_at)
    p2 = p1 + t1 + [77, 78]
    hits0 = srv.prefix_hits
    t2, _ = _complete(srv, p2, 8)
    ref2, _ = _complete(fresh, p2, 8)
    assert srv.prefix_hits == hits0 + 1
    assert t2 == ref2


def _complete_stop(srv, prompt, budget, stop_tok):
    req = srv.submit(list(prompt), budget, stop_token_ids=[stop_tok])
    srv.drain()
    toks, _ = _collect(req)
    return toks, req.finish_reason


def test_retained_prefix_partial_match_after_reencode_divergence():
    """A follow-up prompt that DIVERGES from the stored key before its
    end (the BPE-join re-encode case: decode(prompt+gen) need not
    re-encode to the same ids at the join) still hits the retained row
    for the common id prefix, and decodes bit-identically to a
    retention-free server."""
    port = _setup()
    fresh = GenerationServer(port, slots=2, max_len=256, chunk=4)
    srv = GenerationServer(port, slots=2, max_len=256, chunk=4,
                           retain_prefixes=4)
    p1 = list(range(20, 44))
    t1, _ = _complete(srv, p1, 10)
    assert srv.prefix_retained >= 1
    # Diverge IMMEDIATELY after the prompt: the stored key (p1 + fwd)
    # is NOT a prefix of p2, but shares the p1 prefix.
    bad = [t for t in (3, 4) if not t1 or t != t1[0]][0]
    p2 = p1 + [bad, 99, 98]
    hits0 = srv.prefix_hits
    t2, _ = _complete(srv, p2, 8)
    assert srv.prefix_hits == hits0 + 1
    ref, _ = _complete(fresh, p2, 8)
    assert t2 == ref


def test_stream_info_reports_finish_reason():
    """stream()/stream_text() surface the request's finish_reason via
    the mutable info dict: 'length' on budget exhaustion, 'stop' on a
    string-stop cut (the OpenAI truncation-detection contract)."""
    port = _setup()
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4)
    try:
        # Budget-bound: 3 tokens from an untrained model never EOSes.
        info = {}
        toks = list(srv.stream(list(range(10, 20)), 3, info=info))
        assert len(toks) == 3 and info["finish_reason"] == "length"

        # Text path, same budget rule.
        info = {}
        text = "".join(srv.stream_text("hello", max_new_tokens=3,
                                       info=info))
        assert info["finish_reason"] == "length"

        # String-stop cut: stop on a character the stream will emit.
        full = "".join(srv.stream_text("hello", max_new_tokens=6))
        if len(full) >= 2:
            info = {}
            _ = "".join(srv.stream_text("hello", max_new_tokens=6,
                                        stop=[full[1]], info=info))
            assert info["finish_reason"] == "stop"
    finally:
        srv.stop()


def test_wave_prefill_batches_burst_admissions():
    """A burst of whole-prompt admissions must run through the batched
    _prefill_wave program (power-of-two groups per length bucket, with
    the odd request falling through to the per-slot program), and the
    resulting streams + logprobs must stay bit-identical to single-
    stream decoding. Pins the round-5 wave-prefill dispatch shape."""
    port = _setup()
    srv = GenerationServer(port, slots=5, max_len=128, chunk=4,
                           logprob_topk=2)
    calls = {"wave": [], "single": 0}
    inner_wave, inner_one = srv._prefill_wave, srv._prefill_one

    def spy_wave(part, bucket):
        calls["wave"].append((len(part), bucket))
        return inner_wave(part, bucket)

    def spy_one(*a, **kw):
        calls["single"] += 1
        return inner_one(*a, **kw)

    srv._prefill_wave, srv._prefill_one = spy_wave, spy_one
    # Five same-bucket prompts (lengths 9..13 share the 16 bucket):
    # expect one W=4 wave + one per-slot singleton.
    prompts = [list(range(10 + i, 19 + 2 * i)) for i in range(5)]
    reqs = [srv.submit(p, 6) for p in prompts]
    srv.drain()
    assert calls["wave"] and calls["wave"][0][0] == 4
    assert calls["single"] == 1
    for p, req in zip(prompts, reqs):
        ref = _ref(p, 6)
        got, ended = _collect(req)
        assert ended and got == ref
        assert len(req.logprobs) == len(got)
        assert all(len(t) == 2 for t in req.top_logprobs)
        assert all(lp <= 0.0 for lp in req.logprobs)


def test_wave_prefill_equals_per_slot_prefill_with_bucket_rows():
    """A burst admitted as one [W, bucket] wave and the same burst
    admitted slot by slot give the same streams and log-probabilities
    (float32), and the wave's row buffers are bucket-long, not
    max_len-long."""
    port = _setup()
    prompts = [list(range(10 + i, 19 + 2 * i)) for i in range(4)]
    outs, rows = [], []
    for wave in (True, False):
        srv = GenerationServer(port, slots=4, max_len=256, chunk=4,
                               wave_prefill=wave)
        inner = srv._rows
        srv._rows = lambda cfg, b, n, inner=inner: (rows.append((b, n)),
                                                    inner(cfg, b, n))[1]
        reqs = [srv.submit(p, 6) for p in prompts]
        srv.drain()
        outs.append([(_collect(r)[0], r.logprobs) for r in reqs])
    assert outs[0] == outs[1]
    assert [t for t, _ in outs[0]] == [_ref(p, 6) for p in prompts]
    assert (4, 16) in rows and all(n == 16 for _, n in rows)


def test_mesh_raises_naming_the_roadmap_item():
    """mesh= serves tensor-parallel over the mesh's tp axis
    (tests/test_torch_lm_tp.py); a mesh without one raises rather than
    serving on one slot."""
    from a_nice_rag_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="no axis 'tp'"):
        GenerationServer(_setup(), mesh=make_mesh((2,), ("dp",),
                                                  devices=["cpu"] * 2))
