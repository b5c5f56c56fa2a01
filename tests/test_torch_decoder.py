"""The port's decoder LM (a_nice_rag_tpu_torch/models/decoder.py) against
the JAX package's, on the CPU.

Mirrors tests/test_decoder.py. Each test builds the JAX package's
``DecoderLM`` (2 layers, hidden 128, the byte vocabulary, float32),
carries its params across with ``models.convert.decoder_state_dict`` and
feeds both the same seeded inputs. Tolerances: logits within 1e-5 of
JAX's (float32, another summation order); greedy token streams equal
token for token; the truncated logits equal exactly, -inf placement
included; sampled decisions equal under the JAX package's own Gumbel
draws (the port's own generator draws other noise, so its sampled
streams differ from JAX's and are held to their own reproducibility).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.models import decoder as jd
from a_nice_rag_tpu_torch.models import decoder as td
from a_nice_rag_tpu_torch.models.convert import (
    decoder_state_dict,
    load_decoder_state,
)

LOGITS_ATOL = 1e-5


def _port(jax_params, **cfg):
    return load_decoder_state(td.small_lm_config(**cfg),
                              decoder_state_dict(jax.device_get(jax_params)),
                              device="cpu")


@pytest.fixture(scope="module")
def pair():
    model, params = jd.init_decoder(jd.small_lm_config(), seed=0)
    return model, params, _port(params)


def test_bytetokenizer_roundtrip():
    tok = td.ByteTokenizer()
    for s in ["hello", "naïve café ☕", "диагноз", ""]:
        ids = tok.encode(s, add_bos=False)
        assert ids == jd.ByteTokenizer().encode(s, add_bos=False)
        assert tok.decode(ids) == s
    dec, jdec = td.ByteDecoder(), jd.ByteDecoder()
    out = ""
    for t in tok.encode("café ☕", add_bos=False):
        piece = dec.feed(t)
        assert piece == jdec.feed(t)
        out += piece
    out += dec.flush()
    assert out == "café ☕"


def test_logits_match_jax(pair):
    """The full causal forward's logits within 1e-5 of the JAX
    package's, batch of 2."""
    model, params, port = pair
    seq = np.random.default_rng(5).integers(0, 255, (2, 8))
    want = np.asarray(jd.lm_logits(model, params, jnp.asarray(seq,
                                                              jnp.int32)))
    got = td.lm_logits(port, torch.as_tensor(seq)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL)


def test_kv_cache_matches_full_forward(pair):
    """prefill(3 tokens) + 5 cached single-token steps == the full
    forward over the 8-token sequence, position by position."""
    _, _, port = pair
    seq = torch.as_tensor(np.random.default_rng(5).integers(0, 255, (1, 8)))
    full = td.lm_logits(port, seq)
    kc, vc = td.init_caches(port.cfg, 1, 8, "cpu")
    with torch.no_grad():
        pre, _, _ = port(seq[:, :3], kc, vc, 0)
        torch.testing.assert_close(pre, full[:, :3], rtol=2e-4, atol=2e-4)
        for t in range(3, 8):
            out, _, _ = port(seq[:, t:t + 1], kc, vc, t)
            torch.testing.assert_close(out[:, 0], full[:, t], rtol=2e-4,
                                       atol=2e-4)


def test_per_row_offsets_match_jax(pair):
    """cache_len as [B]: each row writes and attends at its own offset;
    logits and both caches equal the JAX package's per-row step."""
    model, params, port = pair
    cfg = jd.small_lm_config()
    rng = np.random.default_rng(9)
    b, smax = 3, 12
    pre = rng.integers(0, 255, (b, 6))
    step = rng.integers(0, 255, (b, 2))
    offs = np.asarray([2, 5, 4])
    jkc, jvc = jd.init_caches(cfg, b, smax)
    _, jkc, jvc = model.apply(params, jnp.asarray(pre, jnp.int32), jkc, jvc,
                              jnp.int32(0))
    jl, jkc, jvc = model.apply(params, jnp.asarray(step, jnp.int32), jkc,
                               jvc, jnp.asarray(offs, jnp.int32))
    kc, vc = td.init_caches(port.cfg, b, smax, "cpu")
    with torch.no_grad():
        port(torch.as_tensor(pre), kc, vc, 0)
        got, kc, vc = port(torch.as_tensor(step), kc, vc,
                           torch.as_tensor(offs))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGITS_ATOL)
    for a, bb in zip(kc + vc, jkc + jvc):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), rtol=0,
                                   atol=LOGITS_ATOL)


@pytest.mark.parametrize("offset", [9, 10, 11, 14])
def test_cache_write_clamps_at_the_edge(pair, offset):
    """A write whose start runs past Smax - s lands at Smax - s, as
    lax.dynamic_update_slice clamps it: per row and scalar, caches and
    logits equal the JAX package's at the cache's edge."""
    model, params, port = pair
    cfg = jd.small_lm_config()
    smax, s = 12, 3
    ids = np.random.default_rng(offset).integers(0, 255, (2, s))
    for per_row in (True, False):
        off = (jnp.asarray([offset, 1], jnp.int32) if per_row
               else jnp.int32(offset))
        jkc, jvc = jd.init_caches(cfg, 2, smax)
        jl, jkc, _ = model.apply(params, jnp.asarray(ids, jnp.int32), jkc,
                                 jvc, off)
        kc, vc = td.init_caches(port.cfg, 2, smax, "cpu")
        with torch.no_grad():
            got, kc, _ = port(torch.as_tensor(ids), kc, vc,
                              torch.as_tensor([offset, 1]) if per_row
                              else offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGITS_ATOL)
        np.testing.assert_allclose(kc[0].numpy(), np.asarray(jkc[0]),
                                   rtol=0, atol=LOGITS_ATOL)
        # The clamped rows hold the write at Smax - s.
        written = np.abs(kc[0][0].numpy()).sum(axis=(1, 2)) > 0
        assert written.nonzero()[0].tolist() == list(
            range(min(offset, smax - s), min(offset, smax - s) + s))


def test_causality(pair):
    """Changing a future token must not change earlier logits."""
    _, _, port = pair
    seq = np.random.default_rng(7).integers(0, 255, (1, 10))
    seq2 = seq.copy()
    seq2[0, 7:] = (seq2[0, 7:] + 13) % 255
    a = td.lm_logits(port, torch.as_tensor(seq))
    b = td.lm_logits(port, torch.as_tensor(seq2))
    torch.testing.assert_close(a[:, :7], b[:, :7], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(a[:, 8], b[:, 8])


def test_memorization_and_streaming_generation():
    """A tiny LM fitted by the JAX package's train_lm_steps and carried
    across: the port's greedy text stream reproduces the memorized
    continuation, equal to the JAX package's stream."""
    tok = jd.ByteTokenizer()
    phrase = "the dose is 42 mg daily. "
    ids = tok.encode(phrase * 6)
    cfg = jd.small_lm_config(hidden_size=96, num_layers=2)
    model, params = jd.init_decoder(cfg, seed=1, max_len=len(ids))
    params, losses = jd.train_lm_steps(
        model, params, jnp.asarray(ids, jnp.int32)[None, :], n_steps=150)
    assert losses[-1] < 0.25 * losses[0], (losses[0], losses[-1])
    port = _port(params, hidden_size=96, num_layers=2)
    got = "".join(td.generate_text_stream(port, phrase * 2,
                                          max_new_tokens=len(phrase)))
    want = "".join(jd.generate_text_stream(model, params, phrase * 2,
                                           max_new_tokens=len(phrase)))
    assert got == want
    assert phrase.strip() in (phrase * 2 + got), got


def test_generate_stream_stops_at_eos(pair):
    model, params, port = pair
    toks = list(td.generate_stream(port, [256, 10, 20], max_new_tokens=12))
    assert toks == list(jd.generate_stream(model, params, [256, 10, 20],
                                           max_new_tokens=12))
    assert len(toks) <= 12 and all(t != 257 for t in toks)


def test_decoder_matches_hf_causal_lm():
    """A (random-init) HF Qwen3ForCausalLM with tied embeddings loads
    into the port's DecoderLM as it is: full-forward logits and greedy
    KV-cache decode equal transformers'."""
    pytest.importorskip("transformers")
    from transformers import Qwen3Config as HFConfig
    from transformers import Qwen3ForCausalLM

    from a_nice_rag_tpu_torch.models.qwen3 import Qwen3Config

    torch.manual_seed(3)
    hf_cfg = HFConfig(
        vocab_size=211, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=24,
        intermediate_size=112, rope_theta=1_000_000.0, rms_norm_eps=1e-6,
        attention_dropout=0.0, tie_word_embeddings=True,
    )
    hf = Qwen3ForCausalLM(hf_cfg).eval()
    cfg = Qwen3Config.from_hf(hf_cfg, dtype=torch.float32)
    lm = load_decoder_state(cfg, hf.state_dict(), device="cpu")
    ids = np.random.default_rng(11).integers(1, 200, size=(2, 9))
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids)).logits
        hf_out = hf.generate(torch.tensor(ids[:1]), max_new_tokens=6,
                             do_sample=False, pad_token_id=0)[0, 9:]
    torch.testing.assert_close(td.lm_logits(lm, torch.as_tensor(ids)), ref,
                               rtol=3e-4, atol=3e-4)
    ours = list(td.generate_stream(lm, ids[0].tolist(), max_new_tokens=6,
                                   eos_id=-999))
    assert ours == hf_out.tolist()


def test_sampling_knobs(pair):
    """top-k masks everything outside the k best; top-p keeps the
    smallest nucleus; temperature 0 is exact argmax; seeded sampled
    generation is reproducible."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, -5.0]])
    g = torch.Generator().manual_seed(0)
    assert int(td.sample_logits(logits, g, temperature=0.0)[0]) == 0
    draws = {int(td.sample_logits(logits, g, temperature=1.5, top_k=2)[0])
             for _ in range(40)}
    assert draws == {0, 1}
    draws_p = {int(td.sample_logits(logits, g, temperature=2.0,
                                    top_p=0.05)[0]) for _ in range(20)}
    assert draws_p == {0}
    _, _, port = pair
    a, b = (list(td.generate_stream(port, [256, 5], max_new_tokens=8,
                                    temperature=0.8, top_k=40, seed=7))
            for _ in range(2))
    assert a == b


@pytest.mark.parametrize("t,k,p", [(1.0, 0, 0.0), (0.7, 8, 0.0),
                                   (1.3, 0, 0.9), (0.9, 16, 0.8)])
def test_truncated_logits_equal_jax(t, k, p):
    """truncated_logits and truncated_logits_dynamic equal the JAX
    package's exactly, -inf placement included."""
    logits = np.random.default_rng(3).normal(size=(6, 64)).astype(
        np.float32)
    want = np.asarray(jd.truncated_logits(jnp.asarray(logits), t, k, p))
    got = td.truncated_logits(torch.as_tensor(logits), t, k, p).numpy()
    np.testing.assert_array_equal(got, want)
    full = lambda v, dt: np.full((6,), v, dt)  # noqa: E731
    want_d = np.asarray(jd.truncated_logits_dynamic(
        jnp.asarray(logits), jnp.asarray(full(t, np.float32)),
        jnp.asarray(full(k, np.int32)), jnp.asarray(full(p, np.float32))))
    got_d = td.truncated_logits_dynamic(
        torch.as_tensor(logits), torch.as_tensor(full(t, np.float32)),
        torch.as_tensor(full(k, np.int64)),
        torch.as_tensor(full(p, np.float32))).numpy()
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(want))


def test_sampler_under_jax_gumbel_draws():
    """Given jax.random.gumbel's draws for the key, the port's static and
    dynamic samplers choose jax.random.categorical's tokens, on uniform
    and mixed per-row knobs."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 64)).astype(np.float32)
    temp = np.asarray([0.0, 1.0, 2.0, 1.5, 0.7, 1.0], np.float32)
    topk = np.asarray([0, 1, 0, 4, 8, 0], np.int32)
    topp = np.asarray([0.0, 0.0, 1e-6, 0.0, 0.9, 0.5], np.float32)
    for s in range(10):
        key = jax.random.PRNGKey(s)
        noise = torch.tensor(np.asarray(jax.random.gumbel(key, (6, 64))))
        want = np.asarray(jd.sample_logits(jnp.asarray(logits), key, 0.9, 8,
                                           0.8))
        got = td.sample_logits(torch.as_tensor(logits), noise, 0.9, 8, 0.8)
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jd.sample_logits_dynamic(
            jnp.asarray(logits), key, jnp.asarray(temp), jnp.asarray(topk),
            jnp.asarray(topp)))
        got = td.sample_logits_dynamic(
            torch.as_tensor(logits), noise, torch.as_tensor(temp),
            torch.as_tensor(topk.astype(np.int64)), torch.as_tensor(topp),
            sampled=True)
        np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_decode_parity(pair):
    """chunk>1 enqueues the steps without a host read; the emitted stream
    is token-for-token the per-token path's in every sampling mode
    (greedy: also the JAX package's), including when max_new_tokens is
    not a multiple of the chunk size."""
    model, params, port = pair
    prompt = list(range(10, 30))
    want = list(jd.generate_stream(model, params, prompt,
                                   max_new_tokens=33))
    for kw in (dict(), dict(temperature=0.8, top_k=40, seed=3),
               dict(temperature=1.0, top_p=0.9, seed=7)):
        ref = list(td.generate_stream(port, prompt, max_new_tokens=33, **kw))
        if not kw:
            assert ref == want
        for ch in (4, 16):
            got = list(td.generate_stream(port, prompt, max_new_tokens=33,
                                          chunk=ch, **kw))
            assert got == ref, (kw, ch)


def test_chunked_decode_eos_mid_chunk(pair):
    """EOS raised inside a chunk truncates the stream exactly where the
    per-token path stops."""
    model, params, port = pair
    prompt = [256, 9, 17, 33]
    ref = list(td.generate_stream(port, prompt, max_new_tokens=16))
    fake_eos = ref[5]
    a = list(td.generate_stream(port, prompt, max_new_tokens=16,
                                eos_id=fake_eos))
    b = list(td.generate_stream(port, prompt, max_new_tokens=16,
                                eos_id=fake_eos, chunk=8))
    assert a == b == list(jd.generate_stream(model, params, prompt,
                                             max_new_tokens=16,
                                             eos_id=fake_eos, chunk=8))
    assert len(a) < len(ref) and fake_eos not in a


def test_generate_batch_matches_jax(pair):
    """Batched generation over ragged prompts (right-padded prefill +
    per-row cache offsets) equals the JAX package's generate_batch and
    each prompt's single stream, per-row EOS stopping included."""
    model, params, port = pair
    prompts = [list(range(10, 25)), [256, 40, 41], list(range(60, 90))]
    batch = td.generate_batch(port, prompts, max_new_tokens=21, chunk=8)
    assert batch == jd.generate_batch(model, params, prompts,
                                      max_new_tokens=21, chunk=8)
    refs = [list(td.generate_stream(port, p, max_new_tokens=21))
            for p in prompts]
    assert batch == refs
    e = refs[0][4]
    batch = td.generate_batch(port, prompts, max_new_tokens=21, chunk=8,
                              eos_id=e)
    assert batch == [list(td.generate_stream(port, p, max_new_tokens=21,
                                             eos_id=e)) for p in prompts]
    assert len(batch[0]) == 4


def test_local_tpu_llm_in_rag_stream():
    """End-to-end RAG with the port's decoder as the LLM: the
    query_rag_stream 4-tuple contract streams deltas generated by the
    KV-cached LM (the JAX package's weights), with the gold section in
    the sources, and the answer equals the JAX package's."""
    from a_nice_rag_tpu.rag.providers import LocalTpuLLMClient as JaxClient
    from a_nice_rag_tpu_torch.config import InfoSource
    from a_nice_rag_tpu_torch.index import build_index
    from a_nice_rag_tpu_torch.rag.providers import (
        LocalTpuLLMClient,
        route_model,
    )
    from a_nice_rag_tpu_torch.rag.system import RAGSystem
    from a_nice_rag_tpu_torch.retrieval.embed import PrecomputedEmbedder
    from a_nice_rag_tpu_torch.retrieval.rerank import IdentityReranker
    from a_nice_rag_tpu_torch.testing import synth_corpus

    c = synth_corpus(n_docs=128, dim=32, n_queries=2, seed=9)
    idx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                      urls=c.urls, embeddings=c.embeddings,
                      token_lists=c.tokens, device="cpu")
    model, params = jd.init_decoder(
        jd.small_lm_config(hidden_size=64, num_layers=1), seed=3)
    local = LocalTpuLLMClient(_port(params, hidden_size=64, num_layers=1),
                              max_new_tokens=24, max_prompt_tokens=512)
    assert route_model("local-tpu", {"local": local}) is not None
    system = RAGSystem(
        indexes={InfoSource.NICE: idx},
        embedder=PrecomputedEmbedder(
            {"question 0": c.query_embeddings["voyage-3-large"][0]}),
        reranker=IdentityReranker(),
        llm_clients={"local": local},
        device="cpu",
    )
    chunks, s_data = [], None
    for chunk, _, _, s_data in system.query_rag_stream(
            "question 0", "local-tpu", use_hybrid_search=True):
        chunks.append(chunk)
    assert len(chunks) >= 1
    assert c.gold_ids[0] in (d["section_id"] for d in s_data)
    msgs = [{"role": "user", "content": "what dose?"}]
    want = "".join(JaxClient(model, params, max_new_tokens=24).stream_chat(
        "local-tpu", msgs))
    assert "".join(local.stream_chat("local-tpu", msgs)) == want
