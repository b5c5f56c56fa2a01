"""The port's serve CLI stack (index -> scheduler pool -> HTTP), against
the JAX package's.

Mirrors tests/test_serve_cli.py's serving cases on the CPU: single
device, sharded over 4 "cpu" slots with a health swap (the retriever and
its pool replaced live), an int8 index, the IVF route on both paths and
the sharded IVF cache, the batched base64 RPC in f32 and bf16, and
one HTTP/1.1 connection carrying query after query.
``--embedder-ckpt`` serves a trained checkpoint and ``--lm-tp`` the LM
tensor-parallel (the rounded fold's flag: tests/test_torch_rounded_topk.py).
The local-LLM surface (``--llm local``, ``build_local_llm_api``):
/v1/search, /v1/generate, /v1/rag, the UI and /v1/stats on one port, the
draft checkpoint, JSON mode on the byte and on a checkpoint's tokenizer,
and every generation flag reaching the server; the demo LM's greedy
text equals the JAX package's for the same weights. Last, /v1/search
payloads (single JSON, b64 f32, b64 bf16) through the JAX package's
build_state and the port's: equal result ids, scores within 1e-6.
"""

import base64
import json
import os
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.serving.serve_cli import build_state as jax_build_state
from a_nice_rag_tpu.serving.serve_cli import serve_state as jax_serve_state
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.serving.serve_cli import (
    build_state,
    main,
    serve_state,
)

MODEL = "voyage-3-large"
W = {MODEL: 5.0, "BM25": 1.0}
CPU4 = ["cpu"] * 4
SCORE_ATOL = 1e-6


def _search(port, payload, expect_status=200):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/search",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == expect_status
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect_status, (e.code, expect_status)
        return json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def _args(c):
    return dict(ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings=c.embeddings, token_lists=c.tokens)


@pytest.fixture(scope="module")
def corpus_index():
    c = synth_corpus(n_docs=512, dim=32, n_queries=8, seed=21)
    return c, build_index(device="cpu", **_args(c))


class _Served:
    """serve_state in the background, shut down on exit."""

    def __init__(self, state, serve=serve_state):
        self.srv = serve(state, W, port=0, background=True)
        self.port = self.srv.server_address[1]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()


def _one(c, idx, i=0):
    return {"query_embedding": c.query_embeddings[MODEL][i].tolist(),
            "terms": idx.pad_term_ids(c.query_tokens, 16)[i].tolist()}


def test_serve_cli_single_device(corpus_index):
    c, idx = corpus_index
    state = build_state(idx, (MODEL,), use_bm25=True)
    with _Served(state) as s:
        assert _get(s.port, "/v1/health")["status"] == "ok"
        out = _search(s.port, _one(c, idx))
        assert out["results"][0]["id"] == c.gold_ids[0]
        stats = _get(s.port, "/v1/stats")
        assert sum(v["queries_served"]
                   for v in stats["schedulers"].values()) >= 1


def test_serve_cli_sharded_with_health_swap(corpus_index):
    c, idx = corpus_index
    state = build_state(idx, (MODEL,), use_bm25=True, shards=4,
                        two_tier_common=8, devices=CPU4)
    # An injected probe lets the monitor see slot 3 die on demand.
    dead = set()
    state.monitor.probe_fn = lambda slot, t: slot not in dead
    with _Served(state) as s:
        q = _one(c, idx)
        out = _search(s.port, q)
        assert out["results"][0]["id"] == c.gold_ids[0]
        old_pool = state.pool
        dead.add(state.retriever.sidx.mesh.slots[3])
        assert state.monitor.check_and_recover() is True
        assert state.retriever.sidx.n_shards == 3
        assert state.pool is not old_pool
        out2 = _search(s.port, q)
        assert [r["id"] for r in out2["results"]] == \
            [r["id"] for r in out["results"]]
        assert _get(s.port, "/v1/stats")["health_events"][-1]["recovered"]


def test_serve_cli_quantized_index(corpus_index):
    """An int8 index (no float matrix kept) serves on both paths; the
    tuner leaves it alone."""
    c, _ = corpus_index
    idx_q = build_index(quantize_dense=True, device="cpu", **_args(c))
    for shards in (1, 4):
        state = build_state(idx_q, (MODEL,), use_bm25=True, shards=shards,
                            autotune=shards == 1, devices=CPU4)
        if shards == 1:
            assert state.retriever.kernel_config is None
        with _Served(state) as s:
            out = _search(s.port, _one(c, idx_q))
            assert out["results"][0]["id"] == c.gold_ids[0]


def test_serve_cli_autotune_off_cuda_keeps_the_plan(corpus_index):
    """The tuner runs for a float matrix on CUDA only: on the CPU the
    retriever keeps the plan's own (no config)."""
    c, idx = corpus_index
    state = build_state(idx, (MODEL,), use_bm25=True, autotune=True)
    assert state.retriever.kernel_config is None


def test_serve_cli_ivf_nprobe(corpus_index):
    """nprobe > 0 serves the IVF route on both paths (the layout built at
    startup) and survives a slot loss on the sharded path: the reshard
    clusters again and the retriever keeps its nprobe."""
    c, _ = corpus_index
    idx = build_index(device="cpu", **_args(c))  # attach_ivf mutates it
    q = _one(c, idx)
    state = build_state(idx, (MODEL,), use_bm25=True, nprobe=8)
    assert idx.ivf and MODEL in idx.ivf
    with _Served(state) as s:
        assert _search(s.port, q)["results"][0]["id"] == c.gold_ids[0]
    state = build_state(idx, (MODEL,), use_bm25=True, shards=4, nprobe=8,
                        devices=CPU4)
    assert state.retriever.use_ivf
    dead = set()
    state.monitor.probe_fn = lambda slot, t: slot not in dead
    with _Served(state) as s:
        assert _search(s.port, q)["results"][0]["id"] == c.gold_ids[0]
        dead.add(state.retriever.sidx.mesh.slots[3])
        assert state.monitor.check_and_recover() is True
        assert state.retriever.sidx.n_shards == 3
        assert state.retriever.use_ivf
        assert _search(s.port, q)["results"][0]["id"] == c.gold_ids[0]


def test_serve_cli_ivf_cache_roundtrip(corpus_index, tmp_path):
    """--ivf-cache keeps the clustering at first startup and reuses it."""
    c, idx = corpus_index
    cache = os.path.join(tmp_path, "ivf.npz")
    kw = dict(use_bm25=True, shards=4, nprobe=8, ivf_cache=cache,
              devices=CPU4)
    s1 = build_state(idx, (MODEL,), **kw)
    assert os.path.exists(cache)
    s2 = build_state(idx, (MODEL,), **kw)
    np.testing.assert_array_equal(s1.retriever.sidx.ivf_perm.numpy(),
                                  s2.retriever.sidx.ivf_perm.numpy())
    assert s2.retriever.use_ivf


def test_serve_cli_text_query_with_embedder(corpus_index):
    """Raw-text /v1/search through build_state's embedder (any object with
    embed_queries) and the index's BM25 vocabulary; without one, 400."""
    from a_nice_rag_tpu_torch.retrieval.embed import PrecomputedEmbedder

    c, idx = corpus_index
    text = " ".join(c.query_tokens[0])
    state = build_state(idx, (MODEL,), use_bm25=True,
                        embedder=PrecomputedEmbedder(
                            {text: c.query_embeddings[MODEL][0]}))
    with _Served(state) as s:
        out = _search(s.port, {"query": text})
        assert out["results"][0]["id"] == c.gold_ids[0]
        assert out["results"] == _search(s.port, _one(c, idx))["results"]
    with _Served(build_state(idx, (MODEL,), use_bm25=True)) as s:
        err = _search(s.port, {"query": text}, expect_status=400)
        assert "embedder" in err["error"]


def _b64(q, terms, dtype=None):
    body = {"query_embeddings_b64": base64.b64encode(q.tobytes()).decode(),
            "shape": list(q.shape),
            "terms_b64": base64.b64encode(terms.tobytes()).decode(),
            "terms_shape": list(terms.shape)}
    if dtype:
        body["dtype"] = dtype
    return body


def _rows(out):
    return np.frombuffer(base64.b64decode(out["rows_b64"]),
                         np.int32).reshape(out["out_shape"])


def _scores(out):
    return np.frombuffer(base64.b64decode(out["scores_b64"]),
                         np.float32).reshape(out["out_shape"])


def _block(c, idx, b=8):
    return (np.asarray(c.query_embeddings[MODEL][:b], np.float32),
            np.asarray(idx.pad_term_ids(c.query_tokens[:b], 16), np.int32))


def test_serve_cli_batched_b64_search(corpus_index):
    """The batched RPC: base64 f32 rows + i32 terms, the rows
    micro-batched through the scheduler, equal to a direct call."""
    c, idx = corpus_index
    state = build_state(idx, (MODEL,), use_bm25=True)
    q, terms = _block(c, idx)
    with _Served(state) as s:
        rows = _rows(_search(s.port, _b64(q, terms)))
    assert rows.shape[0] == 8
    hits = sum(c.gold_ids[b] in [idx.meta.ids[r] for r in rows[b] if r >= 0]
               for b in range(8))
    assert hits >= 6, hits
    direct = state.retriever.retrieve_device({MODEL: q}, terms, W, None,
                                             40.0)[0]
    np.testing.assert_array_equal(rows, direct.numpy())


def test_serve_cli_keeps_search_connections(corpus_index):
    """/v1/search over HTTP/1.1: one client connection carries query after
    query (JSON and b64), each reply equal to a fresh connection's. A
    reply whose request was not taken whole (an unknown endpoint, bad
    JSON) says "Connection: close", and the client's next request opens a
    new connection that is served."""
    import http.client

    c, idx = corpus_index
    state = build_state(idx, (MODEL,), use_bm25=True)
    q, terms = _block(c, idx)
    with _Served(state) as s:
        conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=60)

        def post(path, body):
            conn.request("POST", path, body,
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            return r, r.read()

        try:
            local = set()
            for i in range(4):
                r, data = post("/v1/search", json.dumps(_one(c, idx, i)))
                assert r.status == 200 and r.version == 11
                assert not r.will_close
                local.add(conn.sock.getsockname())
                assert json.loads(data) == _search(s.port, _one(c, idx, i))
            r, data = post("/v1/search", json.dumps(_b64(q, terms)))
            assert r.status == 200 and not r.will_close
            np.testing.assert_array_equal(
                _rows(json.loads(data)), _rows(_search(s.port,
                                                       _b64(q, terms))))
            conn.request("GET", "/v1/health")
            r = conn.getresponse()
            assert json.loads(r.read())["status"] == "ok"
            assert not r.will_close
            local.add(conn.sock.getsockname())
            assert len(local) == 1
            for path, body, status in (("/v1/nowhere", "{}", 404),
                                       ("/v1/search", "{not json", 400)):
                r, _ = post(path, body)
                assert r.status == status and r.will_close
                assert r.getheader("Connection") == "close"
                r, data = post("/v1/search", json.dumps(_one(c, idx, 0)))
                assert r.status == 200
                assert json.loads(data) == _search(s.port, _one(c, idx, 0))
        finally:
            conn.close()


def test_serve_cli_batched_b64_search_bf16(corpus_index):
    """dtype "bf16": the rows ride the scheduler as bf16 bits and rank as
    the bf16-rounded query; a bad dtype gets a 400."""
    c, idx = corpus_index
    state = build_state(idx, (MODEL,), use_bm25=True)
    qf, terms = _block(c, idx)
    qb = qf.astype(ml_dtypes.bfloat16)
    with _Served(state) as s:
        body = _b64(qb, terms, "bf16")
        rows = _rows(_search(s.port, body))
        err = _search(s.port, dict(body, dtype="f16"), expect_status=400)
        assert "dtype" in err.get("error", "")
    hits = sum(c.gold_ids[b] in [idx.meta.ids[r] for r in rows[b] if r >= 0]
               for b in range(8))
    assert hits >= 6, hits
    direct = state.retriever.retrieve_device(
        {MODEL: qb.astype(np.float32)}, terms, W, None, 40.0)[0]
    np.testing.assert_array_equal(rows, direct.numpy())


@pytest.mark.parametrize("argv,message", [
    (["--lm-tp", "2"], "--lm-tp needs --llm local"),
    (["--embedder-ckpt", "ckpt"], "--embedder-ckpt needs --embedder"),
])
def test_tp_and_checkpoint_flags_need_their_surface(argv, message):
    with pytest.raises(SystemExit, match=message):
        main(["--demo", "--device", "cpu"] + argv)


@pytest.mark.parametrize("tp", [1, 2])
def test_main_lm_tp_serves_tensor_parallel(monkeypatch, tp):
    """--llm local --lm-tp N serves the local LM over N slots (of the CPU
    here; the first N cards on the card) with the one-slot greedy
    stream."""
    from a_nice_rag_tpu_torch.models.decoder import generate_stream
    from a_nice_rag_tpu_torch.serving import serve_cli

    served = []
    monkeypatch.setattr(serve_cli, "serve_state",
                        lambda state, w, **kw: served.append(kw["api"]))
    main(["--demo", "--device", "cpu", "--llm", "local", "--gen-slots",
          "2", "--lm-tp", str(tp)])
    (api,) = served
    gen = api.gen_server
    try:
        assert gen.stats()["tensor_parallel"] == tp
        assert len(gen._kc) == gen.model.cfg.num_layers * tp
        prompt = list(b"NICE guidance on asthma")
        want = list(generate_stream(api.rag_system.llm_clients[
            "local"].model, prompt, max_new_tokens=12))
        assert gen.complete(prompt, 12)["tokens"] == want
    finally:
        gen.stop()


def test_lm_tp_beyond_the_cards_exits(monkeypatch):
    """--lm-tp N on the card takes the first N cards and exits with the
    JAX CLI's message when there are fewer."""
    from a_nice_rag_tpu_torch.serving.serve_cli import build_local_llm_api

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    class OnCard:
        device = torch.device("cuda", 0)

    with pytest.raises(SystemExit, match=r"--lm-tp 4 > available devices "
                                         r"\(2\)"):
        build_local_llm_api(OnCard(), None, None, (MODEL,), lm_tp=4)


def _encoder_ckpt(tmp_path, out_dim, seed=5):
    from a_nice_rag_tpu_torch.models import EncoderConfig, init_encoder
    from a_nice_rag_tpu_torch.models.checkpoint import save_checkpoint

    enc = init_encoder(EncoderConfig(out_dim=out_dim), seed=seed,
                       device="cpu")
    path = str(tmp_path / "enc")
    save_checkpoint(path, 3, enc.state_dict(), {"state": {}})
    return path, enc


def test_main_embedder_ckpt_serves_the_checkpoint(monkeypatch, tmp_path):
    """--embedder hashing --embedder-ckpt DIR restores the latest step's
    params (the tuple's middle) into the served encoder: a text
    /v1/search returns the ids of the checkpoint's own vector through a
    direct retrieve_device."""
    from a_nice_rag_tpu_torch.models import HashingTokenizer
    from a_nice_rag_tpu_torch.serving import serve_cli

    path, enc = _encoder_ckpt(tmp_path, 128)
    served = []
    monkeypatch.setattr(serve_cli, "serve_state",
                        lambda state, w, **kw: served.append((state, w)))
    main(["--demo", "--device", "cpu", "--embedder", "hashing",
          "--embedder-ckpt", path])
    (state, w), = served
    for k, v in enc.state_dict().items():
        assert torch.equal(state.embedder.model.state_dict()[k], v), k
    text = "hypertension in adults"
    ids = HashingTokenizer(vocab_size=32768).encode_batch([text])
    with torch.no_grad():
        want_vec = enc(torch.as_tensor(ids)).numpy()[0]
    q_vec, terms = state.encode_text_query(text)
    np.testing.assert_allclose(q_vec, want_vec, rtol=1e-6, atol=1e-6)
    model = state.retriever.model_names[0]
    with _Served(state, lambda st, _, **kw: serve_state(st, w, **kw)) as s:
        got = [r["id"] for r in _search(s.port, {"query": text})["results"]]
    rows = state.retriever.retrieve_device(
        {model: want_vec[None]}, terms[None], w, None, 40.0)[0]
    assert got == [state.index.meta.ids[r] for r in rows[0].tolist()
                   if r >= 0] and got


def test_main_embedder_ckpt_of_another_width_raises(tmp_path):
    path, _ = _encoder_ckpt(tmp_path, 64)
    with pytest.raises(ValueError, match="shape"):
        main(["--demo", "--device", "cpu", "--embedder", "hashing",
              "--embedder-ckpt", path])


def _llm_state(corpus_index):
    from a_nice_rag_tpu_torch.models import EncoderConfig, OnDeviceEmbedder

    c, idx = corpus_index
    embedder = OnDeviceEmbedder(EncoderConfig(
        n_layers=1, dim=32, out_dim=32, vocab_size=1024, n_heads=2),
        device="cpu")
    return c, idx, embedder, build_state(idx, (MODEL,), use_bm25=True,
                                         embedder=embedder)


def _jax_demo_lm(seed=0, **cfg):
    """The JAX package's decoder, its params and the port's DecoderLM on
    them."""
    import jax

    from a_nice_rag_tpu.models.decoder import init_decoder, small_lm_config
    from a_nice_rag_tpu_torch.models import convert
    from a_nice_rag_tpu_torch.models import decoder as td

    model, params = init_decoder(small_lm_config(**cfg), seed=seed)
    port = convert.load_decoder_state(
        td.small_lm_config(**cfg),
        convert.decoder_state_dict(jax.device_get(params)), device="cpu")
    return model, params, port


def test_serve_cli_local_llm_surface(corpus_index, monkeypatch):
    """--llm local: one port serves scheduler-batched /v1/search plus the
    RAG surface (/v1/rag through the on-device decoder and its
    GenerationServer), raw /v1/generate, the UI and /v1/stats with the
    generation counters; the demo LM's greedy text (the JAX package's
    weights) equals the JAX package's."""
    from a_nice_rag_tpu.models.decoder import generate_text_stream
    from a_nice_rag_tpu_torch.models import decoder as td
    from a_nice_rag_tpu_torch.serving.serve_cli import build_local_llm_api

    model, params, port_lm = _jax_demo_lm()
    monkeypatch.setattr(td, "init_decoder", lambda cfg, device: port_lm)
    c, idx, embedder, state = _llm_state(corpus_index)
    api = build_local_llm_api(idx, state, embedder, (MODEL,), gen_slots=2,
                              gen_chunk=4, gen_max_len=640)
    with _Served(state, lambda st, _, **kw: serve_state(st, W, api=api,
                                                        **kw)) as s:
        out = _search(s.port, _one(c, idx))
        assert out["results"][0]["id"] == c.gold_ids[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{s.port}/v1/generate",
            data=json.dumps({"prompt": "hello", "max_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            gen = json.loads(resp.read())
        assert gen["text"] == "".join(generate_text_stream(
            model, params, "hello", max_new_tokens=8))
        req = urllib.request.Request(
            f"http://127.0.0.1:{s.port}/v1/rag",
            data=json.dumps({"query": "question 0", "llm_model": "local-tpu",
                             "use_hybrid_search": True,
                             "use_reranker": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            rag = json.loads(resp.read())
        assert rag["answer"] and isinstance(rag["sources"], list)
        # A cut RAG prompt still fits the cache with its whole answer.
        assert not rag["answer"].startswith("Error"), rag["answer"]
        with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/ui",
                                    timeout=30) as resp:
            assert b"<html" in resp.read()[:200].lower()
        stats = _get(s.port, "/v1/stats")
        assert "schedulers" in stats
        g = stats["generation"]
        assert g["slots"] == 2 and g["tokens_emitted"] >= 8
        assert g["active"] == 0 and g["cancelled"] == 0
    assert api.gen_server._thread is None  # shutdown stopped it


def test_serve_cli_draft_ckpt_wiring(corpus_index, monkeypatch):
    """--draft-ckpt plumbs a draft model into the GenerationServer
    (speculative mode; greedy text stays the target's), enforces vocab
    match with the target and refuses --json-mode beside it."""
    from a_nice_rag_tpu_torch.models import convert
    from a_nice_rag_tpu_torch.serving.serve_cli import build_local_llm_api

    c, idx, embedder, state = _llm_state(corpus_index)
    draft_cfg = dict(num_layers=1, hidden_size=64, num_heads=2,
                     num_kv_heads=1, head_dim=32, intermediate_size=128)
    _, _, draft = _jax_demo_lm(3, **draft_cfg)

    def fake_loader(path, device):
        assert path == "fake-draft-dir"
        return draft.cfg, draft

    monkeypatch.setattr(convert, "load_decoder_checkpoint_dir", fake_loader)
    api = build_local_llm_api(idx, state, embedder, (MODEL,), gen_slots=2,
                              gen_chunk=4, gen_max_len=640,
                              draft_ckpt="fake-draft-dir", gamma=3)
    gen = api.gen_server
    try:
        assert gen.draft is draft and gen.gamma == 3
        assert isinstance("".join(gen.stream_text("hello",
                                                  max_new_tokens=6)), str)
    finally:
        gen.stop()
    with pytest.raises(SystemExit, match="json-mode"):
        build_local_llm_api(idx, state, embedder, (MODEL,),
                            draft_ckpt="fake-draft-dir", json_mode=True)
    _, _, bad = _jax_demo_lm(4, vocab_size=512, **draft_cfg)
    monkeypatch.setattr(convert, "load_decoder_checkpoint_dir",
                        lambda path, device: (bad.cfg, bad))
    with pytest.raises(SystemExit, match="vocab"):
        build_local_llm_api(idx, state, embedder, (MODEL,),
                            draft_ckpt="fake-draft-dir")


def test_serve_cli_json_mode(corpus_index):
    """--json-mode registers JSON guided decoding: /v1/generate with
    response_format json_object returns text that starts a JSON object,
    and /v1/chat/completions with it a live prefix of one (parsing on a
    natural stop)."""
    from a_nice_rag_tpu_torch.models.constrain import json_dfa
    from a_nice_rag_tpu_torch.serving.serve_cli import build_local_llm_api

    c, idx, embedder, state = _llm_state(corpus_index)
    api = build_local_llm_api(idx, state, embedder, (MODEL,), gen_slots=2,
                              gen_chunk=4, gen_max_len=640, json_mode=True,
                              json_depth=3)
    with _Served(state, lambda st, _, **kw: serve_state(st, W, api=api,
                                                        **kw)) as s:
        req = urllib.request.Request(
            f"http://127.0.0.1:{s.port}/v1/generate",
            data=json.dumps({"prompt": "emit", "max_tokens": 16,
                             "temperature": 1.0, "response_format":
                             {"type": "json_object"}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            gen = json.loads(resp.read())
        assert gen["text"].lstrip(" \t\n\r")[:1] == "{"
        chat = api.chat({"messages": [{"role": "user", "content": "x"}],
                         "max_tokens": 24,
                         "response_format": {"type": "json_object"}})
        text = chat["choices"][0]["message"]["content"]
        dfa, state_ = json_dfa(max_depth=3, top_level="object"), 0
        for b in text.encode():
            state_ = int(dfa.next[state_, b])
            assert state_ >= 0, text  # a live prefix of a JSON object
        if chat["choices"][0]["finish_reason"] == "stop":
            json.loads(text)
        assert set(api.gen_server.stats()["constraints"]) == {
            "json", "json_object", "json_array"}


def _byte_level_ckpt(tmp_path, eos, pieces):
    from a_nice_rag_tpu_torch.models.hf_tokenizer import bytes_to_unicode

    b2u = bytes_to_unicode()
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps({"eos_token_id": eos}))
    (ckpt / "tokenizer.json").write_text(json.dumps({
        "pre_tokenizer": {"type": "ByteLevel"},
        "decoder": {"type": "ByteLevel"}, "added_tokens": [],
        "model": {"type": "BPE", "vocab": {
            "".join(b2u[b] for b in bs): i for i, bs in pieces.items()}}}))
    return str(ckpt)


def test_serve_cli_json_mode_real_ckpt_tokenizer(corpus_index, monkeypatch,
                                                 tmp_path):
    """--json-mode with --llm-ckpt: the grammar is lowered onto the
    checkpoint's own tokenizer (multi-byte BPE pieces) and the server
    decodes to the checkpoint's eos_token_id; the tables equal the JAX
    package's lowering."""
    from a_nice_rag_tpu.models.constrain import compile_constraint, json_dfa
    from a_nice_rag_tpu_torch.models import convert
    from a_nice_rag_tpu_torch.serving.serve_cli import build_local_llm_api

    _, _, lm = _jax_demo_lm(5)
    monkeypatch.setattr(convert, "load_decoder_checkpoint_dir",
                        lambda path, device: (lm.cfg, lm))
    pieces = {10: b'{"', 11: b'a"', 12: b": ", 13: b"1", 15: b"}",
              19: b'":'}
    ckpt = _byte_level_ckpt(tmp_path, 77, pieces)
    c, idx, embedder, state = _llm_state(corpus_index)
    api = build_local_llm_api(idx, state, embedder, (MODEL,), llm_ckpt=ckpt,
                              gen_slots=2, gen_chunk=4, gen_max_len=640,
                              json_mode=True, json_depth=3)
    gen = api.gen_server
    con = gen._cons[gen._cname_to_id["json_object"]]
    assert gen.eos_id == 77
    assert con.table[0, 10] >= 0 and con.table[0, ord("{")] == -1
    assert con.table[0, 15] == -1
    want = compile_constraint(json_dfa(max_depth=3, top_level="object"),
                              lm.cfg.vocab_size, 77, token_bytes=pieces)
    np.testing.assert_array_equal(con.table, want.table)


def test_serve_cli_real_ckpt_serves_with_hf_tokenizer(corpus_index,
                                                      monkeypatch, tmp_path):
    """A checkpoint with a runtime-valid tokenizer.json is served with its
    own tokenizer everywhere: the generation endpoints and the RAG-local
    client encode prompts with the checkpoint vocabulary."""
    pytest.importorskip("tokenizers")
    from tokenizers import (
        Tokenizer,
        decoders,
        models,
        pre_tokenizers,
        trainers,
    )

    from a_nice_rag_tpu_torch.models import convert
    from a_nice_rag_tpu_torch.models.hf_tokenizer import HFTokenizer
    from a_nice_rag_tpu_torch.serving.serve_cli import build_local_llm_api

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(
        ["what dose of metformin does NICE recommend"] * 40,
        trainers.BpeTrainer(
            vocab_size=300, special_tokens=["<|endoftext|>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            show_progress=False))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    tok.save(str(ckpt / "tokenizer.json"))
    (ckpt / "config.json").write_text(json.dumps({"eos_token_id": 0}))
    vocab = tok.get_vocab_size(with_added_tokens=True)
    _, _, lm = _jax_demo_lm(5, vocab_size=vocab)
    monkeypatch.setattr(convert, "load_decoder_checkpoint_dir",
                        lambda path, device: (lm.cfg, lm))
    c, idx, embedder, state = _llm_state(corpus_index)
    api = build_local_llm_api(idx, state, embedder, (MODEL,),
                              llm_ckpt=str(ckpt), gen_slots=2, gen_chunk=4,
                              gen_max_len=256)
    try:
        assert isinstance(api.tokenizer, HFTokenizer)
        assert api.rag_system.llm_clients["local"].tokenizer is api.tokenizer
        out = api.generate({"prompt": "what dose of metformin",
                            "max_tokens": 4})
        assert isinstance(out["text"], str)
        ids = api.tokenizer.encode("what dose of metformin")
        assert all(i < vocab for i in ids)
        assert len(ids) < len("what dose of metformin".encode())
    finally:
        api.gen_server.stop()


@pytest.mark.parametrize("argv,attr,want", [
    ([], "slots", 4),
    (["--gen-slots", "3"], "slots", 3),
    (["--gen-chunk", "2"], "chunk", 2),
    (["--gen-max-len", "512"], "smax", 512),
    (["--prefill-chunk", "32"], "prefill_chunk", 32),
    (["--max-pending", "5"], "max_pending", 5),
    (["--retain-prefixes", "2"], "retain_prefixes", 2),
    (["--logprob-topk", "3"], "lp_k", 3),
    (["--json-mode", "--json-depth", "2"], "constraints", True),
])
def test_main_llm_local_flags_reach_the_server(monkeypatch, argv, attr,
                                               want):
    """The generation flags no longer exit: main --llm local builds the
    local-LLM surface (the hashing embedder added for RAG) and each flag
    reaches the GenerationServer it serves."""
    from a_nice_rag_tpu_torch.serving import serve_cli

    served = []
    monkeypatch.setattr(serve_cli, "serve_state",
                        lambda state, w, **kw: served.append(kw["api"]))
    main(["--demo", "--device", "cpu", "--llm", "local"] + argv)
    (api,) = served
    assert getattr(api.gen_server, attr) == want
    assert api.gen_server.dev.type == "cpu"
    assert "local" in api.rag_system.llm_clients
    assert api.rag_system.embedder is not None


def test_main_llm_ckpt_and_chat_template(monkeypatch, tmp_path):
    """--llm-ckpt loads the checkpoint directory onto the index's device
    (its eos_token_id becomes the server's), --chat-template forces the
    prompt format and --draft-ckpt/--gamma reach the server."""
    from a_nice_rag_tpu_torch.models import convert
    from a_nice_rag_tpu_torch.serving import serve_cli

    _, _, lm = _jax_demo_lm()
    loaded = []

    def loader(path, device):
        loaded.append((path, str(device)))
        return lm.cfg, lm

    monkeypatch.setattr(convert, "load_decoder_checkpoint_dir", loader)
    ckpt = _byte_level_ckpt(tmp_path, 5, {10: b"ab"})
    served = []
    monkeypatch.setattr(serve_cli, "serve_state",
                        lambda state, w, **kw: served.append(kw["api"]))
    main(["--demo", "--device", "cpu", "--llm", "local", "--llm-ckpt", ckpt,
          "--draft-ckpt", ckpt, "--gamma", "2", "--chat-template", "plain"])
    (api,) = served
    assert loaded == [(ckpt, "cpu")] * 2
    assert api.gen_server.eos_id == 5 and api.gen_server.gamma == 2
    assert api.gen_server.draft is lm


def test_main_needs_an_index_and_known_flags():
    with pytest.raises(SystemExit, match="--index or --demo"):
        main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown --embedder 'voyage'"):
        main(["--demo", "--device", "cpu", "--embedder", "voyage"])
    with pytest.raises(SystemExit) as e:
        main(["--demo", "--device", "cpu", "--no-such-flag"])
    assert e.value.code == 2


def test_main_sets_the_retrievers_depths(monkeypatch):
    """--similarity-k, --common-sections-n and --bm25-budget reach the
    served retriever; without them it keeps build_state's defaults."""
    from a_nice_rag_tpu_torch.serving import serve_cli

    served = []
    monkeypatch.setattr(serve_cli, "serve_state",
                        lambda state, *a, **kw: served.append(state))
    main(["--demo", "--device", "cpu", "--similarity-k", "32",
          "--common-sections-n", "7", "--bm25-budget", "1024"])
    main(["--demo", "--device", "cpu"])
    got = [(s.retriever.similarity_k, s.retriever.common_sections_n,
            s.retriever.budget) for s in served]
    assert got == [(32, 7, 1024), (25, 15, 16384)]


def test_main_embedder_hashing_serves_text(monkeypatch):
    """--embedder hashing: main builds the on-device embedder (the hashing
    encoder at the index's width, on the index's device) and a text
    /v1/search returns the ids of a direct retrieve_device on the vector
    and terms that encode_text_query gives for the same text."""
    from a_nice_rag_tpu_torch.models import OnDeviceEmbedder
    from a_nice_rag_tpu_torch.serving import serve_cli

    served = []
    monkeypatch.setattr(serve_cli, "serve_state",
                        lambda state, w, **kw: served.append((state, w)))
    main(["--demo", "--device", "cpu", "--embedder", "hashing"])
    (state, w), = served
    emb = state.embedder
    assert isinstance(emb, OnDeviceEmbedder)
    assert emb.cfg.out_dim == 128 and emb.device.type == "cpu"
    model = state.retriever.model_names[0]
    texts = ["hypertension in adults", "asthma action plan",
             state.index.meta.contents[3][:200]]
    with _Served(state, lambda st, _, **kw: serve_state(st, w, **kw)) as s:
        for text in texts:
            got = [r["id"] for r in _search(s.port, {"query": text})[
                "results"]]
            q_vec, terms = state.encode_text_query(text)
            assert q_vec.shape == (128,)
            np.testing.assert_allclose(np.linalg.norm(q_vec), 1.0,
                                       rtol=1e-5)
            rows = state.retriever.retrieve_device(
                {model: q_vec[None]}, terms[None], w, None, 40.0)[0]
            want = [state.index.meta.ids[r] for r in rows[0].tolist()
                    if r >= 0]
            assert got == want and got


def test_search_parity_with_jax(corpus_index):
    """Single JSON, b64 f32 and b64 bf16 /v1/search payloads through the
    JAX package's serve stack and the port's."""
    c, idx = corpus_index
    jstate = jax_build_state(jax_build_index(**_args(c)), (MODEL,),
                             use_bm25=True)
    state = build_state(idx, (MODEL,), use_bm25=True)
    q, terms = _block(c, idx)
    with _Served(jstate, jax_serve_state) as j, _Served(state) as t:
        for i in range(8):
            jr, tr = (_search(s.port, _one(c, idx, i))["results"]
                      for s in (j, t))
            assert [r["id"] for r in tr] == [r["id"] for r in jr]
            np.testing.assert_allclose([r["score"] for r in tr],
                                       [r["score"] for r in jr], rtol=0,
                                       atol=SCORE_ATOL)
        for body in (_b64(q, terms),
                     _b64(q.astype(ml_dtypes.bfloat16), terms, "bf16")):
            jo, to = (_search(s.port, body) for s in (j, t))
            np.testing.assert_array_equal(_rows(to), _rows(jo))
            np.testing.assert_allclose(_scores(to), _scores(jo), rtol=0,
                                       atol=SCORE_ATOL)
