"""The port's HTTP serving API over a live server, against the JAX
package's.

Mirrors tests/test_http_api.py on the CPU: health, search, rag, the
error paths, both SSE cases (a gated LLM client proves deltas reach the
client before generation ends, and a vanished client closes the
generator), the UI, feedback, stats and embeddings (over
PrecomputedEmbedder). The generation routes answer 400 when no
generation server is attached; with one (the port's GenerationServer on
the JAX package's decoder weights, carried across with
``decoder_state_dict``), /v1/generate (JSON and SSE) and
/v1/chat/completions (JSON, SSE and through the RAG layer's own
OpenAICompatClient) return the JAX package's greedy text, 429 maps
ServerBusy, and the payload knobs reach the server. Last, /v1/search and
/v1/rag through the JAX package's server and the port's on one corpus:
equal result ids and sources, similarities within 1e-6.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from a_nice_rag_tpu.config import InfoSource as JaxSource
from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.rag import FakeLLMClient as JaxFake
from a_nice_rag_tpu.rag import RAGSystem as JaxRAG
from a_nice_rag_tpu.serving.http_api import serve as jax_serve
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.config import InfoSource
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.rag import FakeLLMClient, RAGSystem
from a_nice_rag_tpu_torch.retrieval.embed import PrecomputedEmbedder
from a_nice_rag_tpu_torch.serving.feedback import FeedbackLog
from a_nice_rag_tpu_torch.serving.http_api import (
    render_chat_messages,
    serve,
)

MODEL = "voyage-3-large"
SCORE_ATOL = 1e-6


def _args(c):
    return dict(ids=c.ids, sources=c.sources, contents=c.contents,
                urls=c.urls, embeddings=c.embeddings, token_lists=c.tokens)


def _rag(c, llm=None, embedder=None):
    return RAGSystem(indexes={InfoSource.NICE: build_index(device="cpu",
                                                           **_args(c))},
                     embedder=embedder,
                     llm_clients={"fake": llm or FakeLLMClient()},
                     device="cpu")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    c = synth_corpus(n_docs=120, dim=16, n_queries=4, seed=201)
    fb = FeedbackLog(str(tmp_path_factory.mktemp("fb")
                         / "query_feedback.json"))
    srv = serve(_rag(c), port=0, background=True, feedback_log=fb)
    try:
        yield c, srv, srv.server_address[1], fb
    finally:
        srv.shutdown()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.headers, resp.read()


def test_health(server):
    c, srv, port, fb = server
    out = json.loads(_get(port, "/v1/health")[1])
    assert out["status"] == "ok"
    assert out["sources"]["nice"]["n_docs"] == 120
    assert out["sources"]["nice"]["bm25"] is True


def test_search_with_precomputed_embedding(server):
    c, srv, port, fb = server
    out = _post(port, "/v1/search", {
        "query": "anything",
        "query_embedding": c.query_embeddings[MODEL][0].tolist(),
        "model_weights": {MODEL: 1.0},
        "common_sections_n": 5,
    })
    assert len(out["results"]) == 5
    assert out["results"][0]["id"] == c.gold_ids[0]
    assert "document" in out["results"][0]


def test_rag_endpoint(server):
    c, srv, port, fb = server
    out = _post(port, "/v1/rag", {
        "query": " ".join(c.query_tokens[1][:4]),
        "llm_model": "fake-llm",
        "model_weights": {MODEL: 0.0, "BM25": 1.0},
        "use_hybrid_search": True,
        "use_reranker": False,
    })
    assert out["answer"].startswith("[fake:fake-llm]")
    assert out["sources"]


def test_error_paths(server):
    c, srv, port, fb = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v1/search", {})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v1/nope", {"x": 1})
    assert e.value.code == 404


@pytest.mark.parametrize("path", ["/v1/generate", "/v1/generate/stream",
                                  "/v1/chat/completions"])
def test_generation_routes_answer_400(server, path):
    c, srv, port, fb = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, path, {"prompt": "x", "stream": True,
                           "messages": [{"role": "user", "content": "x"}]})
    assert e.value.code == 400
    assert json.loads(e.value.read())["error"] == \
        "no generation server attached"


def test_render_chat_messages():
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello"}]
    assert render_chat_messages(msgs) == \
        "system: be brief\n\nuser: hello\n\nassistant: "
    for bad in (None, [], [{"role": "u"}]):
        with pytest.raises(ValueError):
            render_chat_messages(bad)


class _GatedClient:
    """Streams a chunk, then blocks until the test releases the gate:
    SSE deltas must reach the client BEFORE generation completes."""

    def __init__(self):
        self.gate = threading.Event()
        self.finished = False
        self.aborted = False

    def stream_chat(self, model, messages, **params):
        try:
            yield "first-part "
            assert self.gate.wait(30), "test never released the gate"
            yield "second-part"
            self.finished = True
        except GeneratorExit:
            self.aborted = True
            raise


def _open_stream(port, payload, path="/v1/rag/stream"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req, timeout=30)


def _sse_events(fp):
    """(event, data) pairs from an SSE byte stream, incrementally."""
    event = None
    for raw in fp:
        line = raw.decode().rstrip("\n")
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            yield event, line[len("data: "):]
            event = None


@pytest.fixture()
def gated_server():
    c = synth_corpus(n_docs=60, dim=16, n_queries=2, seed=77)
    client = _GatedClient()
    srv = serve(_rag(c, llm=client), port=0, background=True)
    try:
        yield c, client, srv.server_address[1]
    finally:
        client.gate.set()
        srv.shutdown()


def _sse_payload(c, **kw):
    return {"query": " ".join(c.query_tokens[0][:4]), "llm_model": "fake-llm",
            "model_weights": {MODEL: 0.0, "BM25": 1.0},
            "use_hybrid_search": True, "use_reranker": False, **kw}


def test_rag_sse_streams_before_generation_completes(gated_server):
    c, client, port = gated_server
    resp = _open_stream(port, _sse_payload(c))
    try:
        assert resp.headers["Content-Type"] == "text/event-stream"
        events = _sse_events(resp)
        ev, data = next(events)
        assert ev == "sources" and json.loads(data)["sources"]
        ev, data = next(events)
        # The first delta arrives while the generator is still gated.
        assert json.loads(data)["delta"] == "first-part "
        assert client.finished is False
        client.gate.set()
        rest = list(events)
    finally:
        resp.close()
    assert rest[-1][1] == "[DONE]"
    deltas = [json.loads(d)["delta"] for e, d in rest[:-1]]
    assert "second-part" in "".join(deltas)
    assert client.finished is True


def test_rag_sse_client_abandonment_aborts_generation(gated_server):
    c, client, port = gated_server
    resp = _open_stream(port, _sse_payload(c, stream=True), path="/v1/rag")
    events = _sse_events(resp)
    next(events)  # sources
    next(events)  # first delta
    resp.close()  # abandon mid-generation
    client.gate.set()  # let the generator hit the broken pipe
    for _ in range(100):
        if client.aborted or client.finished:
            break
        time.sleep(0.1)
    # The server closes the upstream generator instead of running the
    # LLM call to completion for a vanished client.
    assert client.aborted is True or client.finished is False


def test_ui_page_served(server):
    c, srv, port, fb = server
    headers, body = _get(port, "/")
    assert headers["Content-Type"].startswith("text/html")
    html = body.decode()
    assert "NICE Guidelines RAG" in html
    assert "TPU" not in html
    boot = json.loads(
        html.split('<script id="boot" type="application/json">')[1]
        .split("</script>")[0])
    assert boot["llm_options"] == ["fake-llm"]
    assert boot["suggested_queries"]
    assert boot["defaults"]["similarity_k"] == 15
    # The page drives the production endpoints.
    assert "v1/rag/stream" in html and "v1/feedback" in html
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/ui",
                                timeout=30) as resp:
        assert resp.status == 200


def test_feedback_endpoint(server):
    c, srv, port, fb = server
    out = _post(port, "/v1/feedback", {
        "query": "what about hypertension?",
        "response": "answer text",
        "rating": "up",
        "llm_model": "fake-llm",
        "sources": [{"source": "NG136", "section_id": "NG136_x", "url": "u"}],
    })
    assert out["status"] == "recorded"
    entries = fb.entries()
    assert entries and entries[-1]["rating"] == "up"
    assert entries[-1]["query"] == "what about hypertension?"
    assert entries[-1]["sources"][0]["source"] == "NG136"
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v1/feedback", {"query": "q", "rating": "sideways"})
    assert e.value.code == 400


def test_stats_endpoint(server):
    c, srv, port, fb = server
    out = json.loads(_get(port, "/v1/stats")[1])
    assert out == {"status": "ok"}


def test_embeddings_endpoint():
    """/v1/embeddings over a PrecomputedEmbedder: list and string inputs,
    the table's rows back, and a 400 without an embedder."""
    c = synth_corpus(n_docs=64, dim=16, n_queries=2, seed=77)
    table = {"first query": c.query_embeddings[MODEL][0],
             "second query": c.query_embeddings[MODEL][1]}
    srv = serve(_rag(c, embedder=PrecomputedEmbedder(table)), port=0,
                background=True)
    try:
        port = srv.server_address[1]
        out = _post(port, "/v1/embeddings",
                    {"input": ["first query", "second query"]})
        assert out["object"] == "list" and len(out["data"]) == 2
        v0 = np.asarray(out["data"][0]["embedding"], np.float32)
        v1 = np.asarray(out["data"][1]["embedding"], np.float32)
        np.testing.assert_array_equal(v0, table["first query"])
        assert v0.shape == (16,) and not np.allclose(v0, v1)
        assert out["usage"]["prompt_tokens"] == 4
        one = _post(port, "/v1/embeddings", {"input": "first query"})
        np.testing.assert_array_equal(
            np.asarray(one["data"][0]["embedding"], np.float32), v0)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/v1/embeddings", {"input": ""})
        assert err.value.code == 400
    finally:
        srv.shutdown()
    srv2 = serve(_rag(c), port=0, background=True)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv2.server_address[1], "/v1/embeddings", {"input": "x"})
        assert err.value.code == 400
    finally:
        srv2.shutdown()


def test_embeddings_endpoint_on_device_embedder():
    """/v1/embeddings over the hashing encoder (models.OnDeviceEmbedder):
    each row equal to embed_queries on the same texts, unit norm; a text
    /v1/search ranks the embedder's vector."""
    from a_nice_rag_tpu_torch.models import EncoderConfig, OnDeviceEmbedder

    c = synth_corpus(n_docs=64, dim=16, n_queries=2, seed=78)
    emb = OnDeviceEmbedder(EncoderConfig(dim=64, n_layers=2, n_heads=2,
                                         out_dim=16), device="cpu")
    texts = ["blood pressure in adults", "asthma", "statins and liver"]
    srv = serve(_rag(c, embedder=emb), port=0, background=True)
    try:
        port = srv.server_address[1]
        out = _post(port, "/v1/embeddings", {"input": texts})
        got = np.asarray([d["embedding"] for d in out["data"]], np.float32)
        np.testing.assert_array_equal(got, emb.embed_queries(texts))
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   rtol=1e-5)
        found = _post(port, "/v1/search", {"query": texts[0],
                                            "similarity_k": 5,
                                            "common_sections_n": 5})
        assert len(found["results"]) == 5
    finally:
        srv.shutdown()


def test_search_and_rag_parity_with_jax():
    """One corpus behind both packages' servers: /v1/search (dense and
    hybrid) and /v1/rag give the same ids and sources."""
    c = synth_corpus(n_docs=200, dim=16, n_queries=4, seed=203)
    jrag = JaxRAG(indexes={JaxSource.NICE: jax_build_index(**_args(c))},
                  llm_clients={"fake": JaxFake()})
    servers = [jax_serve(jrag, port=0, background=True)]
    try:
        servers.append(serve(_rag(c), port=0, background=True))
        ports = [s.server_address[1] for s in servers]
        for i in range(4):
            for payload in (
                {"query": "x", "model_weights": {MODEL: 1.0},
                 "query_embedding": c.query_embeddings[MODEL][i].tolist()},
                {"query": " ".join(c.query_tokens[i]),
                 "query_embedding": c.query_embeddings[MODEL][i].tolist(),
                 "model_weights": {MODEL: 5.0, "BM25": 1.0},
                 "use_hybrid_search": True, "common_sections_n": 8},
            ):
                j, t = (_post(p, "/v1/search", payload)["results"]
                        for p in ports)
                assert [r["id"] for r in t] == [r["id"] for r in j]
                np.testing.assert_allclose(
                    [r["similarity"] for r in t],
                    [r["similarity"] for r in j], rtol=0, atol=SCORE_ATOL)
            rag = {"query": " ".join(c.query_tokens[i][:4]),
                   "llm_model": "fake-llm",
                   "model_weights": {MODEL: 0.0, "BM25": 1.0},
                   "use_hybrid_search": True, "use_reranker": False}
            j, t = (_post(p, "/v1/rag", rag) for p in ports)
            assert [s["section_id"] for s in t["sources"]] == \
                [s["section_id"] for s in j["sources"]]
            assert t["answer"] == j["answer"]
    finally:
        for s in servers:
            s.shutdown()


# -- the generation half ---------------------------------------------------


def _handler_server(api):
    from http.server import ThreadingHTTPServer

    from a_nice_rag_tpu_torch.serving.http_api import _make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module")
def lm():
    """The JAX package's demo decoder and the port's on its weights."""
    import jax

    from a_nice_rag_tpu.models.decoder import init_decoder, small_lm_config
    from a_nice_rag_tpu_torch.models import decoder as td
    from a_nice_rag_tpu_torch.models.convert import (
        decoder_state_dict,
        load_decoder_state,
    )

    model, params = init_decoder(small_lm_config())
    return model, params, load_decoder_state(
        td.small_lm_config(), decoder_state_dict(jax.device_get(params)),
        device="cpu")


def _sse(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=60) as resp:
        for raw in resp:
            line = raw.decode("utf-8").strip()
            if line.startswith("data:"):
                events.append(line[len("data:"):].strip())
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def test_stats_endpoint_generation_block(lm):
    """/v1/stats carries the generation server's counters when one is
    attached, and no generation block otherwise."""
    from a_nice_rag_tpu_torch.serving.genserver import GenerationServer
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    gsrv = GenerationServer(lm[2], slots=2, max_len=64, chunk=4)
    assert "generation" not in ServingAPI(None).stats()
    out = ServingAPI(None, gen_server=gsrv).stats()
    assert out["generation"]["slots"] == 2
    assert out["generation"]["tensor_parallel"] == 1


def test_generate_backpressure_maps_to_429():
    from a_nice_rag_tpu_torch.serving.genserver import ServerBusy
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    class _BusyServer:
        def stream_text(self, *a, **kw):
            raise ServerBusy("pending queue full (1); retry later")

    httpd = _handler_server(ServingAPI(None, gen_server=_BusyServer()))
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(httpd.server_address[1], "/v1/generate", {"prompt": "x"})
        assert e.value.code == 429
        assert "retry later" in json.loads(e.value.read())["error"]
    finally:
        httpd.shutdown()


def test_generate_payload_stop_plumbed():
    """'stop' (string or list) and 'stop_token_ids' payload keys reach
    GenerationServer.stream_text."""
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    seen = {}

    class _Recorder:
        def stream_text(self, prompt, max_new_tokens, **kw):
            seen.update(kw, prompt=prompt, max_new_tokens=max_new_tokens)
            yield "ok"

    httpd = _handler_server(ServingAPI(None, gen_server=_Recorder()))
    try:
        out = _post(httpd.server_address[1], "/v1/generate", {
            "prompt": "x", "max_tokens": 7, "stop": "\n\n",
            "stop_token_ids": [5, 9], "temperature": 0.5})
        assert out["text"] == "ok"
        assert seen["stop"] == ["\n\n"] and seen["stop_token_ids"] == [5, 9]
        assert seen["temperature"] == 0.5 and seen["max_new_tokens"] == 7
    finally:
        httpd.shutdown()


def test_chat_completions_param_plumbing():
    """OpenAI chat payload knobs (max_completion_tokens, temperature,
    top_p, stop, response_format) reach the generation server; the reply
    has the chat.completion shape and usage accounting."""
    from a_nice_rag_tpu_torch.models.decoder import ByteTokenizer
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    seen = {}

    class _Recorder:
        def stream_text(self, prompt, max_new_tokens, **kw):
            seen.update(kw, prompt=prompt, max_new_tokens=max_new_tokens)
            yield "hi"

        def complete(self, prompt_ids, max_new_tokens, **kw):
            seen.update(kw, prompt_ids=prompt_ids,
                        max_new_tokens=max_new_tokens)
            return {"tokens": [104, 105], "logprobs": [0.0, 0.0],
                    "finish_reason": "length"}

    httpd = _handler_server(ServingAPI(None, gen_server=_Recorder()))
    try:
        port = httpd.server_address[1]
        msgs = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "hello"}]
        out = _post(port, "/v1/chat/completions", {
            "model": "local-demo", "messages": msgs,
            "max_completion_tokens": 9, "temperature": 0.25,
            "response_format": {"type": "json_object"}})
        assert out["object"] == "chat.completion"
        assert out["model"] == "local-demo"
        assert out["choices"][0]["message"] == {"role": "assistant",
                                                "content": "hi"}
        assert out["choices"][0]["finish_reason"] == "length"
        assert out["usage"]["completion_tokens"] == 2
        assert out["usage"]["total_tokens"] == \
            out["usage"]["prompt_tokens"] + 2
        assert seen["max_new_tokens"] == 9 and seen["temperature"] == 0.25
        assert seen["constraint"] == "json_object"
        assert seen["prompt_ids"] == ByteTokenizer().encode(
            render_chat_messages(msgs))
        out = _post(port, "/v1/chat/completions", {
            "messages": msgs, "stop": "\n", "top_p": 0.9, "max_tokens": 5})
        assert out["choices"][0]["message"]["content"] == "hi"
        assert out["choices"][0]["finish_reason"] == "stop"
        assert seen["stop"] == ["\n"] and seen["top_p"] == 0.9
        for bad in ({}, {"messages": []}, {"messages": [{"role": "u"}]}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, "/v1/chat/completions", bad)
            assert err.value.code == 400
    finally:
        httpd.shutdown()


def test_generate_and_chat_serve_the_jax_greedy_text(lm):
    """/v1/generate (JSON, SSE deltas) and /v1/chat/completions (JSON and
    chat.completion.chunk SSE) over the port's GenerationServer return
    the JAX package's greedy text for the same weights."""
    from a_nice_rag_tpu.models.decoder import generate_text_stream
    from a_nice_rag_tpu_torch.serving.genserver import GenerationServer
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    model, params, port_lm = lm
    gsrv = GenerationServer(port_lm, slots=2, max_len=256, chunk=4)
    httpd = _handler_server(ServingAPI(None, gen_server=gsrv))
    try:
        port = httpd.server_address[1]
        want = "".join(generate_text_stream(model, params, "hello",
                                            max_new_tokens=12))
        assert _post(port, "/v1/generate", {
            "prompt": "hello", "max_tokens": 12})["text"] == want
        deltas = _sse(port, "/v1/generate", {
            "prompt": "hello", "max_tokens": 12, "stream": True})
        assert "".join(d["delta"] for d in deltas) == want
        msgs = [{"role": "user", "content": "name one NICE guideline"}]
        want = "".join(generate_text_stream(
            model, params, render_chat_messages(msgs), max_new_tokens=10))
        out = _post(port, "/v1/chat/completions", {"messages": msgs,
                                                    "max_tokens": 10})
        assert out["choices"][0]["message"]["content"] == want
        chunks = _sse(port, "/v1/chat/completions", {
            "messages": msgs, "max_tokens": 10, "stream": True})
        assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
        assert "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks) == want
        assert chunks[-1]["choices"][0]["finish_reason"] in ("stop",
                                                             "length")
        assert gsrv.stats()["tokens_emitted"] >= 20
    finally:
        httpd.shutdown()
        gsrv.stop()


def test_chat_completions_serve_own_provider_client(lm):
    """The RAG layer's OpenAICompatClient pointed at this server streams
    the JAX package's greedy text from the port's GenerationServer, raw
    and through query_rag_stream."""
    from a_nice_rag_tpu.models.decoder import generate_text_stream
    from a_nice_rag_tpu_torch.rag.providers import OpenAICompatClient
    from a_nice_rag_tpu_torch.serving.genserver import GenerationServer
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    model, params, port_lm = lm
    gsrv = GenerationServer(port_lm, slots=2, max_len=4096, chunk=4)
    httpd = _handler_server(ServingAPI(None, gen_server=gsrv))
    try:
        client = OpenAICompatClient(
            "local-key", base_url=f"http://127.0.0.1:"
            f"{httpd.server_address[1]}/v1/", timeout=120.0)
        msgs = [{"role": "user", "content": "name one NICE guideline"}]
        got = "".join(client.stream_chat("local", msgs, max_tokens=12,
                                         stream_options=None))
        assert got == "".join(generate_text_stream(
            model, params, render_chat_messages(msgs), max_new_tokens=12))
        c = synth_corpus(n_docs=64, dim=16, n_queries=2, seed=31)
        rag = RAGSystem(indexes={InfoSource.NICE: build_index(
            device="cpu", **_args(c))}, llm_clients={"openai": client},
            device="cpu")
        chunks, sources = [], None
        for chunk, _, _, sources in rag.query_rag_stream(
                " ".join(c.query_tokens[0][:4]), "gpt-4.1-mini",
                model_weights={MODEL: 0.0, "BM25": 1.0},
                use_hybrid_search=True, use_reranker=False,
                common_sections_n=3):
            chunks.append(chunk)
        assert "".join(chunks) and sources
    finally:
        httpd.shutdown()
        gsrv.stop()
