"""The port's HTTP serving API over a live server, against the JAX
package's.

Mirrors tests/test_http_api.py on the CPU: health, search, rag, the
error paths, both SSE cases (a gated LLM client proves deltas reach the
client before generation ends, and a vanished client closes the
generator), the UI, feedback, stats and embeddings (over
PrecomputedEmbedder). The generation routes keep their paths and answer
400: the port has no generation server yet. Last, /v1/search and
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
