"""RAG over the port's sharded corpus: ``RAGSystem`` +
``ShardedSearchEngine`` against the single-device ``SearchEngine`` and
the JAX package's ``ShardedSearchEngine``.

Mirrors tests/test_sharded_rag.py, its HTTP case through the port's
serving.http_api, on an 8-slot virtual mesh of "cpu" and the JAX
package's 8 virtual CPU devices. Tolerance: per query, equal id sets
(order may differ among exact RRF ties); the stream's contract and the
planted gold among its sources.
"""

import numpy as np
import pytest

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.parallel import ShardedSearchEngine as JaxEngine
from a_nice_rag_tpu.parallel import make_mesh as jax_make_mesh
from a_nice_rag_tpu.parallel import shard_index as jax_shard_index
from a_nice_rag_tpu_torch.config import InfoSource
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.parallel import (
    ShardedSearchEngine,
    make_mesh,
    shard_index,
    shard_ivf,
)
from a_nice_rag_tpu_torch.rag import FakeLLMClient, RAGSystem
from a_nice_rag_tpu_torch.retrieval.embed import PrecomputedEmbedder
from a_nice_rag_tpu_torch.retrieval.engine import SearchEngine
from a_nice_rag_tpu_torch.retrieval.rerank import IdentityReranker
from a_nice_rag_tpu_torch.testing import synth_corpus

MODEL = "voyage-3-large"
W = {MODEL: 5.0, "BM25": 1.0}


@pytest.fixture(scope="module")
def setup():
    c = synth_corpus(n_docs=600, dim=48, n_queries=8, seed=77)
    args = dict(ids=c.ids, sources=c.sources, contents=c.contents,
                urls=c.urls, embeddings=c.embeddings, token_lists=c.tokens)
    idx = build_index(device="cpu", **args)
    sidx = shard_index(idx, make_mesh(shape=(2, 4), devices=["cpu"] * 8))
    jsidx = jax_shard_index(jax_build_index(**args), jax_make_mesh(
        shape=(2, 4), axis_names=("dp", "corpus")))
    return c, idx, sidx, jsidx


def _same(a, b):
    assert len(a) == len(b)
    for qa, qb in zip(a, b):
        assert set(qa) == set(qb)


def test_retrieve_contract_matches_single_device(setup):
    c, idx, sidx, jsidx = setup
    se, sse, jse = SearchEngine(idx), ShardedSearchEngine(sidx), \
        JaxEngine(jsidx)
    kw = dict(query_embeddings={MODEL: c.query_embeddings[MODEL]},
              query_token_lists=c.query_tokens, similarity_k=12,
              common_sections_n=10, wrrf_k=40.0, model_weights=W,
              filename_type_filter=None, use_hybrid_search=True)
    s = sse.retrieve(**kw)
    _same(se.retrieve(**kw), s)
    _same(jse.retrieve(**kw), s)
    sf = sse.retrieve(**{**kw, "filename_type_filter": "NG"})
    _same(jse.retrieve(**{**kw, "filename_type_filter": "NG"}), sf)
    row_of = idx.meta.id_to_row
    for q_docs in sf:
        for did in q_docs:
            assert idx.meta.sources[row_of[did]].upper().startswith("NG")
    # An odd batch is padded to the dp axis and cut back.
    odd = sse.retrieve(**{**kw,
                          "query_embeddings": {MODEL: c.query_embeddings[
                              MODEL][:3]},
                          "query_token_lists": c.query_tokens[:3]})
    _same(s[:3], odd)
    # Documented deviations: the fused score, and no min_similarity.
    docs = sse.retrieve(**{**kw, "return_docs": True})
    assert all(0 < d["similarity"] < 1 for q in docs for d in q)
    with pytest.raises(NotImplementedError):
        sse.retrieve(**{**kw, "min_similarity": 0.5})


def test_rag_stream_over_sharded_mesh(setup):
    c, idx, sidx, _ = setup
    queries = [f"question {i}" for i in range(8)]
    embedder = PrecomputedEmbedder(
        {q: c.query_embeddings[MODEL][i] for i, q in enumerate(queries)})
    sse = ShardedSearchEngine(sidx, embedder=embedder,
                              reranker=IdentityReranker())
    system = RAGSystem(indexes={}, embedder=embedder,
                       reranker=IdentityReranker(),
                       llm_clients={"fake": FakeLLMClient()}, device="cpu")
    system.attach_index(InfoSource.NICE, idx, engine=sse)
    assert system.engines[InfoSource.NICE] is sse
    chunks, s_data = [], None
    for chunk, sources, raw, s_data in system.query_rag_stream(
            queries[0], "fake-llm", use_hybrid_search=True,
            use_reranker=True):
        chunks.append(chunk)
    assert len(chunks) > 1
    assert "".join(chunks).startswith("[fake:fake-llm]")
    assert c.gold_ids[0] in (d["section_id"] for d in s_data)


def test_rag_stream_over_sharded_ivf(setup):
    """The ANN route (nprobe) serves the RAG layer end to end."""
    c, idx, sidx, _ = setup
    sidx_ivf = shard_ivf(sidx, MODEL, tile_n=64)
    queries = [f"question {i}" for i in range(8)]
    embedder = PrecomputedEmbedder(
        {q: c.query_embeddings[MODEL][i] for i, q in enumerate(queries)})
    sse = ShardedSearchEngine(sidx_ivf, embedder=embedder, nprobe=8)
    system = RAGSystem(indexes={}, embedder=embedder,
                       llm_clients={"fake": FakeLLMClient()}, device="cpu")
    system.attach_index(InfoSource.NICE, idx, engine=sse)
    hits = 0
    for i, q in enumerate(queries):
        docs = system.retrieve_for_query(
            q, InfoSource.NICE, 12, 10, 40.0, W, None,
            use_hybrid_search=True, use_reranker=False,
            reranker_model="rerank-2", reranker_top_k=None)
        hits += c.gold_ids[i] in [d["id"] for d in docs]
    assert hits >= 7, hits
    assert next(iter(sse._retrievers.values())).use_ivf


def test_http_rag_over_sharded_mesh(setup):
    """The serving stack over the mesh: HTTP /v1/search and /v1/rag
    through ShardedSearchEngine with no http_api change."""
    import json
    import urllib.request

    from a_nice_rag_tpu_torch.serving.http_api import serve

    c, idx, sidx, _ = setup
    queries = [f"question {i}" for i in range(8)]
    embedder = PrecomputedEmbedder(
        {q: c.query_embeddings[MODEL][i] for i, q in enumerate(queries)})
    system = RAGSystem(indexes={}, embedder=embedder,
                       llm_clients={"fake": FakeLLMClient()}, device="cpu")
    system.attach_index(InfoSource.NICE, idx,
                        engine=ShardedSearchEngine(sidx, embedder=embedder))
    srv = serve(system, port=0, background=True)
    try:
        port = srv.server_address[1]

        def post(path, payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                return json.loads(resp.read())

        out = post("/v1/search", {"query": queries[0],
                                  "use_hybrid_search": True})
        assert c.gold_ids[0] in [d["id"] for d in out["results"]]
        rag_out = post("/v1/rag", {"query": queries[1],
                                   "llm_model": "fake-llm",
                                   "use_hybrid_search": True})
        assert rag_out["answer"].startswith("[fake:fake-llm]")
        assert c.gold_ids[1] in (d["section_id"] for d in rag_out["sources"])
    finally:
        srv.shutdown()


def test_bm25_only_placeholder_contract(setup):
    """RAGSystem's BM25-only path passes a '__none__' placeholder dict:
    the adapter serves the BM25 list alone, as the single-device engine
    and the JAX package's adapter do."""
    c, idx, sidx, jsidx = setup
    kw = dict(query_embeddings={"__none__": np.zeros((1, 1), np.float32)},
              query_token_lists=c.query_tokens[:2], similarity_k=12,
              common_sections_n=10, wrrf_k=40.0,
              model_weights={"BM25": 1.0}, use_hybrid_search=True)
    s = ShardedSearchEngine(sidx).retrieve(**kw)
    assert all(s)
    _same(SearchEngine(idx).retrieve(**kw), s)
    _same(JaxEngine(jsidx).retrieve(**kw), s)
