"""The port's SearchEngine, RetrievalEvaluationSystem and the embed and
rerank clients against the JAX package's, on the CPU.

One seeded ``synth_corpus`` is indexed by the JAX package's
``build_index``; the port runs over the same arrays, carried across by
``index/convert.py`` (``from_reference_index``) or built by its own
``build_index`` from the same inputs. Both engines take the same
queries. Tolerances:

- ranked lists (doc rows) equal after tie normalisation: a differing id
  is allowed only where its exact float64 score lies within the
  tolerance of the other list's (``check_top_k``); dense float32 scores
  within 1e-5, BM25 within 1e-4 (cumsum-difference segment totals of
  ``ops/bm25.py`` in both packages), int8 within 1e-5;
- ``retrieve``'s id lists and doc dicts equal, similarities within the
  same tolerances.

The cases mirror the JAX package's ``tests/test_engine.py`` (SearchEngine
cases), ``tests/test_fuzz_engine.py``, the engine case of
``tests/test_quantized.py`` and the ``RetrievalEvaluationSystem`` case of
``tests/test_parity_extras.py``, and cover both BM25 layouts: the CSR
scatter (``_bm25_list``) and the dense impact matrix
(``_bm25_list_dense``) on both sides of its gather rule (B*T <= V/2).
"""

import numpy as np
import pytest
import torch

from a_nice_rag_tpu.config import InfoSource as JaxInfoSource
from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.retrieval import SearchEngine as JaxEngine
from a_nice_rag_tpu.retrieval import embed as jax_embed
from a_nice_rag_tpu.retrieval import rerank as jax_rerank
from a_nice_rag_tpu.retrieval.eval_system import (
    RetrievalEvaluationSystem as JaxEvalSystem,
)
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.config import Config, InfoSource
from a_nice_rag_tpu_torch.index import build_index, from_reference_index
from a_nice_rag_tpu_torch.ops.quantized import quantize_queries
from a_nice_rag_tpu_torch.retrieval import (
    IdentityReranker,
    MultiModelReranker,
    OpenAIEmbedder,
    PrecomputedEmbedder,
    SearchEngine,
    VoyageEmbedder,
    VoyageReranker,
    embed,
    rerank,
)
from a_nice_rag_tpu_torch.retrieval import engine as torch_engine
from a_nice_rag_tpu_torch.retrieval.eval_system import (
    RetrievalEvaluationSystem,
)
from a_nice_rag_tpu_torch.retrieval.rerank import apply_rerank
from a_nice_rag_tpu_torch.testing import (
    GoldenBm25Okapi,
    golden_dense_top_k,
    golden_wrrf,
)
from a_nice_rag_tpu_torch.testing.parity import check_top_k

MODELS = ["voyage-3-large", "text-embedding-3-large"]
DENSE_ATOL = 1e-5
BM25_ATOL = 1e-4
INT8_ATOL = 1e-5
CPU = torch.device("cpu")


def _inputs(c):
    return dict(ids=c.ids, sources=c.sources, contents=c.contents,
                urls=c.urls, embeddings=c.embeddings, token_lists=c.tokens)


@pytest.fixture(scope="module", params=["convert", "build", "csr"])
def setup(request):
    """(corpus, JAX engine, port engine): the port's index carried across
    from the JAX index, built by the port, or both CSR-only (no dense
    impact matrix, so BM25 takes the CSR scatter)."""
    c = synth_corpus(n_docs=400, dim=48, n_queries=12, seed=31,
                     models=MODELS)
    kw = {"bm25_dense_max_bytes": 0} if request.param == "csr" else {}
    jidx = jax_build_index(**_inputs(c), **kw)
    if request.param == "build":
        tidx = build_index(**_inputs(c), device=CPU)
    else:
        tidx = from_reference_index(jidx, device=CPU)
    assert (tidx.bm25_dense is None) == (request.param == "csr")
    return (c, JaxEngine(jidx, reranker=jax_rerank.IdentityReranker()),
            SearchEngine(tidx, reranker=IdentityReranker()))


def _exact(c, model, q, ids):
    """float64 scores of the given rows, -inf where the row is -1."""
    ids = np.asarray(ids)
    if model == "BM25":
        golden = GoldenBm25Okapi(c.tokens)
        full = np.stack([golden.get_scores(t[:32]) for t in q])
    else:
        full = np.asarray(q, np.float64) @ np.asarray(
            c.embeddings[model], np.float64).T
    vals = np.take_along_axis(full, np.maximum(ids, 0), axis=1)
    return np.where(ids >= 0, vals, -np.inf)


def _same_lists(c, model, q, got, want, atol):
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_allclose(gv, wv, atol=atol)
    return check_top_k(_exact(c, model, q, wi), wi, _exact(c, model, q, gi),
                       gi, atol)


def _same_docs(got, want, atol=DENSE_ATOL):
    assert [d["id"] for d in got] == [d["id"] for d in want]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "similarity"} == \
            {k: v for k, v in w.items() if k != "similarity"}
        assert abs(g["similarity"] - w["similarity"]) <= atol


# -- dense and BM25 search ---------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("filt", [None, "CG", "NG,ta"])
def test_similarity_search_batch_matches_jax(setup, model, filt):
    c, jeng, teng = setup
    q = c.query_embeddings[model]
    got = teng.similarity_search_batch(q, model, 15, filt)
    assert isinstance(got[0], np.ndarray) and got[1].dtype == np.int32
    _same_lists(c, model, q, got, jeng.similarity_search_batch(
        q, model, 15, filt), DENSE_ATOL)


def test_similarity_search_with_embedding_parity(setup):
    c, jeng, teng = setup
    q = c.query_embeddings["voyage-3-large"][0]
    docs = teng.similarity_search_with_embedding(q, "voyage-3-large", 15)
    _same_docs(docs, jeng.similarity_search_with_embedding(
        q, "voyage-3-large", 15))
    g_vals, g_idx = golden_dense_top_k(c.embeddings["voyage-3-large"], q, 15)
    assert [d["id"] for d in docs] == [c.ids[i] for i in g_idx]
    np.testing.assert_allclose([d["similarity"] for d in docs], g_vals,
                               atol=DENSE_ATOL)
    assert docs[0]["document"] == c.contents[g_idx[0]]
    assert docs[0]["url"] == c.urls[g_idx[0]]


def test_similarity_search_embeds_text(setup):
    c, jeng, teng = setup
    table = {f"q{i}": e for i, e in
             enumerate(c.query_embeddings["voyage-3-large"])}
    teng.embedder = PrecomputedEmbedder(table)
    jeng.embedder = jax_embed.PrecomputedEmbedder(table)
    try:
        _same_docs(teng.similarity_search("q3", similarity_k=9),
                   jeng.similarity_search("q3", similarity_k=9))
    finally:
        teng.embedder = jeng.embedder = None
    with pytest.raises(ValueError, match="No embedder"):
        teng.similarity_search("q3")


@pytest.mark.parametrize("filt", [None, "CG"])
def test_bm25_search_preprocessed_batch_matches_jax(setup, filt):
    c, jeng, teng = setup
    toks = c.query_tokens
    got = teng.bm25_search_preprocessed_batch(toks, 10, filt)
    _same_lists(c, "BM25", toks, got,
                jeng.bm25_search_preprocessed_batch(toks, 10, filt),
                BM25_ATOL)


def test_bm25_search_preprocessed_parity(setup):
    c, jeng, teng = setup
    golden_bm25 = GoldenBm25Okapi(c.tokens)
    for qi in range(4):
        toks = c.query_tokens[qi]
        ids = teng.bm25_search_preprocessed(toks, similarity_k=10)
        assert ids == jeng.bm25_search_preprocessed(toks, similarity_k=10)
        scores = golden_bm25.get_scores(toks)
        got_scores = [scores[c.ids.index(i)] for i in ids]
        assert sorted(got_scores, reverse=True) == got_scores
        kth = sorted(scores, reverse=True)[9]
        assert all(s >= kth - BM25_ATOL for s in got_scores)
    assert teng.bm25_search_preprocessed([], 10) == []


def test_bm25_search_preprocesses_text(setup):
    c, jeng, teng = setup
    for qi in range(3):
        text = "The " + " ".join(c.query_tokens[qi]) + "s, 42!"
        assert teng.bm25_search(text, 10) == jeng.bm25_search(text, 10)


def test_bm25_zero_score_slots_are_filled_not_minus_one(setup):
    # A query matching few docs: the rest of its list is zero-score docs
    # in id order (the scatter route's finite zeros), as in the JAX
    # package, not -1.
    c, jeng, teng = setup
    toks = [[c.query_tokens[0][0]], ["no-such-token"]]
    got = teng.bm25_search_preprocessed_batch(toks, 25)
    want = jeng.bm25_search_preprocessed_batch(toks, 25)
    _same_lists(c, "BM25", toks, got, want, BM25_ATOL)
    assert (got[1] >= 0).all() and (got[0][1] == 0).all()
    np.testing.assert_array_equal(got[1][1], np.arange(25))


# -- retrieve ----------------------------------------------------------------


def test_filename_filter_respected(setup):
    c, jeng, teng = setup
    kw = dict(model_weights={"voyage-3-large": 1.0},
              filename_type_filter="CG", similarity_k=20,
              common_sections_n=20)
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"][:3]}
    got = teng.retrieve(q, **kw)
    assert got == jeng.retrieve(q, **kw)
    for ids in got:
        assert ids, "filter should not empty the result"
        for sid in ids:
            assert c.sources[c.ids.index(sid)].upper().startswith("CG")


def test_retrieve_dense_only_matches_golden(setup):
    c, jeng, teng = setup
    q = c.query_embeddings["voyage-3-large"]
    kw = dict(model_weights={"voyage-3-large": 1.0}, similarity_k=25,
              common_sections_n=15)
    got = teng.retrieve({"voyage-3-large": q}, **kw)
    assert got == jeng.retrieve({"voyage-3-large": q}, **kw)
    for b in range(len(q)):
        _, g_idx = golden_dense_top_k(c.embeddings["voyage-3-large"], q[b],
                                      25)
        assert got[b] == [c.ids[i] for i in g_idx[:15]]


def test_retrieve_hybrid_matches_jax_and_golden_pipeline(setup):
    c, jeng, teng = setup
    weights = {"voyage-3-large": 5.0, "text-embedding-3-large": 2.0,
               "BM25": 1.0}
    k, n, wk = 10, 8, 40.0
    kw = dict(query_embeddings={m: c.query_embeddings[m] for m in MODELS},
              query_token_lists=c.query_tokens, model_weights=weights,
              similarity_k=k, common_sections_n=n, wrrf_k=wk,
              use_hybrid_search=True)
    got = teng.retrieve(**kw)
    assert got == jeng.retrieve(**kw)
    golden_bm25 = GoldenBm25Okapi(c.tokens)
    for b in range(4):
        lists = []
        for m in MODELS:
            _, g_idx = golden_dense_top_k(c.embeddings[m],
                                          c.query_embeddings[m][b], k)
            lists.append(([c.ids[i] for i in g_idx], m))
        scores = golden_bm25.get_scores(c.query_tokens[b])
        top = np.argsort(scores)[::-1][:k]
        assert scores[top[-1]] > 0
        lists.append(([c.ids[i] for i in top], "BM25"))
        fused = golden_wrrf(lists, weights, k=int(wk))
        assert set(got[b]) == {sid for sid, _ in fused[:n]}


def test_retrieve_return_docs_first_ranker_similarity(setup):
    c, jeng, teng = setup
    kw = dict(query_embeddings={m: c.query_embeddings[m][:4]
                                for m in MODELS},
              query_token_lists=c.query_tokens[:4],
              model_weights={"voyage-3-large": 5.0,
                             "text-embedding-3-large": 2.0, "BM25": 1.0},
              similarity_k=10, common_sections_n=30, use_hybrid_search=True,
              return_docs=True)
    got, want = teng.retrieve(**kw), jeng.retrieve(**kw)
    for g, w in zip(got, want):
        _same_docs(g, w)
    # Every listed doc is in the fused list; docs only BM25 surfaced
    # report similarity 0.0.
    assert any(d["similarity"] == 0.0 for docs in got for d in docs)


def test_retrieve_single_list_when_one_ranker(setup):
    c, jeng, teng = setup
    kw = dict(query_token_lists=c.query_tokens[:2],
              model_weights={"voyage-3-large": 0.0, "BM25": 1.0},
              use_hybrid_search=True, similarity_k=12, common_sections_n=5)
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"][:2]}
    got = teng.retrieve(q, **kw)
    assert got == jeng.retrieve(q, **kw)
    for b in range(2):
        assert got[b] == teng.bm25_search_preprocessed(
            c.query_tokens[b], 12)[:5]


def test_retrieve_bm25_from_query_texts(setup):
    c, jeng, teng = setup
    texts = [" ".join(t) for t in c.query_tokens[:3]]
    kw = dict(query_texts=texts, use_hybrid_search=True, similarity_k=10,
              common_sections_n=6)
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"][:3]}
    got = teng.retrieve(q, **kw)  # the default weights: 5:1
    assert got == jeng.retrieve(q, **kw)
    # No texts or tokens: BM25 is skipped, dense alone remains.
    assert teng.retrieve(q, use_hybrid_search=True) == teng.retrieve(q)


def test_retrieve_with_reranker_top_k(setup):
    c, jeng, teng = setup
    kw = dict(query_texts=["some query"],
              model_weights={"voyage-3-large": 1.0}, use_reranker=True,
              reranker_top_k=3, common_sections_n=15, return_docs=True)
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"][:1]}
    got = teng.retrieve(q, **kw)
    assert len(got[0]) == 3
    _same_docs(got[0], jeng.retrieve(q, **kw)[0])


class _Boom:
    def rerank(self, *a, **k):
        raise RuntimeError("api down")


def test_rerank_failure_falls_back(setup):
    docs = [{"id": "a", "document": "x"}, {"id": "b", "document": "y"}]
    assert apply_rerank(_Boom(), "q", docs, "rerank-2", 1) == docs
    assert apply_rerank(_Boom(), "q", docs, "rerank-2", 1) == \
        jax_rerank.apply_rerank(_Boom(), "q", docs, "rerank-2", 1)
    assert apply_rerank(None, "q", docs, "rerank-2", 1) == docs
    # Through the engine: the fused order, not truncated to top_k.
    c, _, teng = setup
    eng = SearchEngine(teng.index, reranker=_Boom())
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"][:1]}
    kw = dict(model_weights={"voyage-3-large": 1.0}, common_sections_n=6)
    assert eng.retrieve(q, query_texts=["x"], use_reranker=True,
                        reranker_top_k=2, **kw) == teng.retrieve(q, **kw)


def test_min_similarity_threshold(setup):
    c, jeng, teng = setup
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"][:2]}
    w = {"voyage-3-large": 1.0}
    got = teng.retrieve(q, model_weights=w, min_similarity=2.0)
    assert all(len(ids) == 0 for ids in got)
    assert got == jeng.retrieve(q, model_weights=w, min_similarity=2.0)
    base = teng.retrieve(q, model_weights=w)
    assert teng.retrieve(q, model_weights=w, min_similarity=-2.0) == base
    # A threshold inside the score range cuts the list as the JAX one does.
    vals, _ = teng.similarity_search_batch(q["voyage-3-large"],
                                           similarity_k=25)
    thr = float(vals[0, 5])
    assert teng.retrieve(q, model_weights=w, min_similarity=thr) == \
        jeng.retrieve(q, model_weights=w, min_similarity=thr)


def test_retrieve_rejects_bad_arguments(setup):
    c, _, teng = setup
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"][:1]}
    with pytest.raises(ValueError, match="cannot be empty"):
        teng.retrieve({})
    with pytest.raises(ValueError, match="positive"):
        teng.retrieve(q, similarity_k=0)
    # No active ranker: one empty list per query.
    assert teng.retrieve(q, model_weights={"voyage-3-large": 0.0}) == [[]]


def test_weighted_reciprocal_rank_fusion_matches(setup):
    c, jeng, teng = setup
    lists = [(c.ids[:10], "voyage-3-large"), (c.ids[5:15][::-1], "BM25"),
             (c.ids[3:8], "other")]
    w = {"voyage-3-large": 5.0, "BM25": 1.0}
    got = teng.weighted_reciprocal_rank_fusion(lists, w, k=40)
    assert got == jeng.weighted_reciprocal_rank_fusion(lists, w, k=40)
    # The golden form multiplies by 1 / (k + rank): the last bit differs.
    gold = golden_wrrf(lists, w, k=40)
    assert [d for d, _ in got] == [d for d, _ in gold]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in gold],
                               rtol=1e-12)


def test_search_engine_keeps_index_on_its_device(setup):
    c, _, teng = setup
    assert teng.index.device == CPU
    q = torch.as_tensor(c.query_embeddings["voyage-3-large"][:2])
    vals, idx = teng.similarity_search_batch(q, similarity_k=5)
    assert vals.shape == idx.shape == (2, 5)
    assert torch_engine.MODEL_ORDER == (
        "voyage-3-large", "voyage-3.5", "text-embedding-3-large", "Qwen3")


# -- BM25's dense impact matrix: both sides of the gather rule ---------------


@pytest.mark.parametrize("b", [1, 2, 12])
def test_bm25_dense_gather_rule(monkeypatch, b):
    c = synth_corpus(n_docs=300, dim=16, n_queries=12, seed=33,
                     vocab_size=300)
    jidx = jax_build_index(**_inputs(c))
    tidx = from_reference_index(jidx, device=CPU)
    assert tidx.bm25_dense is not None
    v = tidx.bm25_dense.vocab_size
    gather = b * 32 <= v // 2  # t_max = 32
    calls = []
    for name in ("bm25_scores_dense_gather", "bm25_scores_dense"):
        fn = getattr(torch_engine, name)
        monkeypatch.setattr(torch_engine, name,
                            lambda *a, _fn=fn, _n=name: calls.append(_n)
                            or _fn(*a))
    toks = c.query_tokens[:b]
    got = SearchEngine(tidx).bm25_search_preprocessed_batch(toks, 10)
    assert calls == ["bm25_scores_dense_gather" if gather
                     else "bm25_scores_dense"]
    _same_lists(c, "BM25", toks, got,
                JaxEngine(jidx).bm25_search_preprocessed_batch(toks, 10),
                BM25_ATOL)


# -- fuzz (tests/test_fuzz_engine.py) ----------------------------------------


@pytest.mark.parametrize("seed,n_docs,dim", [(301, 130, 24), (302, 257, 40),
                                             (303, 77, 16)])
def test_hybrid_engine_fuzz(seed, n_docs, dim):
    c = synth_corpus(n_docs=n_docs, dim=dim, n_queries=6, seed=seed,
                     vocab_size=200)
    kw = dict(ids=c.ids, sources=c.sources, contents=c.contents,
              embeddings=c.embeddings, token_lists=c.tokens)
    jidx = jax_build_index(**kw)
    teng = SearchEngine(build_index(**kw, device=CPU))
    weights = {"voyage-3-large": 3.0, "BM25": 1.0}
    k = min(9, n_docs)
    args = dict(
        query_embeddings={"voyage-3-large":
                          c.query_embeddings["voyage-3-large"]},
        query_token_lists=c.query_tokens, model_weights=weights,
        similarity_k=k, common_sections_n=k, wrrf_k=50.0,
        use_hybrid_search=True)
    got = teng.retrieve(**args)
    assert got == JaxEngine(jidx).retrieve(**args)
    golden_bm25 = GoldenBm25Okapi(c.tokens)
    emb = c.embeddings["voyage-3-large"]
    for b in range(6):
        _, d_idx = golden_dense_top_k(
            emb, c.query_embeddings["voyage-3-large"][b], k)
        scores = golden_bm25.get_scores(c.query_tokens[b])
        b_idx = np.argsort(scores)[::-1][:k]
        if scores[b_idx[-1]] <= 0:
            continue  # zero-score tail makes tie order unspecified
        fused = golden_wrrf(
            [([c.ids[i] for i in d_idx], "voyage-3-large"),
             ([c.ids[i] for i in b_idx], "BM25")], weights, k=50)
        assert set(got[b]) == {sid for sid, _ in fused[:k]}


# -- int8 (tests/test_quantized.py) ------------------------------------------


def test_search_engine_and_evaluator_accept_quantized_index():
    c = synth_corpus(n_docs=640, dim=128, n_queries=24, seed=7,
                     vocab_size=3000)
    jidx = jax_build_index(ids=c.ids, sources=c.sources,
                           contents=c.contents, embeddings=c.embeddings,
                           token_lists=c.tokens, quantize_dense=True)
    tidx = from_reference_index(jidx, device=CPU)
    assert "voyage-3-large" in tidx.dense_q
    teng, jeng = SearchEngine(tidx), JaxEngine(jidx)
    q = c.query_embeddings["voyage-3-large"]
    # The lists select on acc * s_q * s_d in both packages.
    qv, qs = (t.numpy() for t in quantize_queries(torch.as_tensor(q)))
    qd = tidx.dense_q["voyage-3-large"]
    exact = (qv.astype(np.float64) @ qd.values.numpy().astype(np.float64).T
             * qs[:, None] * qd.scales.numpy()[None, :])
    got = teng.similarity_search_batch(q, similarity_k=15)
    want = jeng.similarity_search_batch(q, similarity_k=15)
    np.testing.assert_allclose(got[0], want[0], atol=INT8_ATOL)
    pick = lambda ids: np.take_along_axis(exact, ids, axis=1)  # noqa: E731
    check_top_k(pick(want[1]), want[1], pick(got[1]), got[1], INT8_ATOL)

    kw = dict(query_embeddings={"voyage-3-large": q[:8]},
              query_texts=[" ".join(t) for t in c.query_tokens[:8]],
              query_token_lists=c.query_tokens[:8], similarity_k=15,
              common_sections_n=10, wrrf_k=40.0,
              model_weights={"voyage-3-large": 5.0, "BM25": 1.0},
              filename_type_filter=None, use_hybrid_search=True,
              use_reranker=False)
    out = teng.retrieve(**kw)
    assert out == jeng.retrieve(**kw)
    assert sum(c.gold_ids[i] in out[i] for i in range(8)) >= 6

    # The evaluator: recall@10 over every query through the facade.
    tsys = RetrievalEvaluationSystem(indexes={InfoSource.NICE: tidx})
    jsys = JaxEvalSystem(indexes={JaxInfoSource.NICE: jidx})
    found = 0
    for i in range(len(q)):
        args = dict(query_embeddings={"voyage-3-large": q[i]},
                    query_tokens=c.query_tokens[i],
                    model_weights={"voyage-3-large": 5.0, "BM25": 1.0},
                    use_hybrid_search=True, similarity_k=15,
                    common_sections_n=10)
        ids = tsys.retrieve_documents(**args)
        assert ids == jsys.retrieve_documents(**args)
        found += c.gold_ids[i] in ids
    assert found / len(q) > 0.7


# -- RetrievalEvaluationSystem (tests/test_parity_extras.py) ----------------


def test_retrieval_evaluation_system():
    c = synth_corpus(n_docs=200, dim=32, n_queries=8, seed=151)
    kw = dict(ids=c.ids, sources=c.sources, contents=c.contents,
              embeddings=c.embeddings, token_lists=c.tokens)
    jidx = jax_build_index(**kw)
    tsys = RetrievalEvaluationSystem(
        indexes={InfoSource.NICE: from_reference_index(jidx, device=CPU)})
    jsys = JaxEvalSystem(indexes={JaxInfoSource.NICE: jidx})
    args = dict(query_embeddings={"voyage-3-large":
                                  c.query_embeddings["voyage-3-large"][0]},
                query_tokens=c.query_tokens[0],
                model_weights={"voyage-3-large": 5.0, "BM25": 1.0},
                use_hybrid_search=True, use_reranker=False,
                similarity_k=20, common_sections_n=10)
    ids = tsys.retrieve_documents(**args)
    assert ids == jsys.retrieve_documents(**args)
    assert len(ids) == 10 and c.gold_ids[0] in ids
    with pytest.raises(ValueError, match="cannot be empty"):
        tsys.retrieve_documents(query_embeddings={})
    with pytest.raises(ValueError, match="cannot be empty"):
        tsys.retrieve_documents(query_embeddings={"voyage-3-large": []})
    one = dict(query_embeddings={"voyage-3-large":
                                 c.query_embeddings["voyage-3-large"][0]},
               info_source="NICE", model_weights={"voyage-3-large": 1.0},
               use_reranker=False)
    assert tsys.retrieve_documents(**one) == jsys.retrieve_documents(**one)
    # The defaults: rerank-2-lite top 5 through the attached reranker,
    # wrrf_k 60.
    tsys.attach_index(InfoSource.NICE, tsys.engines[InfoSource.NICE].index,
                      reranker=IdentityReranker())
    jsys.attach_index(JaxInfoSource.NICE, jidx,
                      reranker=jax_rerank.IdentityReranker())
    dflt = dict(args, query_text="q", use_reranker=True)
    got = tsys.retrieve_documents(**dflt)
    assert len(got) == 5 and got == jsys.retrieve_documents(**dflt)
    assert isinstance(tsys.config, Config)
    # An index attached under no source: nothing to search.
    assert RetrievalEvaluationSystem().retrieve_documents(**one) == []


# -- embed and rerank clients, against a stubbed _post_json -----------------


class _Post:
    """Records each request and answers with ``reply(payload)``."""

    def __init__(self, reply):
        self.reply, self.calls = reply, []

    def __call__(self, url, payload, headers, timeout=60.0):
        self.calls.append((url, payload, headers))
        return self.reply(payload)


def _embeddings_reply(payload):
    # Out of order on purpose: the clients sort by index.
    n = len(payload["input"])
    return {"data": [{"index": i, "embedding": [float(i), 0.5, -1.0]}
                     for i in reversed(range(n))]}


@pytest.mark.parametrize("cls", ["VoyageEmbedder", "OpenAIEmbedder"])
def test_embedders_match_jax(monkeypatch, cls):
    tpost, jpost = _Post(_embeddings_reply), _Post(_embeddings_reply)
    monkeypatch.setattr(embed, "_post_json", tpost)
    monkeypatch.setattr(jax_embed, "_post_json", jpost)
    t = getattr(embed, cls)(api_key="key")
    j = getattr(jax_embed, cls)(api_key="key")
    for fn in ("embed_queries", "embed_documents"):
        got = getattr(t, fn)(["a", "b", "c"])
        want = getattr(j, fn)(["a", "b", "c"])
        assert got.dtype == np.float32 and got.shape == (3, 3)
        np.testing.assert_array_equal(got, want)
        assert got[:, 0].tolist() == [0.0, 1.0, 2.0]
    assert tpost.calls == jpost.calls
    url, payload, headers = tpost.calls[0]
    assert headers == {"Authorization": "Bearer key"}
    if cls == "VoyageEmbedder":
        assert url == "https://api.voyageai.com/v1/embeddings"
        assert payload["input_type"] == "query"
        assert tpost.calls[1][1]["input_type"] == "document"
        assert payload["output_dimension"] == 2048
    else:
        assert url == "https://api.openai.com/v1/embeddings"


def test_clients_need_their_keys(monkeypatch):
    monkeypatch.delenv("VOYAGE_API_KEY", raising=False)
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    for make in (VoyageEmbedder, OpenAIEmbedder, VoyageReranker):
        with pytest.raises(ValueError, match="API_KEY not set"):
            make()
    monkeypatch.setenv("VOYAGE_API_KEY", "env-key")
    assert VoyageEmbedder().api_key == "env-key"


def test_precomputed_embedder():
    table = {"a": np.ones(3), "b": np.zeros(3)}
    got = PrecomputedEmbedder(table).embed_queries(["b", "a"])
    np.testing.assert_array_equal(
        got, jax_embed.PrecomputedEmbedder(table).embed_queries(["b", "a"]))
    assert got.dtype == np.float32
    with pytest.raises(KeyError, match="No precomputed embedding"):
        PrecomputedEmbedder(table).embed_documents(["c"])


def test_voyage_reranker_matches_jax(monkeypatch):
    def reply(payload):
        n = len(payload["documents"])
        return {"data": [{"index": i, "relevance_score": 1.0 / (i + 1)}
                         for i in reversed(range(n))] + [{"index": 99}]}

    tpost, jpost = _Post(reply), _Post(reply)
    monkeypatch.setattr(rerank, "_post_json", tpost)
    monkeypatch.setattr(jax_rerank, "_post_json", jpost)
    docs = [{"id": f"d{i}", "document": f"text {i}"} for i in range(4)]
    got = VoyageReranker(api_key="k").rerank("q", docs, "rerank-2-lite", 3)
    want = jax_rerank.VoyageReranker(api_key="k").rerank(
        "q", docs, "rerank-2-lite", 3)
    assert got == want
    assert [d["id"] for d in got] == ["d3", "d2", "d1", "d0"]
    assert got[0]["rerank_score"] == 0.25
    assert tpost.calls == jpost.calls
    assert tpost.calls[0][1] == {"query": "q", "documents": [
        d["document"] for d in docs], "model": "rerank-2-lite", "top_k": 3,
        "truncation": True}


def test_identity_and_multi_model_rerankers():
    docs = [{"id": str(i)} for i in range(5)]
    assert IdentityReranker().rerank("q", docs, top_k=2) == docs[:2]
    assert IdentityReranker().rerank("q", docs) == docs

    class Tier:
        def __init__(self, name):
            self.name = name

        def rerank(self, query_text, documents, model, top_k):
            return [dict(d, tier=self.name) for d in documents[:top_k]]

    multi = MultiModelReranker({"rerank-2": Tier("big"),
                                "rerank-2-lite": Tier("lite")})
    assert multi.default == "rerank-2"
    assert multi.rerank("q", docs, "rerank-2-lite", 2)[0]["tier"] == "lite"
    assert multi.rerank("q", docs, "unknown", 1) == [{"id": "0",
                                                      "tier": "big"}]
    with pytest.raises(ValueError, match="non-empty"):
        MultiModelReranker({})
    with pytest.raises(ValueError, match="default"):
        MultiModelReranker({"a": Tier("a")}, default="b")
