"""The port's IR eval harness, its CLIs, the BM25 tuner and query prep
against the JAX package's, on the CPU.

One seeded corpus is indexed by each package (the port builds its own
index from the same inputs); both evaluators take the same queries.
Tolerances:

- metrics dicts equal, on every configuration of
  ``STANDARD_CONFIGURATIONS`` (the two rerank configurations with
  ``IdentityReranker`` in both packages). Ranks come from strict ``>``
  comparisons of float32 scores, and both packages form them with the
  same float32 products; a rank could still move by one where two docs'
  scores differ by a rounding of the summation order (a near-tie of
  about 1e-7), so where a dict differs at most one query's rank may
  differ: found counts within 1, MRR and each recall within 1/n_q;
- results CSVs of the CLIs equal row for row under the same rule;
- ``tune_bm25`` history equal (same GP calls on the same objective
  values), at ``n_calls=12, n_initial=6``;
- ``seed42_split`` equal to scikit-learn's ``train_test_split``.

The cases mirror ``tests/test_retrieval_eval.py`` (7),
``tests/test_quality_gate.py`` (3),
``tests/test_eval_cli.py::test_run_retrieval_eval_cli``,
``tests/test_replay_reference.py`` (2) and ``tests/test_ingest.py``'s
``test_bm25_tuner_small`` and ``test_query_prep_roundtrip``.
"""

import csv
import os
import sqlite3

import numpy as np
import pytest
import torch

from a_nice_rag_tpu.evals import retrieval_eval as jax_eval
from a_nice_rag_tpu.evals.replay_reference import main as jax_replay_main
from a_nice_rag_tpu.evals.run_retrieval_eval import main as jax_eval_main
from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.index import save_index as jax_save_index
from a_nice_rag_tpu.ingest import bm25_tune as jax_tune
from a_nice_rag_tpu.ingest import query_prep as jax_query_prep
from a_nice_rag_tpu.retrieval import SearchEngine as JaxEngine
from a_nice_rag_tpu.retrieval.rerank import IdentityReranker as JaxIdentity
from a_nice_rag_tpu.testing import (
    calibrated_quality_corpus as jax_calibrated_quality_corpus,
)
from a_nice_rag_tpu_torch.evals import (
    EvalConfig,
    RetrievalEvaluator,
    STANDARD_CONFIGURATIONS,
    calculate_metrics,
)
from a_nice_rag_tpu_torch.evals import metrics
from a_nice_rag_tpu_torch.evals.replay_reference import main as replay_main
from a_nice_rag_tpu_torch.evals.retrieval_eval import seed42_split
from a_nice_rag_tpu_torch.evals.run_retrieval_eval import main as eval_main
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.ingest import bm25_tune, query_prep
from a_nice_rag_tpu_torch.ingest.bm25_build import write_tokens_csv
from a_nice_rag_tpu_torch.retrieval import IdentityReranker, SearchEngine
from a_nice_rag_tpu_torch.testing import (
    GoldenBm25Okapi,
    calibrated_quality_corpus,
    golden_dense_top_k,
    golden_wrrf,
    synth_corpus,
)
from a_nice_rag_tpu_torch.testing.reference_fixture import (
    write_reference_fixture,
)

MODELS = ["voyage-3-large", "text-embedding-3-large"]
ALL_MODELS = ["voyage-3-large", "voyage-3.5", "text-embedding-3-large",
              "Qwen3"]
CPU = torch.device("cpu")


def _inputs(c):
    return dict(ids=c.ids, sources=c.sources, contents=c.contents,
                urls=c.urls, embeddings=c.embeddings, token_lists=c.tokens)


def _same_metrics(got, want, n_q, what=""):
    """Equal, or at most one query's rank apart (a float32 near-tie)."""
    if got == want:
        return
    assert set(got) == set(want), what
    assert got["total"] == want["total"] == n_q, what
    assert abs(got["found"] - want["found"]) <= 1, (what, got, want)
    for key in ("mrr", "recall@1", "recall@5", "recall@10", "recall@15",
                "success_rate"):
        assert abs(got[key] - want[key]) <= 1.0 / n_q + 1e-12, (
            what, key, got, want)


def _zero():
    return {m: 0.0 for m in ALL_MODELS} | {"BM25": 0.0}


@pytest.fixture(scope="module")
def setup():
    c = synth_corpus(n_docs=300, dim=32, n_queries=40, seed=71,
                     models=MODELS)
    inputs = {k: v for k, v in _inputs(c).items() if k != "urls"}
    idx = build_index(**inputs, device=CPU)
    jidx = jax_build_index(**inputs)
    ev = RetrievalEvaluator(idx, SearchEngine(idx,
                                              reranker=IdentityReranker()))
    jev = jax_eval.RetrievalEvaluator(
        jidx, JaxEngine(jidx, reranker=JaxIdentity()))
    return c, ev, jev


def _both(setup, cfg, **kw):
    c, ev, jev = setup
    args = ({"voyage-3-large": c.query_embeddings["voyage-3-large"]},
            c.gold_ids)
    got = ev.evaluate_config(cfg, *args, **kw)
    want = jev.evaluate_config(jax_eval.EvalConfig(**vars(cfg)), *args, **kw)
    _same_metrics(got, want, len(c.gold_ids), cfg.name)
    return got


def _golden_ranks_dense(c, model, k_cap):
    ranks = []
    emb = c.embeddings[model]
    for i, q in enumerate(c.query_embeddings[model]):
        _, order = golden_dense_top_k(emb, q, len(c.ids))
        ids = [c.ids[j] for j in order][:k_cap]
        ranks.append(ids.index(c.gold_ids[i]) + 1
                     if c.gold_ids[i] in ids else -1)
    return np.array(ranks)


def test_dense_only_matches_golden(setup):
    c, _, _ = setup
    cfg = EvalConfig("dense", _zero() | {"voyage-3-large": 1.0}, False,
                     similarity_k=300, common_sections_n=300)
    m = _both(setup, cfg, filename_type_filter=None)
    expect = calculate_metrics(_golden_ranks_dense(c, "voyage-3-large", 300))
    assert m["mrr"] == pytest.approx(expect["mrr"], abs=1e-3)
    assert m["recall@10"] == pytest.approx(expect["recall@10"], abs=1e-9)
    assert m["found"] == expect["found"]


def test_bm25_only_matches_golden(setup):
    c, _, _ = setup
    cfg = EvalConfig("bm25", _zero() | {"BM25": 1.0}, True,
                     similarity_k=300, common_sections_n=300)
    m = _both(setup, cfg, query_token_lists=c.query_tokens,
              filename_type_filter=None)
    golden = GoldenBm25Okapi(c.tokens)
    ranks = []
    for i, toks in enumerate(c.query_tokens):
        scores = golden.get_scores(toks[:32])
        gold_row = c.ids.index(c.gold_ids[i])
        ranks.append(1 + int((scores > scores[gold_row]).sum()))
    expect = calculate_metrics(np.array(ranks))
    assert m["mrr"] == pytest.approx(expect["mrr"], abs=5e-3)
    assert m["recall@10"] == pytest.approx(expect["recall@10"], abs=0.05)


def test_hybrid_fusion_matches_golden(setup):
    c, _, _ = setup
    weights = _zero() | {"voyage-3-large": 5.0, "BM25": 1.0}
    cfg = EvalConfig("hybrid", weights, True, similarity_k=50,
                     common_sections_n=50)
    m = _both(setup, cfg, query_token_lists=c.query_tokens,
              filename_type_filter=None, wrrf_k=40.0)
    golden = GoldenBm25Okapi(c.tokens)
    emb = c.embeddings["voyage-3-large"]
    ranks = []
    for i in range(len(c.gold_ids)):
        _, d_order = golden_dense_top_k(
            emb, c.query_embeddings["voyage-3-large"][i], 50)
        d_ids = [c.ids[j] for j in d_order]
        scores = golden.get_scores(c.query_tokens[i][:32])
        b_ids = [c.ids[j] for j in np.argsort(scores)[::-1][:50]]
        fused = golden_wrrf([(d_ids, "voyage-3-large"), (b_ids, "BM25")],
                            weights, k=40)
        ids = [sid for sid, _ in fused][:50]
        ranks.append(ids.index(c.gold_ids[i]) + 1
                     if c.gold_ids[i] in ids else -1)
    expect = calculate_metrics(np.array(ranks))
    # Tie ordering inside fused lists can shift ranks by a position or
    # two against the golden lists (as in the JAX package's test).
    assert m["mrr"] == pytest.approx(expect["mrr"], abs=0.02)
    assert m["recall@10"] == pytest.approx(expect["recall@10"], abs=0.05)
    assert m["success_rate"] == pytest.approx(expect["success_rate"],
                                              abs=0.03)


@pytest.mark.parametrize("filt", [None, "CG,NG"])
def test_reranker_config_path(setup, filt):
    c, _, _ = setup
    weights = _zero() | {"voyage-3-large": 5.0, "BM25": 1.0}
    cfg = EvalConfig("rerank", weights, True, similarity_k=25,
                     common_sections_n=15, use_reranker=True,
                     reranker_top_k=10)
    m = _both(setup, cfg, query_token_lists=c.query_tokens,
              query_texts=[f"q{i}" for i in range(len(c.gold_ids))],
              filename_type_filter=filt)
    assert m["total"] == len(c.gold_ids)
    if filt is None:
        assert m["recall@10"] > 0.5  # identity rerank keeps fused order


def test_run_writes_and_resumes_csv(setup, tmp_path):
    c, ev, jev = setup
    cfgs = [
        EvalConfig("A", _zero() | {"voyage-3-large": 1.0}, False, 300, 300),
        EvalConfig("B", _zero() | {"BM25": 1.0}, True, 300, 300),
    ]
    kw = dict(
        query_embeddings={
            "voyage-3-large": c.query_embeddings["voyage-3-large"]},
        gold_ids=c.gold_ids,
        query_token_lists=c.query_tokens,
        filename_type_filter=None,
    )
    out = os.path.join(tmp_path, "results.csv")
    r1 = ev.run(cfgs, output_csv=out, **kw)
    assert set(r1) == {"A", "B"}
    lines = open(out).read().strip().splitlines()
    assert len(lines) == 3 and lines[0] == metrics.CSV_HEADER
    jout = os.path.join(tmp_path, "jax.csv")
    jev.run([jax_eval.EvalConfig(**vars(cf)) for cf in cfgs],
            output_csv=jout, **kw)
    _same_csv(out, jout, len(c.gold_ids))
    # Resume: nothing re-evaluated.
    assert ev.run(cfgs, output_csv=out, **kw) == {}
    assert len(open(out).read().strip().splitlines()) == 3


def test_standard_configurations_shape():
    assert len(STANDARD_CONFIGURATIONS) == 9
    assert [vars(c) for c in STANDARD_CONFIGURATIONS] == [
        vars(c) for c in jax_eval.STANDARD_CONFIGURATIONS]
    hybrid = next(c for c in STANDARD_CONFIGURATIONS
                  if c.name == "Voyage-3-Large + BM25")
    assert hybrid.model_weights["voyage-3-large"] == 5.0
    assert hybrid.model_weights["BM25"] == 1.0
    assert metrics.CSV_HEADER.startswith("Model,MRR")


@pytest.mark.parametrize("n", [7, 40, 100, 2048, 3001])
def test_seed42_split_equals_sklearn(n):
    from sklearn.model_selection import train_test_split

    train, val = seed42_split(n)
    again = seed42_split(n)
    np.testing.assert_array_equal(train, again[0])
    s_train, s_val = train_test_split(range(n), test_size=0.15,
                                      random_state=42, shuffle=True)
    np.testing.assert_array_equal(train, s_train)
    np.testing.assert_array_equal(val, s_val)
    j_train, j_val = jax_eval.seed42_split(n)
    np.testing.assert_array_equal(train, j_train)
    assert set(train) | set(val) == set(range(n))
    if n == 100:
        assert len(val) == 15 and len(train) == 85


# -- all nine configurations, on four models ---------------------------------


@pytest.fixture(scope="module")
def four_models():
    c = synth_corpus(n_docs=600, dim=32, n_queries=48, seed=73,
                     models=ALL_MODELS, vocab_size=900)
    idx = build_index(**_inputs(c), device=CPU)
    jidx = jax_build_index(**_inputs(c))
    ev = RetrievalEvaluator(idx, SearchEngine(idx,
                                              reranker=IdentityReranker()))
    jev = jax_eval.RetrievalEvaluator(
        jidx, JaxEngine(jidx, reranker=JaxIdentity()))
    return c, ev, jev


@pytest.mark.parametrize("name", [c.name for c in STANDARD_CONFIGURATIONS])
@pytest.mark.parametrize("filt", [None, "CG,NG"])
def test_standard_configuration_matches_jax(four_models, name, filt):
    c, ev, jev = four_models
    cfg = next(x for x in STANDARD_CONFIGURATIONS if x.name == name)
    jcfg = next(x for x in jax_eval.STANDARD_CONFIGURATIONS if x.name == name)
    kw = dict(query_token_lists=c.query_tokens,
              query_texts=[" ".join(t) for t in c.query_tokens],
              filename_type_filter=filt)
    got = ev.evaluate_config(cfg, c.query_embeddings, c.gold_ids, **kw)
    want = jev.evaluate_config(jcfg, c.query_embeddings, c.gold_ids, **kw)
    _same_metrics(got, want, len(c.gold_ids), name)
    assert got["total"] == len(c.gold_ids)


# -- the quality gate --------------------------------------------------------


@pytest.fixture(scope="module")
def sweep():
    kw = dict(n_docs=4096, n_queries=768, vocab_size=8000, seed=42)
    c = calibrated_quality_corpus(**kw)
    jc = jax_calibrated_quality_corpus(**kw)
    assert c.gold_ids == jc.gold_ids and c.tokens == jc.tokens
    inputs = {k: v for k, v in _inputs(c).items() if k != "urls"}
    idx = build_index(**inputs, device=CPU)
    ev = RetrievalEvaluator(idx, SearchEngine(idx, IdentityReranker()))
    configs = [x for x in STANDARD_CONFIGURATIONS if not x.use_reranker]
    kw = dict(query_token_lists=c.query_tokens,
              query_texts=[" ".join(t) for t in c.query_tokens],
              filename_type_filter=None)
    results = ev.run(configs, c.query_embeddings, c.gold_ids, **kw)
    jidx = jax_build_index(**inputs)
    jev = jax_eval.RetrievalEvaluator(jidx, JaxEngine(jidx, JaxIdentity()))
    jresults = jev.run(
        [x for x in jax_eval.STANDARD_CONFIGURATIONS if not x.use_reranker],
        jc.query_embeddings, jc.gold_ids, **kw)
    return results, jresults, len(c.gold_ids)


V3L = "Voyage-3-Large"
V35 = "Voyage-3.5"
TE3L = "Text-Embedding-3-Large"
QWEN = "Qwen3-Embedding-0.6B"


def test_dense_models_spread_voyage_best(sweep):
    sweep, jsweep, n_q = sweep
    assert list(sweep) == list(jsweep) and len(sweep) == 7
    for name in sweep:
        _same_metrics(sweep[name], jsweep[name], n_q, name)
    mrr = {name: m["mrr"] for name, m in sweep.items()}
    assert mrr[V3L] > mrr[V35] > mrr[QWEN] > mrr[TE3L], mrr
    assert mrr[V3L] - mrr[TE3L] > 0.03, mrr


def test_every_dense_model_beats_bm25(sweep):
    sweep, _, _ = sweep
    for dense_cfg in (V3L, V35, TE3L, QWEN):
        assert sweep[dense_cfg]["mrr"] > sweep["BM25"]["mrr"], dense_cfg
        assert sweep[dense_cfg]["recall@10"] > sweep["BM25"]["recall@10"], \
            dense_cfg


def test_fusion_lifts_over_best_single(sweep):
    sweep, _, _ = sweep
    best_single_r10 = max(
        sweep[c]["recall@10"] for c in (V3L, V35, TE3L, QWEN, "BM25"))
    hybrid = sweep["Voyage-3-Large + BM25"]
    ensemble = sweep["Voyage-3-Large + Text-Embedding-3-Large"]
    assert hybrid["recall@10"] >= best_single_r10
    assert ensemble["recall@10"] >= best_single_r10
    assert hybrid["mrr"] > sweep["BM25"]["mrr"]
    assert ensemble["mrr"] > sweep[TE3L]["mrr"]


# -- the CLIs ----------------------------------------------------------------


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _same_csv(got_path, want_path, n_q):
    got, want = _rows(got_path), _rows(want_path)
    assert [r["Model"] for r in got] == [r["Model"] for r in want]
    for g, w in zip(got, want):
        if g == w:
            continue
        for key in ("MRR", "Recall@1", "Recall@5", "Recall@10", "Recall@15"):
            # Three decimals: one query's rank moves a value by <= 1/n_q,
            # plus half a unit in the last place of each rounding.
            assert abs(float(g[key]) - float(w[key])) <= 1.0 / n_q + 1e-3, (
                g, w)


def _write_query_db(path, ids, queries, emb):
    conn = sqlite3.connect(path)
    conn.execute(
        "CREATE TABLE queries (id TEXT, query TEXT, query_embedding BLOB)")
    for i, qid in enumerate(ids):
        conn.execute("INSERT INTO queries VALUES (?,?,?)",
                     (qid, queries[i], emb[i].astype(np.float32).tobytes()))
    conn.commit()
    conn.close()


def test_run_retrieval_eval_cli(tmp_path):
    c = synth_corpus(n_docs=200, dim=32, n_queries=40, seed=171)
    jidx = jax_build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                           embeddings=c.embeddings, token_lists=c.tokens)
    artifact = os.path.join(tmp_path, "artifact")
    jax_save_index(jidx, artifact)  # one artifact, read by both packages
    qdb = os.path.join(tmp_path, "queries.db")
    _write_query_db(qdb, c.gold_ids, [f"q {i}" for i in range(40)],
                    c.query_embeddings["voyage-3-large"])
    tokens_csv = os.path.join(tmp_path, "q_tokens.csv")
    write_tokens_csv(
        [{"id": c.gold_ids[i], "source": "x", "content": "",
          "tokens_regular": c.query_tokens[i],
          "tokens_lemmatized": c.query_tokens[i]} for i in range(40)],
        tokens_csv)
    argv = ["--index", artifact, "--queries-db", f"voyage-3-large={qdb}",
            "--bm25-queries", tokens_csv, "--filter", "", "--no-split"]
    out_csv = os.path.join(tmp_path, "results.csv")
    eval_main(argv + ["--output", out_csv, "--device", "cpu"])
    jout = os.path.join(tmp_path, "jax.csv")
    jax_eval_main(argv + ["--output", jout])
    names = [r["Model"] for r in _rows(out_csv)]
    assert "Voyage-3-Large" in names and "BM25" in names
    assert "Voyage-3-Large + BM25" in names
    _same_csv(out_csv, jout, 40)
    row = _rows(out_csv)[names.index("Voyage-3-Large")]
    assert float(row["MRR"]) > 0.5  # planted golds must be findable


def _replay_argv(fix, workdir, out_csv):
    argv = ["--workdir", workdir, "--output", out_csv,
            "--bm25-pickle", fix.bm25_pickle,
            "--bm25-queries", fix.bm25_queries_csv, "--filter", "CG,NG"]
    for m, p in fix.chunk_dbs.items():
        argv += ["--chunk-db", f"{m}={p}"]
    for m, p in fix.query_dbs.items():
        argv += ["--queries-db", f"{m}={p}"]
    return argv


def test_replay_reference_end_to_end(tmp_path):
    c = synth_corpus(n_docs=900, dim=48, n_queries=60, seed=611,
                     models=ALL_MODELS, vocab_size=700)
    fix = write_reference_fixture(str(tmp_path / "ref"), c,
                                  bm25_subset_stride=2)
    out_csv = str(tmp_path / "results.csv")
    argv = _replay_argv(fix, str(tmp_path / "work"), out_csv)
    replay_main(argv + ["--device", "cpu"])
    jout = str(tmp_path / "jax.csv")
    jax_replay_main(_replay_argv(fix, str(tmp_path / "jwork"), jout))

    rows = _rows(out_csv)
    names = [r["Model"] for r in rows]
    assert len(rows) == 7, names  # no external rerank API
    by_name = {r["Model"]: r for r in rows}
    for dense_cfg in ("Voyage-3-Large", "Text-Embedding-3-Large"):
        assert float(by_name[dense_cfg]["Recall@10"]) >= 0.5
    assert float(by_name["BM25"]["MRR"]) > 0.0
    assert float(by_name["Voyage-3-Large + BM25"]["Recall@10"]) >= (
        float(by_name["Voyage-3-Large"]["Recall@10"]) - 0.15)
    # The query split of the 60 queries: 51 evaluated.
    _same_csv(out_csv, jout, 51)
    # Re-running resumes: evaluated configurations are not duplicated.
    replay_main(argv + ["--device", "cpu"])
    assert len(_rows(out_csv)) == 7


# -- BM25 tuning and query prep ----------------------------------------------


def test_bm25_tuner_small():
    c = synth_corpus(n_docs=150, dim=8, n_queries=30, seed=81)
    rows = [{"id": c.ids[i], "tokens_regular": c.tokens[i],
             "tokens_lemmatized": c.tokens[i]} for i in range(len(c.ids))]
    qt = {"regular": c.query_tokens, "lemmatized": c.query_tokens}
    kw = dict(n_calls=12, n_initial=6, recall_k=15,
              test_query_tokens=qt, test_gold_ids=c.gold_ids)
    result = bm25_tune.tune_bm25(rows, qt, c.gold_ids, device=CPU, **kw)
    want = jax_tune.tune_bm25(rows, qt, c.gold_ids, **kw)
    assert result.history == want.history
    assert result.best_params == want.best_params
    assert result.best_score == want.best_score
    assert 0.5 <= result.best_params["k1"] <= 3.0
    assert result.best_score > 0.3
    assert len(result.history) == 13  # 12 calls + the final test row


def test_bm25_tuner_initial_calls_need_no_sklearn(monkeypatch):
    """With n_calls == n_initial no GP is fitted: the tuner must not
    import scikit-learn (the card's machine has none)."""
    import builtins

    real_import = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name.startswith("sklearn"):
            raise ImportError("no scikit-learn here")
        return real_import(name, *args, **kwargs)

    c = synth_corpus(n_docs=150, dim=8, n_queries=30, seed=81)
    rows = [{"id": c.ids[i], "tokens_regular": c.tokens[i],
             "tokens_lemmatized": c.tokens[i]} for i in range(len(c.ids))]
    qt = {"regular": c.query_tokens, "lemmatized": c.query_tokens}
    want = jax_tune.tune_bm25(rows, qt, c.gold_ids, n_calls=4, n_initial=4)
    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    got = bm25_tune.tune_bm25(rows, qt, c.gold_ids, n_calls=4, n_initial=4,
                              device=CPU)
    assert got.history == want.history and len(got.history) == 4


def test_query_prep_roundtrip(tmp_path):
    ids = [f"q{i}" for i in range(40)]
    queries = [f"What is the recommended dose of drug {i}?"
               for i in range(40)]
    rows = query_prep.preprocess_queries(ids, queries)
    assert rows == jax_query_prep.preprocess_queries(ids, queries)
    assert rows[0]["tokens_lemmatized"] == ["recommended", "dose", "drug"]
    rows_pl = query_prep.preprocess_queries(["p"], ["doses of drugs"])
    assert rows_pl[0]["tokens_lemmatized"] == ["dos", "drug"]
    test, val = query_prep.split_queries(rows)
    assert (test, val) == jax_query_prep.split_queries(rows)
    assert len(val) == 6 and len(test) == 34  # 15% of 40, seed 42
    assert {r["id"] for r in test} | {r["id"] for r in val} == set(ids)
    assert not ({r["id"] for r in test} & {r["id"] for r in val})
    p = os.path.join(tmp_path, "q.csv")
    query_prep.write_query_csv(rows, p)
    jp = os.path.join(tmp_path, "jq.csv")
    jax_query_prep.write_query_csv(rows, jp)
    assert open(p, "rb").read() == open(jp, "rb").read()
    with open(p) as f:
        back = list(csv.DictReader(f))
    assert len(back) == 40 and back[0]["id"] == "q0"


# -- the card ----------------------------------------------------------------


def test_entry_points_default_to_the_card(tmp_path):
    """The eval CLIs and the tuner default to the card; without one they
    raise instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists here")
    c = synth_corpus(n_docs=60, dim=8, n_queries=6, seed=5,
                     models=["voyage-3-large"])
    fix = write_reference_fixture(str(tmp_path / "ref"), c)
    idx = build_index(**_inputs(c), device=CPU)
    from a_nice_rag_tpu_torch.index import save_index

    save_index(idx, str(tmp_path / "ix"))
    rows = [{"id": c.ids[i], "tokens_regular": c.tokens[i],
             "tokens_lemmatized": c.tokens[i]} for i in range(len(c.ids))]
    qt = {"regular": c.query_tokens, "lemmatized": c.query_tokens}
    calls = {
        "run_retrieval_eval.main": lambda: eval_main(
            ["--index", str(tmp_path / "ix"), "--queries-db",
             f"voyage-3-large={fix.query_dbs['voyage-3-large']}",
             "--output", str(tmp_path / "a.csv")]),
        "replay_reference.main": lambda: replay_main(
            _replay_argv(fix, str(tmp_path / "w"), str(tmp_path / "b.csv"))),
        "tune_bm25": lambda: bm25_tune.tune_bm25(
            rows, qt, c.gold_ids, n_calls=2, n_initial=2),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA GPU is required"):
            call()
    assert not (tmp_path / "a.csv").exists()
    assert not (tmp_path / "w").exists()
