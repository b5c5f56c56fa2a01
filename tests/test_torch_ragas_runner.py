"""The port's evaluation runner (evals/run_ragas_eval.py) and synthetic
query generator (evals/question_gen.py) against the JAX package's.

Scripted chat clients and judges on both sides (the port's
``FakeLLMClient`` and the JAX package's, ``FakeJudgeLLM``, the hash-based
``FakeJudgeEmbeddings`` within this one process): the same chunk filter,
the same generated rows and prompts (temperature 0.7 included), the same
query databases, the same RAG answer rows, scores and aggregate CSV. The
port writes its per-sample CSV with the csv module; its header and its
cells, read back as values, equal the JAX package's pandas
``to_csv(index=False)``.
"""

import csv
import json
import math
import sqlite3

import numpy as np
import pytest

import a_nice_rag_tpu.evals.question_gen as jax_qg
import a_nice_rag_tpu.evals.run_ragas_eval as jax_run
import a_nice_rag_tpu_torch.evals.question_gen as qg
import a_nice_rag_tpu_torch.evals.run_ragas_eval as run
from a_nice_rag_tpu.config import InfoSource as JaxInfoSource
from a_nice_rag_tpu.evals import ragas as jax_ragas
from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.rag import FakeLLMClient as JaxFakeLLM
from a_nice_rag_tpu.rag import RAGSystem as JaxRAG
from a_nice_rag_tpu.retrieval.embed import PrecomputedEmbedder as JaxPre
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.config import InfoSource
from a_nice_rag_tpu_torch.evals import ragas
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.rag import FakeLLMClient, RAGSystem
from a_nice_rag_tpu_torch.retrieval.embed import PrecomputedEmbedder

CHUNKS = [
    {"title": "NG1_Recommendations", "source": "NG1", "content": "x" * 200},
    {"title": "NG1_Committee discussion", "source": "NG1",
     "content": "y" * 200},
    {"title": "QS9_Something", "source": "QS9", "content": "z" * 200},
    {"title": "CG2_Short", "source": "CG2", "content": "tiny"},
    {"title": "CG2_Appendix B", "source": "CG2", "content": "w" * 200},
    {"title": "CG2_Treatment", "source": "CG2", "content": "t ≥ 5 µg" * 40},
    {"title": "ng3_Context", "source": "ng3", "content": "c" * 150},
    {"title": "NG4_Update information", "source": "NG4",
     "content": "u" * 300},
    {"title": "CG5_Dosing", "source": "CG5", "content": "d" * 100},
    {"source": "NG6", "content": "untitled " * 20},
]


@pytest.mark.parametrize("kw", [
    {}, {"prefixes": ("NG",)}, {"min_chars": 150}, {"prefixes": ("QS",)},
])
def test_filter_chunks_equal(kw):
    ref = jax_qg.filter_chunks(CHUNKS, **kw)
    assert qg.filter_chunks(CHUNKS, **kw) == ref


class _Scripted:
    """A stream_chat client that records every call."""

    def __init__(self):
        self.calls = []

    def stream_chat(self, model, messages, temperature=0.0):
        self.calls.append((model, json.dumps(messages), temperature))
        content = messages[-1]["content"]
        yield "  Which dose " + str(len(content)) + "?"
        yield " \n"


def _db_rows(path):
    conn = sqlite3.connect(path)
    try:
        return conn.execute(
            "SELECT id, query, query_embedding FROM queries").fetchall()
    finally:
        conn.close()


def test_generate_questions_and_query_dbs_equal(tmp_path):
    # generate_questions keys its rows by title: the untitled chunk
    # only exercises the filter.
    kept = [c for c in qg.filter_chunks(CHUNKS) if "title" in c]
    ref_client, got_client = _Scripted(), _Scripted()
    ref = jax_qg.generate_questions(kept, ref_client, max_workers=3)
    got = qg.generate_questions(kept, got_client, max_workers=3)
    assert got == ref and len(got) == len(kept)
    assert sorted(got_client.calls) == sorted(ref_client.calls)
    assert {c[2] for c in got_client.calls} == {0.7}
    fake = [r["query"] for r in jax_qg.generate_questions(
        kept, JaxFakeLLM(lambda m: "What does it say?"))]
    assert [r["query"] for r in qg.generate_questions(
        kept, FakeLLMClient(lambda m: "What does it say?"))] == fake

    class Tiny:
        def embed_queries(self, texts):
            return np.stack([np.arange(8, dtype=np.float32) + len(t)
                             for t in texts])

    for name, mod in (("jax", jax_qg), ("port", qg)):
        mod.embed_and_store_queries(
            got, {"tiny/model": Tiny()},
            str(tmp_path / name / "{model}_queries.db"), batch_size=2)
        mod.write_query_db(str(tmp_path / name / "null.db"),
                           [{"id": "a", "query": "q"}])
    for db in ("tiny_model_queries.db", "null.db"):
        assert (_db_rows(tmp_path / "port" / db)
                == _db_rows(tmp_path / "jax" / db))
    assert _db_rows(tmp_path / "port" / "null.db") == [("a", "q", None)]


def _judge(prompt):
    if "self-contained statements" in prompt or "Decompose" in prompt:
        return json.dumps({"statements": ["s1", "s2 ≥ 5 µg"]})
    if "Judge each clinical statement" in prompt:
        return json.dumps({"verdicts": [
            {"statement": "s1", "reason": "r", "verdict": 1},
            {"statement": "s2", "reason": "r", "verdict": 0}]})
    return json.dumps({"question": "what about q0?",
                       "noncommittal": int("found" in prompt)})


def _rag_pair():
    c = synth_corpus(n_docs=100, dim=16, n_queries=3, seed=101)
    cols = dict(ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings=c.embeddings, token_lists=c.tokens)
    questions = ["what about q0?", "what about q1?", "what about q2?"]
    table = {q: c.query_embeddings["voyage-3-large"][i]
             for i, q in enumerate(questions)}

    def answer(messages):
        if "q2" in messages[-1]["content"]:
            return "No relevant NICE guidelines were found."
        return "An answer, with a comma and a \"quote\"."

    ref = JaxRAG(indexes={JaxInfoSource.NICE: jax_build_index(**cols)},
                 embedder=JaxPre(table),
                 llm_clients={"fake": JaxFakeLLM(answer)})
    got = RAGSystem(indexes={InfoSource.NICE: build_index(**cols,
                                                          device="cpu")},
                    embedder=PrecomputedEmbedder(table),
                    llm_clients={"fake": FakeLLMClient(answer)},
                    device="cpu")
    return ref, got, questions


def _read_csv(path):
    with open(path, encoding="utf-8", newline="") as f:
        return list(csv.reader(f))


def _cell(text):
    if text == "":
        return None
    try:
        value = float(text)
    except ValueError:
        return text
    return "nan" if math.isnan(value) else value


def test_collect_score_and_write_equal(tmp_path):
    ref_rag, got_rag, questions = _rag_pair()
    ref_rows = jax_run.collect_rag_answers(ref_rag, questions, "fake-llm",
                                           use_reranker=False)
    got_rows = run.collect_rag_answers(got_rag, questions, "fake-llm",
                                       use_reranker=False)
    assert got_rows == ref_rows
    assert len(got_rows[0]["retrieved_contexts"]) > 1
    baseline = [run.collect_baseline_answers(
        FakeLLMClient(lambda m: "Base."), questions, "fake-llm"),
        jax_run.collect_baseline_answers(
            JaxFakeLLM(lambda m: "Base."), questions, "fake-llm")]
    assert baseline[0] == baseline[1]

    ref = jax_run.score_rows(ref_rows, jax_ragas.FakeJudgeLLM(_judge),
                             jax_ragas.FakeJudgeEmbeddings(),
                             show_progress=False)
    got = run.score_rows(got_rows, ragas.FakeJudgeLLM(_judge),
                         ragas.FakeJudgeEmbeddings(), show_progress=False)
    assert got.scores == ref.scores
    assert got.aggregate() == ref.aggregate()
    assert got["answer_relevancy"][2] == 0.0

    # A NaN score reaches the per-sample CSV as an empty cell.
    got.scores[1]["faithfulness"] = float("nan")
    got._scores_dict["faithfulness"][1] = float("nan")
    ref._scores_dict["faithfulness"][1] = float("nan")
    for name, mod, result in (("jax", jax_run, ref), ("port", run, got)):
        for model in ("m1", "m2"):
            mod.write_results_csv(result, model,
                                  str(tmp_path / name / "agg.csv"),
                                  str(tmp_path / name / f"{model}.csv"))
    assert ((tmp_path / "port" / "agg.csv").read_bytes()
            == (tmp_path / "jax" / "agg.csv").read_bytes())
    ref_table = _read_csv(tmp_path / "jax" / "m1.csv")
    got_table = _read_csv(tmp_path / "port" / "m1.csv")
    assert got_table[0] == ref_table[0]
    assert len(got_table) == len(ref_table) == 4
    assert ([[_cell(c) for c in r] for r in got_table[1:]]
            == [[_cell(c) for c in r] for r in ref_table[1:]])
    assert got_table[2][ref_table[0].index("faithfulness")] == ""


def test_cli_main_equal(tmp_path, monkeypatch):
    """``main`` with its REST judge, embedder and RAG system swapped for
    scripted ones: the same flags give the same CSVs."""
    ref_rag, got_rag, questions = _rag_pair()
    qa = tmp_path / "qa.csv"
    with open(qa, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Guideline ID", "Section", "Question"])
        for i, q in enumerate(questions):
            w.writerow([f"NG{i}", "1.1", q])
    assert run.load_niceqa_csv(str(qa)) == jax_run.load_niceqa_csv(str(qa))
    for root, rag, name, mod in (
            ("a_nice_rag_tpu", ref_rag, "jax", jax_run),
            ("a_nice_rag_tpu_torch", got_rag, "port", run)):
        llm_mod = __import__(root + ".evals.ragas.llm", fromlist=["x"])
        fake = llm_mod.FakeJudgeLLM
        monkeypatch.setattr(llm_mod, "OpenAICompatJudgeLLM",
                            lambda model: fake(_judge))
        embed = __import__(root + ".retrieval.embed", fromlist=["x"])
        emb_mod = __import__(root + ".evals.ragas.embeddings",
                             fromlist=["x"])
        monkeypatch.setattr(
            emb_mod, "EmbedderJudgeEmbeddings",
            lambda e: emb_mod.FakeJudgeEmbeddings())
        monkeypatch.setattr(embed, "OpenAIEmbedder", lambda model: None)
        rag_mod = __import__(root + ".rag", fromlist=["x"])
        monkeypatch.setattr(rag_mod, "RAGSystem",
                            lambda *a, _rag=rag, **k: _rag)
        argv = ["--qa-csv", str(qa), "--llm-model", "fake-llm",
                "--output", str(tmp_path / name / "agg.csv"),
                "--per-sample-output", str(tmp_path / name / "rows.csv")]
        mod.main(argv + (["--device", "cpu"] if name == "port" else []))
    assert ((tmp_path / "port" / "agg.csv").read_bytes()
            == (tmp_path / "jax" / "agg.csv").read_bytes())
    assert (_read_csv(tmp_path / "port" / "rows.csv")
            == _read_csv(tmp_path / "jax" / "rows.csv"))
