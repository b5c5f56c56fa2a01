"""The port's RAG orchestration (``rag/``) and tracing (``utils/trace``)
against the JAX package's, on the CPU.

One JAX-built index is carried to the port by ``index/convert.py``
(``from_reference_index``); both ``RAGSystem``s take the same
precomputed query embeddings, the identity reranker and a
``FakeLLMClient``. Tolerance: the streamed (chunk, sources,
raw_sections, sources_data) tuples equal, and the messages sent to the
LLM equal. The cases mirror ``tests/test_rag.py`` (9), plus the stream
under more settings, the profiler trace and the default device.
"""

import json

import numpy as np
import pytest
import torch

from a_nice_rag_tpu.config import InfoSource as JaxInfoSource
from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.rag import FakeLLMClient as JaxFake
from a_nice_rag_tpu.rag import RAGSystem as JaxRAGSystem
from a_nice_rag_tpu.rag import prompts as jax_prompts
from a_nice_rag_tpu.rag import route_model as jax_route_model
from a_nice_rag_tpu.retrieval.embed import (
    PrecomputedEmbedder as JaxPrecomputed,
)
from a_nice_rag_tpu.retrieval.rerank import IdentityReranker as JaxIdentity
from a_nice_rag_tpu_torch.config import Config, InfoSource
from a_nice_rag_tpu_torch.index import from_reference_index, save_index
from a_nice_rag_tpu_torch.rag import (
    FakeLLMClient,
    RAGSystem,
    build_context_text,
    build_default_clients,
    clean_section_id,
    prompts,
    route_model,
)
from a_nice_rag_tpu_torch.rag import system as rag_system
from a_nice_rag_tpu_torch.rag.prompts import (
    NOT_FOUND_SENTENCE,
    build_chat_messages,
)
from a_nice_rag_tpu_torch.retrieval.embed import PrecomputedEmbedder
from a_nice_rag_tpu_torch.retrieval.rerank import IdentityReranker
from a_nice_rag_tpu_torch.testing import synth_corpus
from a_nice_rag_tpu_torch.utils.trace import QueryTrace, device_profile

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rag():
    c = synth_corpus(n_docs=200, dim=32, n_queries=8, seed=61)
    jidx = jax_build_index(
        ids=c.ids, sources=c.sources, contents=c.contents, urls=c.urls,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    queries = [f"question {i}" for i in range(8)]
    table = {q: c.query_embeddings["voyage-3-large"][i]
             for i, q in enumerate(queries)}
    fake, jfake = FakeLLMClient(), JaxFake()
    system = RAGSystem(
        indexes={InfoSource.NICE: from_reference_index(jidx, device=CPU)},
        embedder=PrecomputedEmbedder(table),
        reranker=IdentityReranker(),
        llm_clients={"fake": fake},
        device="cpu",
    )
    jsystem = JaxRAGSystem(
        indexes={JaxInfoSource.NICE: jidx},
        embedder=JaxPrecomputed(table),
        reranker=JaxIdentity(),
        llm_clients={"fake": jfake},
    )
    return c, system, jsystem, queries, fake, jfake


def _both_streams(rag, *args, **kwargs):
    _, system, jsystem, _, fake, jfake = rag
    got = list(system.query_rag_stream(*args, **kwargs))
    want = list(jsystem.query_rag_stream(*args, **kwargs))
    assert got == want
    assert fake.calls[-1:] == jfake.calls[-1:]
    return got


def test_stream_contract(rag):
    c, system, _, queries, fake, _ = rag
    out = _both_streams(rag, queries[0], "fake-llm", use_hybrid_search=True,
                        use_reranker=True)
    chunks = [o[0] for o in out]
    _, sources, raw, s_data = out[-1]
    answer = "".join(chunks)
    assert answer.startswith("[fake:fake-llm]")
    assert len(chunks) > 1, "must stream in deltas"
    assert c.gold_ids[0] in (d["section_id"] for d in s_data)
    assert "- Section" in sources
    assert "--- Context Chunk ---" in raw
    sent = fake.calls[-1]["messages"]
    assert sent[0]["role"] == "system"
    assert NOT_FOUND_SENTENCE in sent[0]["content"]
    assert "Source Information: [Identifier:" in sent[1]["content"]
    assert queries[0] in sent[1]["content"]


@pytest.mark.parametrize("kwargs", [
    dict(use_hybrid_search=False, use_reranker=False),
    dict(use_hybrid_search=True, use_reranker=False,
         filename_type_filter="CG,NG", similarity_k=10,
         common_sections_n=5),
    dict(use_hybrid_search=True, use_reranker=True, reranker_top_k=3,
         wrrf_k=60.0),
], ids=["dense", "hybrid_filtered", "rerank_top3"])
def test_stream_matches_jax(rag, kwargs):
    _, _, _, queries, _, _ = rag
    for q in queries[3:6]:
        out = _both_streams(rag, q, "fake-llm", **kwargs)
        assert out and out[0][0].startswith("[fake")


def test_stream_with_per_model_embeddings_matches_jax(rag):
    c, _, _, queries, _, _ = rag
    emb = {"voyage-3-large": c.query_embeddings["voyage-3-large"][6]}
    out = _both_streams(rag, queries[6], "fake-llm", use_hybrid_search=True,
                        use_reranker=False, query_embedding=emb,
                        model_weights={"voyage-3-large": 5.0, "BM25": 1.0})
    assert c.gold_ids[6] in (d["section_id"] for d in out[-1][3])


def test_validation_errors(rag):
    _, system, _, queries, _, _ = rag
    with pytest.raises(ValueError, match="empty"):
        list(system.query_rag_stream("  ", "fake"))
    with pytest.raises(ValueError, match="similarity_k"):
        list(system.query_rag_stream("q", "fake", similarity_k=0))
    with pytest.raises(ValueError, match="common_sections_n"):
        list(system.query_rag_stream("q", "fake", common_sections_n=0))
    with pytest.raises(ValueError, match="info_source"):
        list(system.query_rag_stream(queries[0], "fake", info_source="bogus"))


def test_unrouted_model_yields_error(rag):
    _, _, _, queries, _, _ = rag
    out = _both_streams(rag, queries[0], "some-unknown-model")
    assert len(out) == 1
    assert "Unsupported LLM model" in out[0][0]


def test_routing_table():
    clients = {"openai": "O", "gemini": "G", "openrouter": "R", "fake": "F",
               "local": "L"}
    for name in ("gpt-4.1-mini", "gpt-5-turbo", "o4-mini", "gemini-2.5-flash",
                 "claude-sonnet-4", "fake-echo", "mystery-model",
                 "local-decoder", "tpu-lm"):
        assert route_model(name, clients) == jax_route_model(name, clients)
    assert route_model("gpt-4.1-mini", clients)[0] == "O"
    assert route_model("gpt-5-turbo", clients)[1] == {
        "reasoning_effort": "minimal"}
    assert route_model("o4-mini", clients) == ("O", {})
    assert route_model("gemini-2.5-flash", clients)[0] == "G"
    assert route_model("claude-sonnet-4", clients)[0] == "R"
    assert route_model("fake-echo", clients)[0] == "F"
    assert route_model("local-decoder", clients)[0] == "L"
    assert route_model("mystery-model", clients) is None
    assert route_model("claude-sonnet-4", {"openai": "O"}) is None
    env = {"OPENAI_API_KEY": "k", "OPENROUTER_API_KEY": "r"}
    assert sorted(build_default_clients(env)) == ["openai", "openrouter"]
    assert build_default_clients({}) == {}


def test_clean_section_id():
    for sid, src in (("NG136_Treatment_of_adults", "NG136"),
                     ("Other  thing", "NG1"), ("", "NG1"),
                     ("Unknown section", "x")):
        assert clean_section_id(sid, src) == jax_prompts.clean_section_id(
            sid, src)
    assert clean_section_id("NG136_Treatment_of_adults", "NG136") == (
        "Treatment of adults")
    assert clean_section_id("Other  thing", "NG1") == "Other thing"
    assert clean_section_id("", "NG1") == ""


def test_context_text_format():
    docs = [
        {"id": "CG1_Intro", "source": "CG1", "document": "text one",
         "url": "u1"},
        {"id": "CG2_Scope", "source": "CG2", "document": "text two"},
    ]
    ctx, raw = build_context_text(docs)
    assert (ctx, raw) == jax_prompts.build_context_text(docs)
    assert ctx.count("Source Information: [Identifier:") == 2
    assert "\n\n---\n\n" in ctx
    assert raw == "text one\n\n--- Context Chunk ---\n\ntext two"
    assert build_chat_messages(ctx, "q?") == jax_prompts.build_chat_messages(
        ctx, "q?")
    assert prompts.sources_string(docs) == jax_prompts.sources_string(docs)
    assert prompts.sources_data(docs) == jax_prompts.sources_data(docs)


def test_trace_recorded(rag):
    _, system, _, queries, _, _ = rag
    list(system.query_rag_stream(queries[1], "fake-llm"))
    t = system.last_trace
    assert "retrieval" in t.durations and "llm" in t.durations
    d = t.to_dict()
    assert d["name"] == "query" and d["inputs"]["query"] == queries[1]
    assert {c["name"] for c in d["children"]} >= {"retrieval", "llm"}
    assert all(c["parent_id"] == d["run_id"] for c in d["children"])
    trace = QueryTrace("q")
    with trace.span("outer"):
        with trace.span("inner", k=3) as run:
            pass
    assert run.inputs == {"k": 3}
    outer = trace.to_dict()["children"][0]
    assert outer["children"][0]["name"] == "inner"
    assert trace.durations["outer"] >= trace.durations["inner"] >= 0.0


def test_bm25_only_weights(rag):
    _, _, _, queries, _, _ = rag
    out = _both_streams(
        rag, queries[2], "fake-llm",
        model_weights={"voyage-3-large": 0.0, "BM25": 1.0},
        use_hybrid_search=True, use_reranker=False,
    )
    # BM25 through query-text preprocessing; still streams.
    assert out and out[0][0]


def test_multi_model_query_embedding_contract(rag):
    """A single embedding array cannot serve 2+ active dense models; a
    per-model dict (the reference's query_embeddings contract) can."""
    c, system, _, queries, _, _ = rag
    idx = system.indexes[InfoSource.NICE]
    rng = np.random.default_rng(9)
    idx.dense["voyage-3.5"] = torch.as_tensor(
        rng.standard_normal((idx.n_docs_padded, 16)).astype(np.float32))
    try:
        weights = {"voyage-3-large": 1.0, "voyage-3.5": 1.0}
        q32 = c.query_embeddings["voyage-3-large"][0]
        with pytest.raises(ValueError, match="embedding spaces"):
            system.retrieve_for_query(
                queries[0], InfoSource.NICE, 5, 5, 40.0, weights, None,
                False, False, "rerank-2", None, query_embedding=q32,
            )
        q16 = rng.standard_normal(16).astype(np.float32)
        docs = system.retrieve_for_query(
            queries[0], InfoSource.NICE, 5, 5, 40.0, weights, None,
            False, False, "rerank-2", None,
            query_embedding={"voyage-3-large": q32, "voyage-3.5": q16},
        )
        assert docs, "dict-contract retrieval returned nothing"
        docs2 = system.retrieve_for_query(
            queries[0], InfoSource.NICE, 5, 5, 40.0, weights, None,
            False, False, "rerank-2", None,
            query_embedding={"voyage-3.5": q16},
        )
        assert docs2
    finally:
        del idx.dense["voyage-3.5"]


def test_device_profile_exports_a_chrome_trace(rag, tmp_path):
    """The profiler trace around one query: a Chrome trace in the log
    directory holding the host's operator events (the card's kernel
    events join them on a GPU; chip_smoke.py counts those)."""
    _, system, _, queries, _, _ = rag
    with device_profile(str(tmp_path / "prof")) as prof:
        out = list(system.query_rag_stream(queries[4], "fake-llm",
                                           use_hybrid_search=True,
                                           use_reranker=False))
    assert out
    assert prof.trace_path == str(tmp_path / "prof" / "trace.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert any(e["name"] == "aten::matmul" for e in ops), \
        sorted({e["name"] for e in ops})[:20]


def test_main_streams_one_query(monkeypatch, capsys, tmp_path, rag):
    """The CLI demo on the CPU: the artifact at the source's index_path,
    no provider keys, so the offline fake client answers."""
    c, system, _, _, _, _ = rag
    path = str(tmp_path / "nice_index")
    save_index(system.indexes[InfoSource.NICE], path)
    cfg = Config.SOURCE_CONFIGS[InfoSource.NICE]
    monkeypatch.setattr(cfg, "index_path", path)
    for key in ("OPENAI_API_KEY", "GEMINI_API_KEY", "ANTHROPIC_API_KEY",
                "OPENROUTER_API_KEY"):
        monkeypatch.delenv(key, raising=False)
    rag_system.main(["--query", " ".join(c.query_tokens[0]), "--hybrid",
                     "--no-rerank", "--filter", "", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== Sources ===" in out and "[fake:fake-llm]" in out
    assert "- Section" in out


def test_entry_points_default_to_the_card():
    """RAGSystem and its CLI default to the card; without one they raise
    instead of quietly loading the artifacts onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists here")
    with pytest.raises(RuntimeError, match="CUDA GPU is required"):
        RAGSystem(indexes={}, llm_clients={})
    with pytest.raises(RuntimeError, match="CUDA GPU is required"):
        RAGSystem(llm_clients={})
    with pytest.raises(RuntimeError, match="CUDA GPU is required"):
        rag_system.main(["--query", "q"])


def test_stage_a_words_survive_preprocessing():
    """chip_smoke.py's RAG queries are texts of stage A's vocabulary words
    (2^17 terms); preprocess_text, which SearchEngine runs on a query
    text, must hand every word back unchanged, or BM25's half of the
    hybrid would lose terms."""
    import chip_smoke
    from a_nice_rag_tpu_torch.text import preprocess_text

    words = [chip_smoke.stage_a_word(v) for v in range(1 << 17)]
    assert len(set(words)) == len(words)
    assert preprocess_text(" ".join(words), use_lemmatization=True) == words
    assert preprocess_text(" ".join(words)) == words
