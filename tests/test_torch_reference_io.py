"""The port's reference-format importers, IndexManager, synthetic corpora,
fixture writer, BM25 build and the import CLI against the JAX package's,
on the CPU.

The same seeded ``synth_corpus`` (numpy draws, identical in both
packages) goes through both packages' functions. Tolerances:

- imported BM25 arrays (``indptr``, ``doc_ids``, ``impact``) and doc
  masks ``np.array_equal`` to the JAX importer's: the impacts are formed
  in float64 and cast to float32 on the host in both packages;
- dense matrices read from chunk DBs ``np.array_equal`` (the float32
  blobs are copied, not recomputed);
- BM25 scores from the imported arrays within rtol 1e-6 / atol 1e-7 of
  the golden rank_bm25 scores, as in the JAX package's tests;
- synthetic corpora byte-identical (same numpy draws in the same order).

The cases mirror ``tests/test_bm25_pickle_import.py`` (4),
``tests/test_index.py``'s ``test_reference_sqlite_import`` and
``test_index_manager_memoizes``, and ``tests/test_ingest.py``'s
``test_preprocess_chunks_and_csv_roundtrip``, plus the row remap at
strides 1 and 3, the cross-read of each package's fixture by the other
package, and the entry points' default device.
"""

import json
import os
import pickle
import sqlite3
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_bm25_arrays as jax_build_bm25_arrays
from a_nice_rag_tpu.index import io as jax_io
from a_nice_rag_tpu.ingest import bm25_build as jax_bm25_build
from a_nice_rag_tpu.ingest import import_reference as jax_import
from a_nice_rag_tpu.testing import reference_fixture as jax_fixture
from a_nice_rag_tpu.testing import synth as jax_synth
from a_nice_rag_tpu_torch.index import (
    build_bm25_arrays,
    build_index,
    load_index,
    save_index,
)
from a_nice_rag_tpu_torch.index import io as port_io
from a_nice_rag_tpu_torch.index.manager import IndexManager, add_url_column
from a_nice_rag_tpu_torch.ingest import bm25_build
from a_nice_rag_tpu_torch.ingest import import_reference
from a_nice_rag_tpu_torch.ops.bm25 import bm25_scores
from a_nice_rag_tpu_torch.testing import (
    GoldenBm25Okapi,
    reference_fixture,
    synth,
    synth_corpus,
)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _np(t):
    return np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _bm25_equal(port_arrays, jax_arrays):
    for name in ("indptr", "doc_ids", "impact"):
        got, want = _np(getattr(port_arrays, name)), _np(
            getattr(jax_arrays, name))
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    assert port_arrays.n_docs_padded == jax_arrays.n_docs_padded


def _make_reference_pickle(tmp_path, corpus_tokens, ids, sources, contents):
    """Pickle {bm25, sections, section_ids, config} with objects whose
    classes claim to live in rank_bm25 / langchain, as the reference's
    artifact does (the same construction as the JAX package's test)."""
    golden = GoldenBm25Okapi(corpus_tokens, k1=1.7, b=0.83, epsilon=0.05)

    rank_mod = types.ModuleType("rank_bm25")

    class BM25Okapi:
        pass

    BM25Okapi.__module__ = "rank_bm25"
    BM25Okapi.__qualname__ = "BM25Okapi"
    rank_mod.BM25Okapi = BM25Okapi

    lc_doc_mod = types.ModuleType("langchain.schema.document")

    class Document:
        def __init__(self, page_content, metadata):
            self.page_content = page_content
            self.metadata = metadata

    Document.__module__ = "langchain.schema.document"
    Document.__qualname__ = "Document"
    lc_doc_mod.Document = Document

    bm25 = BM25Okapi()
    bm25.idf = golden.idf
    bm25.doc_freqs = golden.doc_freqs
    bm25.doc_len = list(map(int, golden.doc_len))
    bm25.avgdl = golden.avgdl
    bm25.corpus_size = golden.corpus_size
    bm25.k1, bm25.b, bm25.epsilon = 1.7, 0.83, 0.05
    sections = [
        Document(contents[i], {"id": ids[i], "source": sources[i]})
        for i in range(len(ids))
    ]
    payload = {
        "bm25": bm25,
        "sections": sections,
        "section_ids": list(ids),
        "config": {"k1": 1.7, "b": 0.83, "epsilon": 0.05},
    }
    mods = {
        "rank_bm25": rank_mod,
        "langchain": types.ModuleType("langchain"),
        "langchain.schema": types.ModuleType("langchain.schema"),
        "langchain.schema.document": lc_doc_mod,
    }
    sys.modules.update(mods)
    try:
        path = str(tmp_path / "bm25_index.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
    finally:
        for name in mods:
            del sys.modules[name]
    return path, golden


def _write_chunk_db(path, c, model="voyage-3-large", rows=None, url=True):
    rows = range(len(c.ids)) if rows is None else rows
    conn = sqlite3.connect(path)
    conn.execute(
        "CREATE TABLE chunks (id TEXT PRIMARY KEY, content TEXT, "
        "source TEXT, embedding BLOB" + (", url TEXT)" if url else ")"))
    emb = c.embeddings[model]
    for i in rows:
        vals = (c.ids[i], c.contents[i], c.sources[i],
                emb[i].astype(np.float32).tobytes())
        conn.execute(
            "INSERT INTO chunks VALUES (?,?,?,?" + (",?)" if url else ")"),
            vals + ((c.urls[i],) if url else ()))
    conn.commit()
    conn.close()


def _term_batch(vocab, token_lists, t_max=16):
    terms = np.full((len(token_lists), t_max), -1, np.int32)
    for i, toks in enumerate(token_lists):
        tids = [vocab.get(t, -1) for t in toks[:t_max]]
        terms[i, : len(tids)] = tids
    return torch.as_tensor(terms)


# -- the BM25 pickle ---------------------------------------------------------


def test_import_reference_pickle_exact_scores(tmp_path):
    c = synth_corpus(n_docs=120, dim=8, n_queries=8, seed=191)
    path, golden = _make_reference_pickle(
        tmp_path, c.tokens, c.ids, c.sources, c.contents)
    with pytest.raises(ImportError):
        import rank_bm25  # noqa: F401

    arrays, vocab, stats, section_ids, contents, sources = (
        port_io.load_reference_bm25_pickle(path, device=CPU))
    j_arrays, j_vocab, j_stats, *_ = jax_io.load_reference_bm25_pickle(path)
    _bm25_equal(arrays, j_arrays)
    assert vocab == j_vocab and stats == j_stats
    assert section_ids == c.ids and contents == c.contents
    assert sources == c.sources
    assert stats["k1"] == 1.7 and stats["corpus_size"] == 120
    assert arrays.indptr.device == CPU

    scores = bm25_scores(arrays, _term_batch(vocab, c.query_tokens),
                         budget=4096).numpy()
    for i, toks in enumerate(c.query_tokens):
        expect = golden.get_scores(toks[:16])
        np.testing.assert_allclose(scores[i, : len(expect)], expect,
                                   rtol=1e-6, atol=1e-7)


def test_full_reference_migration_cli(tmp_path):
    """chunk DB + pickle (its own doc ordering and subset) -> artifact,
    equal to the JAX package's import and to golden scores on the
    chunk-DB row space."""
    c = synth_corpus(n_docs=90, dim=16, n_queries=6, seed=193)
    db = str(tmp_path / "chunks.db")
    _write_chunk_db(db, c)
    sub = list(range(89, 4, -1))  # reversed subset: exercises the remap
    pkl, golden = _make_reference_pickle(
        tmp_path,
        [c.tokens[i] for i in sub], [c.ids[i] for i in sub],
        [c.sources[i] for i in sub], [c.contents[i] for i in sub])
    out = str(tmp_path / "artifact")
    import_reference.main(["--chunk-db", f"voyage-3-large={db}",
                           "--bm25-pickle", pkl, "--output", out,
                           "--device", "cpu"])
    idx = load_index(out, device=CPU)
    jidx = jax_import.assemble_index_from_reference(
        {"voyage-3-large": db}, pkl)
    assert idx.n_docs == 90 == jidx.n_docs
    assert idx.meta.ids == jidx.meta.ids and idx.meta.urls == jidx.meta.urls
    _bm25_equal(idx.bm25, jidx.bm25)
    assert np.array_equal(idx.bm25_doc_mask, jidx.bm25_doc_mask)
    assert np.array_equal(_np(idx.dense["voyage-3-large"]),
                          _np(jidx.dense["voyage-3-large"]))
    assert np.array_equal(_np(idx.bm25_dense.impact),
                          _np(jidx.bm25_dense.impact))
    assert idx.bm25_doc_mask[:5].sum() == 0  # not in the pickle
    toks = c.query_tokens[0][:16]
    scores = bm25_scores(idx.bm25, _term_batch(idx.vocab, [toks]),
                         budget=4096)[0].numpy()
    expect = golden.get_scores(toks)
    for j, row in enumerate(sub):
        np.testing.assert_allclose(scores[row], expect[j], rtol=1e-6,
                                   atol=1e-7)


def test_unpickler_stubs_malicious_globals(tmp_path):
    """The port's BM25-pickle importer never resolves an importable
    callable outside the allowlist: a REDUCE on os.system becomes an
    inert stub."""
    proof = tmp_path / "pwned_proof"

    class Evil:
        def __reduce__(self):
            return (os.system, (f"echo pwned > {proof}",))

    p = tmp_path / "evil.pkl"
    with open(p, "wb") as f:
        pickle.dump({"bm25": Evil()}, f)
    with open(p, "rb") as f:
        out = port_io._StubUnpickler(f).load()
    assert not proof.exists(), "REDUCE payload executed!"
    assert isinstance(out["bm25"], port_io._StubObject)
    payload = {"a": np.arange(3), "b": {1, 2}, "c": [np.float64(2.5)]}
    p2 = tmp_path / "ok.pkl"
    with open(p2, "wb") as f:
        pickle.dump(payload, f)
    with open(p2, "rb") as f:
        back = port_io._StubUnpickler(f).load()
    np.testing.assert_array_equal(back["a"], payload["a"])
    assert back["b"] == {1, 2} and float(back["c"][0]) == 2.5
    assert port_io._SAFE_GLOBALS == jax_io._SAFE_GLOBALS
    assert port_io._SAFE_NUMPY_NAMES == jax_io._SAFE_NUMPY_NAMES
    assert port_io._SAFE_NUMPY_MODULES == jax_io._SAFE_NUMPY_MODULES


def test_load_index_rejects_wrong_format_version(tmp_path):
    c = synth_corpus(n_docs=50, dim=16, n_queries=2, seed=5)
    idx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                      embeddings=c.embeddings, token_lists=c.tokens,
                      device=CPU)
    path = str(tmp_path / "ix")
    save_index(idx, path)
    with open(f"{path}/meta.json") as f:
        meta = json.load(f)
    meta["format_version"] = 99
    with open(f"{path}/meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="format_version"):
        load_index(path, device=CPU)


# -- SQLite chunk and query DBs ---------------------------------------------


def test_reference_sqlite_import(tmp_path):
    c = synth_corpus(n_docs=12, dim=8, seed=25)
    db = os.path.join(tmp_path, "chunks.db")
    _write_chunk_db(db, c)
    got = port_io.load_reference_chunk_db(db)
    want = jax_io.load_reference_chunk_db(db)
    assert got[:4] == want[:4] and got[0] == c.ids
    assert np.array_equal(got[4], want[4]) and got[4].dtype == np.float32
    np.testing.assert_array_equal(got[4], c.embeddings["voyage-3-large"])

    nourl = os.path.join(tmp_path, "nourl.db")
    _write_chunk_db(nourl, c, url=False)
    assert port_io.load_reference_chunk_db(nourl)[3] == ["Unknown"] * 12

    qdb = os.path.join(tmp_path, "queries.db")
    conn = sqlite3.connect(qdb)
    conn.execute(
        "CREATE TABLE queries (id TEXT, query TEXT, query_embedding BLOB)")
    qe = c.query_embeddings["voyage-3-large"]
    conn.execute("INSERT INTO queries VALUES (?,?,?)",
                 ("q0", "a question", qe[0].astype(np.float32).tobytes()))
    conn.execute("INSERT INTO queries VALUES (?,?,NULL)", ("q1", "skipped"))
    conn.commit()
    conn.close()
    qids, qtexts, qemb = port_io.load_reference_query_db(qdb)
    jids, jtexts, jemb = jax_io.load_reference_query_db(qdb)
    assert qids == jids == ["q0"] and qtexts == jtexts
    assert np.array_equal(qemb, jemb)
    np.testing.assert_array_equal(qemb[0], qe[0])


def test_index_manager_memoizes(tmp_path):
    c = synth_corpus(n_docs=20, dim=8, seed=29)
    idx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                      urls=c.urls, embeddings=c.embeddings,
                      token_lists=c.tokens, device=CPU)
    path = os.path.join(tmp_path, "artifact")
    save_index(idx, path)
    mgr = IndexManager(device="cpu")
    a = mgr.load_artifact(path)
    assert mgr.load_artifact(path) is a
    assert a.device == CPU and a.meta.ids == c.ids
    mgr.invalidate(path)
    assert mgr.load_artifact(path) is not a

    db = os.path.join(tmp_path, "chunks.db")
    _write_chunk_db(db, c)
    rows = mgr.load_chunk_db(db)
    assert mgr.load_chunk_db(db) is rows and rows[0] == c.ids
    mgr.invalidate()
    assert mgr.load_chunk_db(db) is not rows

    # url migration on a reference-format DB without the url column
    nourl = os.path.join(tmp_path, "nourl.db")
    conn = sqlite3.connect(nourl)
    conn.execute("CREATE TABLE chunks (id TEXT PRIMARY KEY, content TEXT, "
                 "source TEXT, embedding BLOB)")
    conn.execute("INSERT INTO chunks VALUES ('a','x','NG1',NULL)")
    conn.commit()
    conn.close()
    assert add_url_column(nourl) == 1
    assert add_url_column(nourl) == 0  # idempotent
    conn = sqlite3.connect(nourl)
    url = conn.execute("SELECT url FROM chunks").fetchone()[0]
    conn.close()
    assert url == "https://www.nice.org.uk/guidance/ng1"


# -- BM25 build and the row remap -------------------------------------------


def test_preprocess_chunks_and_csv_roundtrip(tmp_path):
    chunks = [
        {"title": "NG1_A", "source": "NG1",
         "content": "Patients with diabetes need regular reviews."},
        {"title": "", "source": "NG1", "content": "skipped"},
        {"title": "NG1_B", "source": "NG1",
         "content": "Children's doses of drugs, reviewed yearly."},
    ]
    rows = bm25_build.preprocess_chunks(chunks)
    assert rows == jax_bm25_build.preprocess_chunks(chunks)
    assert len(rows) == 2
    assert "diabetes" in rows[0]["tokens_lemmatized"]
    assert "patient" in rows[0]["tokens_lemmatized"]  # lemmatized
    path = os.path.join(tmp_path, "tokens.csv")
    bm25_build.write_tokens_csv(rows, path)
    jpath = os.path.join(tmp_path, "tokens_jax.csv")
    jax_bm25_build.write_tokens_csv(rows, jpath)
    assert Path(path).read_bytes() == Path(jpath).read_bytes()
    back = bm25_build.read_tokens_csv(path)
    assert back == jax_bm25_build.read_tokens_csv(path)
    assert back[0]["tokens_lemmatized"] == rows[0]["tokens_lemmatized"]
    for lem in (True, False):
        got = bm25_build.build_bm25_component(rows, 128, use_lemmatized=lem,
                                              device=CPU)
        want = jax_bm25_build.build_bm25_component(rows, 128,
                                                   use_lemmatized=lem)
        _bm25_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("stride", [1, 3])
def test_remap_bm25_rows_matches_jax(stride):
    """The pickle's rows (every ``stride``-th doc, in reverse) renumbered
    onto a chunk-DB row space, some dropped."""
    c = synth_corpus(n_docs=130, dim=8, n_queries=2, seed=197)
    keep = list(range(len(c.ids) - 1, -1, -stride))
    toks = [c.tokens[i] for i in keep]
    arrays, _, _ = build_bm25_arrays(toks, 256, device=CPU)
    row_map = np.array([r if r % 7 else -1 for r in keep], np.int64)
    got = import_reference.remap_bm25_rows(arrays, row_map, 256)
    j_arrays, _, _ = jax_build_bm25_arrays(toks, 256)
    want = jax_import.remap_bm25_rows(j_arrays, row_map, 256)
    _bm25_equal(got, want)
    assert got.indptr.device == CPU
    assert int(got.doc_ids[-1]) == 256
    kept_rows = set(_np(got.doc_ids)[:-1].tolist())
    assert kept_rows <= {int(r) for r in row_map if r >= 0}


# -- synthetic corpora and fixtures -----------------------------------------


def test_calibrated_corpus_and_distractors_match_jax():
    kw = dict(n_docs=300, dim=16, n_queries=40, vocab_size=500, seed=42)
    got = synth.add_hard_distractors(
        synth.calibrated_quality_corpus(**kw), n_per_gold=2, emb_cos=0.90,
        token_overlap=0.65)
    want = jax_synth.add_hard_distractors(
        jax_synth.calibrated_quality_corpus(**kw), n_per_gold=2,
        emb_cos=0.90, token_overlap=0.65)
    for field in ("ids", "sources", "contents", "urls", "tokens",
                  "query_tokens", "gold_ids", "query_texts"):
        assert getattr(got, field) == getattr(want, field), field
    for name in ("embeddings", "query_embeddings"):
        g, w = getattr(got, name), getattr(want, name)
        assert list(g) == list(w)
        for m in g:
            assert g[m].dtype == w[m].dtype and np.array_equal(g[m], w[m])
    assert synth.REFERENCE_QUALITY_NOISE == jax_synth.REFERENCE_QUALITY_NOISE
    assert len(got.ids) > 300  # distractors appended
    for a, b in zip(synth.calibrated_sample_queries(got, 12, 500, seed=3),
                    jax_synth.calibrated_sample_queries(want, 12, 500,
                                                        seed=3)):
        if isinstance(a, dict):
            assert all(np.array_equal(a[m], b[m]) for m in a)
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b


def _fixture_corpus():
    return synth_corpus(n_docs=150, dim=16, n_queries=6, seed=13,
                        models=["voyage-3-large", "voyage-3.5"])


def test_fixture_pickle_round_trips_exact_scores(tmp_path):
    """The port-written fixture's pickle imports with golden scores, and
    its DBs and CSV hold what the JAX package's writer writes."""
    c = _fixture_corpus()
    fix = reference_fixture.write_reference_fixture(str(tmp_path / "p"), c)
    jfix = jax_fixture.write_reference_fixture(str(tmp_path / "j"), c)
    assert list(fix.chunk_dbs) == list(jfix.chunk_dbs)
    for m in fix.chunk_dbs:
        got = port_io.load_reference_chunk_db(fix.chunk_dbs[m])
        want = port_io.load_reference_chunk_db(jfix.chunk_dbs[m])
        assert got[:4] == want[:4] and np.array_equal(got[4], want[4])
        got = port_io.load_reference_query_db(fix.query_dbs[m])
        want = port_io.load_reference_query_db(jfix.query_dbs[m])
        assert got[:2] == want[:2] and np.array_equal(got[2], want[2])
    # The port writes plain-str literals; the JAX package's writer emits
    # numpy 2's np.str_('...') reprs, which its own reader cannot parse.
    assert port_io.load_preprocessed_tokens_csv(fix.bm25_queries_csv) == {
        g: [str(t) for t in toks]
        for g, toks in zip(c.gold_ids, c.query_tokens)}

    arrays, vocab, stats, section_ids, _, _ = \
        port_io.load_reference_bm25_pickle(fix.bm25_pickle, device=CPU)
    assert section_ids == c.ids
    golden = GoldenBm25Okapi(c.tokens, k1=1.7, b=0.83, epsilon=0.05)
    for qi in range(3):
        toks = c.query_tokens[qi]
        got = bm25_scores(arrays, _term_batch(vocab, [toks]))[0][: len(c.ids)]
        np.testing.assert_allclose(got.numpy(), golden.get_scores(toks),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 3])
def test_fixture_cross_read(tmp_path, stride):
    """The port imports a JAX-written fixture and the JAX package imports
    a port-written one: the assembled indexes are equal either way."""
    c = _fixture_corpus()
    jfix = jax_fixture.write_reference_fixture(str(tmp_path / "j"), c,
                                               bm25_subset_stride=stride)
    pfix = reference_fixture.write_reference_fixture(
        str(tmp_path / "p"), c, bm25_subset_stride=stride)
    for fix in (jfix, pfix):
        got = import_reference.assemble_index_from_reference(
            fix.chunk_dbs, fix.bm25_pickle, device=CPU)
        want = jax_import.assemble_index_from_reference(
            fix.chunk_dbs, fix.bm25_pickle)
        _bm25_equal(got.bm25, want.bm25)
        assert got.vocab == want.vocab
        assert np.array_equal(got.bm25_doc_mask, want.bm25_doc_mask)
        assert int(got.bm25_doc_mask.sum()) == len(range(0, 150, stride))
        for m in want.dense:
            assert np.array_equal(_np(got.dense[m]), _np(want.dense[m]))
        got_stats = dict(got.bm25_stats)
        want_stats = dict(want.bm25_stats)
        assert got_stats == want_stats


_FRESH_IMPORT = """
import sys
from a_nice_rag_tpu_torch.index.io import load_reference_bm25_pickle
from a_nice_rag_tpu_torch.ingest.import_reference import (
    assemble_index_from_reference,
)
dbs = dict(p.split("=", 1) for p in sys.argv[2:])
arrays, vocab, *_ = load_reference_bm25_pickle(sys.argv[1], device="cpu")
index = assemble_index_from_reference(dbs, sys.argv[1], device="cpu")
leaked = sorted(m for m in sys.modules if m == "a_nice_rag_tpu"
                or m.startswith("a_nice_rag_tpu.") or m == "jax"
                or m.startswith("jax."))
assert not leaked, leaked
print(index.n_docs, arrays.nnz, len(vocab))
"""


def test_port_reads_jax_fixture_without_importing_the_jax_package(tmp_path):
    """The JAX-written pickle names a_nice_rag_tpu's GoldenBm25Okapi and
    _Document; the port stubs them without importing that package."""
    c = _fixture_corpus()
    jfix = jax_fixture.write_reference_fixture(str(tmp_path / "j"), c,
                                               bm25_subset_stride=2)
    with open(jfix.bm25_pickle, "rb") as f:
        assert b"a_nice_rag_tpu.testing.golden" in f.read()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH_IMPORT, jfix.bm25_pickle,
         *[f"{m}={p}" for m, p in jfix.chunk_dbs.items()]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_docs, nnz, n_vocab = map(int, proc.stdout.split())
    j_arrays, j_vocab, *_ = jax_io.load_reference_bm25_pickle(
        jfix.bm25_pickle)
    assert (n_docs, nnz, n_vocab) == (150, int(j_arrays.nnz), len(j_vocab))


# -- the default device ------------------------------------------------------


def test_entry_points_default_to_the_card(tmp_path):
    """Without a device argument the importers and the manager go to the
    card; on a machine without one that raises instead of quietly staying
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists here")
    c = _fixture_corpus()
    fix = reference_fixture.write_reference_fixture(str(tmp_path / "p"), c)
    calls = {
        "IndexManager": IndexManager,
        "load_reference_bm25_pickle": lambda:
            port_io.load_reference_bm25_pickle(fix.bm25_pickle),
        "assemble_index_from_reference": lambda:
            import_reference.assemble_index_from_reference(
                fix.chunk_dbs, fix.bm25_pickle),
        "import_reference.main": lambda: import_reference.main(
            ["--chunk-db", f"voyage-3-large={fix.chunk_dbs['voyage-3-large']}",
             "--output", str(tmp_path / "out")]),
        "build_bm25_component": lambda: bm25_build.build_bm25_component(
            [{"tokens_lemmatized": ["a", "b"]}], 128),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA GPU is required"):
            call()
    assert not (tmp_path / "out").exists()
