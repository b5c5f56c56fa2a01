"""The port's offline ingestion (``ingest/``: tokens, xml_to_md, chunker,
embed_db, nice_api, run_pipeline; ``utils/corpus_stats.py``) against the
JAX package's, on the CPU.

Both packages take the same inputs. Tolerances:

- markdown, chunk dicts, the chunk JSON file and the tokens CSV equal
  byte for byte (both are pure Python over the same inputs);
- chunk-DB rows equal (``SELECT ... ORDER BY id``) and artifact npz
  arrays ``np.array_equal`` key by key, meta.json equal;
- the slice as a whole (convert -> chunk -> preprocess -> embed ->
  artifact -> SearchEngine): the two encoders' float32 embeddings within
  1e-5, their dense lists equal up to ties (``check_top_k``, 1e-4), the
  hybrid ids equal.

Token counting is the heuristic on both sides (``TokenCounter._try_hf``
patched to None where a counter is built without ``fn=``), so no
tokenizer is looked up. The NICE API's ``_get`` is patched in both
modules: nothing reaches the network.
"""

import importlib.util
import json
import os
import sqlite3
import sys
import urllib.error
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from a_nice_rag_tpu.ingest import chunker as jax_chunker
from a_nice_rag_tpu.ingest import embed_db as jax_embed_db
from a_nice_rag_tpu.ingest import nice_api as jax_nice
from a_nice_rag_tpu.ingest import run_pipeline as jax_pipeline
from a_nice_rag_tpu.ingest import tokens as jax_tokens
from a_nice_rag_tpu.ingest import xml_to_md as jax_xml
from a_nice_rag_tpu.utils import corpus_stats as jax_stats
from a_nice_rag_tpu_torch.ingest import chunker, embed_db, nice_api
from a_nice_rag_tpu_torch.ingest import run_pipeline, tokens, xml_to_md
from a_nice_rag_tpu_torch.testing.guidelines import (
    guideline_documents,
    write_guidelines,
)
from a_nice_rag_tpu_torch.utils import corpus_stats

TESTS = Path(__file__).resolve().parent
EMB_ATOL = 1e-5
DENSE_ATOL = 1e-4


def _load(name):
    """A JAX package test module, loaded under a private name (its inputs
    and cases are reused; pytest does not collect it twice)."""
    key = f"_jax_inputs_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, TESTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


# tests/test_parity_extras.py's test_ingest_pipeline_cli input.
CLI_XML = (
    "<Guidance><Title>Test guideline</Title>"
    "<GuidanceNumber>NG1</GuidanceNumber><Chapters><Chapter>"
    "<Title>Recommendations</Title><Content><![CDATA[<p>"
    + "Patients with diabetes need reviews. " * 30
    + "</p>]]></Content></Chapter></Chapters></Guidance>"
)


@pytest.fixture
def heuristic_only(monkeypatch):
    """TokenCounter("auto") counts with the heuristic in both packages."""
    for mod in (jax_tokens, tokens):
        monkeypatch.setattr(mod.TokenCounter, "_try_hf",
                            staticmethod(lambda name: None))


def _small_docs(n, seed):
    return guideline_documents(n, seed=seed, chapters=(1, 3), sections=(1, 4))


# -- XML to markdown ---------------------------------------------------------


def _xml_cases():
    cases = [pytest.param(lambda: _load("test_ingest").XML_DOC,
                          id="test_ingest_XML_DOC"),
             pytest.param(lambda: CLI_XML, id="cli_xml")]
    cases += [pytest.param(lambda s=s: _small_docs(1, s)[0].xml,
                           id=f"seeded{s}") for s in range(20)]
    return cases


@pytest.mark.parametrize("make", _xml_cases())
def test_xml_to_markdown_byte_equal(make):
    xml = make()
    got = xml_to_md.convert_xml_to_markdown(xml)
    assert got == jax_xml.convert_xml_to_markdown(xml)
    assert got.startswith("# ")


def test_seeded_guidelines_cover_the_markup():
    xml = "".join(d.xml for d in _small_docs(20, 0))
    for piece in ("<ul>", "<ol>", "<li>", "<table>", "<caption>", "|",
                  '<a href="', "<strong>", "<em>", "&amp;", "&lt;",
                  "<br/>", "<h4>", 'class="recommendation__number"'):
        assert piece in xml, piece
    # A nested list, a nested section and a section without content.
    assert "<li>" in xml and "<ul><li>" in xml.replace("</li><li>", "")
    assert "</Section></Sections></Section>" in xml
    assert "</Title></Section>" in xml
    assert xml.isascii()


def test_convert_directory_same_files_order_and_failures(tmp_path, capsys):
    xml_dir = tmp_path / "xml"
    write_guidelines(str(xml_dir), _small_docs(4, 7))
    (xml_dir / "AA1_structured_document.xml").write_text("<Guidance><Title>")
    (xml_dir / "ZZ9_structured_document.xml").write_text(CLI_XML)
    out = {}
    for name, mod in (("jax", jax_xml), ("port", xml_to_md)):
        n = mod.convert_directory(str(xml_dir), str(tmp_path / name))
        out[name] = (n, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 5
    assert out["port"][1].startswith(
        f"Failed to convert {xml_dir / 'AA1_structured_document.xml'}: ")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 5
    for f in names:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


# -- the chunker --------------------------------------------------------------


class _BothChunkers:
    """Stands in for MarkdownChunker in the JAX package's chunker tests:
    each call runs both packages' chunkers and requires equal chunks."""

    def __init__(self, **kw):
        self.jax = jax_chunker.MarkdownChunker(**kw)
        self.port = chunker.MarkdownChunker(**kw)
        self.calls = 0

    def chunk_markdown(self, content, file_path="doc.md"):
        want = self.jax.chunk_markdown(content, file_path)
        got = self.port.chunk_markdown(content, file_path)
        assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
        self.calls += 1
        return want


@pytest.mark.parametrize("case", [
    "test_chunker_small_sections_kept_whole",
    "test_chunker_oversized_section_splits_with_overlap",
    "test_chunker_recurses_into_children",
    "test_chunker_merges_small_chunks",
    "test_chunker_dedup",
])
def test_jax_chunker_cases_on_both(case, monkeypatch, heuristic_only):
    mod = _load("test_ingest")
    made = []

    def both(**kw):
        made.append(_BothChunkers(**kw))
        return made[-1]

    monkeypatch.setattr(mod, "MarkdownChunker", both)
    getattr(mod, case)()
    assert made and all(m.calls for m in made)


def _random_markdown(rng):
    """Headings at random depths; sections small, large with split
    candidates (subheadings, blank lines) and large without any (one
    long line); duplicated bodies; runs of small sections."""
    words = [f"w{i}" for i in range(300)] + ["the", "and", "of", "care"]

    def sentence():
        n = int(rng.integers(4, 16))
        return " ".join(rng.choice(words, n)) + rng.choice([".", "!", "?"])

    def para():
        return " ".join(sentence() for _ in range(int(rng.integers(1, 6))))

    lines = [f"# {rng.choice(words)} guideline", ""]
    if rng.random() < 0.2:
        lines = []  # no H1
    bodies = []
    for _ in range(int(rng.integers(3, 14))):
        level = int(rng.integers(1, 7)) if rng.random() < 0.3 else \
            int(rng.integers(2, 4))
        lines += [f"{'#' * level} {' '.join(rng.choice(words, 2))}", ""]
        kind = rng.random()
        if kind < 0.15 and bodies:
            body = bodies[int(rng.integers(len(bodies)))]  # a duplicate
        elif kind < 0.4:
            body = sentence()  # a small section
        elif kind < 0.55:
            body = " ".join(para() for _ in range(int(rng.integers(4, 12))))
        else:
            parts = []
            for _ in range(int(rng.integers(2, 12))):
                if rng.random() < 0.25:
                    parts.append(f"{'#' * int(rng.integers(3, 7))} "
                                 f"{rng.choice(words)}")
                parts.append(para())
            body = "\n\n".join(parts)
        bodies.append(body)
        lines += [body, ""]
    return "\n".join(lines)


@pytest.mark.parametrize("seed", range(20))
def test_chunker_seeded_markdown(seed):
    rng = np.random.default_rng(seed)
    kw = dict(max_tokens=int(rng.choice([80, 150, 300, 600])),
              min_tokens=int(rng.choice([10, 50, 200])),
              overlap_tokens=int(rng.choice([0, 20, 50])))
    md = _random_markdown(rng)
    path = f"{rng.choice(['NG', 'CG', 'QS'])}{seed}_structured_document.md"
    want = jax_chunker.MarkdownChunker(
        **kw, token_counter=jax_tokens.TokenCounter(mode="heuristic"),
    ).chunk_markdown(md, path)
    got = chunker.MarkdownChunker(
        **kw, token_counter=tokens.TokenCounter(mode="heuristic"),
    ).chunk_markdown(md, path)
    assert got and [c.to_dict() for c in got] == [
        c.to_dict() for c in want]


def test_chunker_paths_all_taken():
    """The seeded documents reach every split kind and the merge."""
    kinds, merged_past_3, parts = set(), False, False
    for seed in range(20):
        rng = np.random.default_rng(seed)
        kw = dict(max_tokens=int(rng.choice([80, 150, 300, 600])),
                  min_tokens=int(rng.choice([10, 50, 200])),
                  overlap_tokens=int(rng.choice([0, 20, 50])))
        md = _random_markdown(rng)
        for c in chunker.MarkdownChunker(
                **kw, token_counter=tokens.TokenCounter(mode="heuristic"),
        ).chunk_markdown(md, f"NG{seed}_doc.md"):
            kinds.add(c.split_type)
            merged_past_3 |= "more sections" in c.title
            parts |= "[..." in c.content
    assert {"subsection", "paragraph", "end"} <= kinds
    assert merged_past_3 and parts


def test_chunk_directory_json_byte_equal(tmp_path, heuristic_only):
    md_dir = tmp_path / "md"
    md_dir.mkdir()
    for d in _small_docs(6, 3):
        (md_dir / f"{d.number}_structured_document.md").write_text(
            xml_to_md.convert_xml_to_markdown(d.xml))
    for s in range(3):
        (md_dir / f"MTG{90 + s}_doc.md").write_text(
            _random_markdown(np.random.default_rng(100 + s)))
    kw = dict(max_tokens=300, min_tokens=100, overlap_tokens=50)
    want = jax_chunker.MarkdownChunker(**kw).chunk_directory(
        str(md_dir), str(tmp_path / "jax" / "chunks.json"))
    got = chunker.MarkdownChunker(**kw).chunk_directory(
        str(md_dir), str(tmp_path / "port" / "chunks.json"))
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
    assert (tmp_path / "port" / "chunks.json").read_bytes() == \
        (tmp_path / "jax" / "chunks.json").read_bytes()
    assert len({c.source for c in got}) == 9


# -- tokens and corpus stats --------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(st.text(max_size=300))
def test_heuristic_token_count_equal(text):
    assert tokens.heuristic_token_count(text) == \
        jax_tokens.heuristic_token_count(text)


def test_token_counter_modes(monkeypatch):
    for mod in (jax_tokens, tokens):
        seen = []
        c = mod.TokenCounter(fn=lambda t: seen.append(t) or len(t))
        assert c("abc") == c("abc") == 3 and seen == ["abc"]
        h = mod.TokenCounter(mode="heuristic")
        assert h._fn is mod.heuristic_token_count
        monkeypatch.setattr(mod.TokenCounter, "_try_hf",
                            staticmethod(lambda name: None))
        with pytest.raises(RuntimeError, match="unavailable"):
            mod.TokenCounter(mode="hf")
        assert mod.TokenCounter(mode="auto")._fn is mod.heuristic_token_count


def test_token_counter_without_transformers(monkeypatch):
    """Where transformers is not installed, "auto" counts with the
    heuristic and "hf" raises, with no import error."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    for mod in (jax_tokens, tokens):
        assert mod.TokenCounter()._fn is mod.heuristic_token_count
        with pytest.raises(RuntimeError, match="unavailable"):
            mod.TokenCounter(mode="hf")


def test_token_counter_cache_clears_past_200k():
    sizes = []
    for mod in (jax_tokens, tokens):
        c = mod.TokenCounter(fn=len)
        for i in range(200_002):
            c(str(i))
        sizes.append(len(c._cache))
    assert sizes[0] == sizes[1] == 1


def test_corpus_stats_equal(heuristic_only):
    chunks = _load("test_question_gen")._chunks()
    assert corpus_stats.corpus_stats(chunks) == \
        jax_stats.corpus_stats(chunks)
    with_tokens = [dict(c, tokens=len(c["content"]) // 4 or None)
                   for c in chunks]
    assert corpus_stats.corpus_stats(with_tokens) == \
        jax_stats.corpus_stats(with_tokens)
    assert corpus_stats.corpus_stats([]) == jax_stats.corpus_stats([])
    stats = corpus_stats.corpus_stats(
        chunks, token_counter=tokens.TokenCounter(mode="heuristic"))
    assert stats["n_chunks"] == 6 and stats["total_tokens"] > 0


# -- embed_db -----------------------------------------------------------------


class _Embedder:
    """A duck-typed embedder: unit rows seeded by each text's characters,
    the same in both packages."""

    def __init__(self, dim=8, **_):
        self.dim = dim
        self.calls = 0

    def embed_documents(self, texts):
        self.calls += len(texts)
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            rng = np.random.default_rng(sum(map(ord, t)) + len(t))
            v = rng.standard_normal(self.dim).astype(np.float32)
            out[i] = v / np.linalg.norm(v)
        return out


def _rows(db):
    conn = sqlite3.connect(db)
    try:
        return conn.execute(
            "SELECT id, content, source, embedding, url FROM chunks "
            "ORDER BY id").fetchall()
    finally:
        conn.close()


def _chunk_dicts(n, prefix="NG"):
    return [{"title": f"{prefix}{i % 3}_Section {i}",
             "content": f"patients with condition {i} need review {i % 5}",
             "source": f"{prefix}{i % 3}"} for i in range(n)]


def test_chunk_db_rows_equal_and_incremental(tmp_path):
    chunks = _chunk_dicts(11)
    written = {}
    for name, mod in (("jax", jax_embed_db), ("port", embed_db)):
        db = str(tmp_path / name / "chunks.db")
        e = _Embedder()
        assert mod.embed_chunks_incremental(chunks[:7], e, db,
                                            batch_size=3) == 7
        assert mod.embed_chunks_incremental(chunks, e, db,
                                            batch_size=4) == 4
        assert mod.embed_chunks_incremental(chunks, e, db) == 0
        assert e.calls == 11
        assert mod.existing_chunk_ids(db) == {c["title"] for c in chunks}
        written[name] = _rows(db)
    assert written["port"] == written["jax"]
    cid, _, source, blob, url = written["port"][0]
    assert url == f"https://www.nice.org.uk/guidance/{source.lower()}"
    assert np.frombuffer(blob, np.float32).shape == (8,)


def test_chunk_db_missing_and_empty(tmp_path):
    empty = tmp_path / "empty.db"
    sqlite3.connect(empty).close()
    for mod in (jax_embed_db, embed_db):
        assert mod.existing_chunk_ids(str(tmp_path / "missing.db")) == set()
        assert mod.existing_chunk_ids(str(empty)) == set()
        mod.write_chunk_db(str(tmp_path / mod.__name__ / "c.db"), ["a"],
                           ["x"], ["NG1"], np.ones((1, 2), np.float64))
    assert _rows(tmp_path / jax_embed_db.__name__ / "c.db") == \
        _rows(tmp_path / embed_db.__name__ / "c.db") == [
            ("a", "x", "NG1", np.ones(2, np.float32).tobytes(), None)]


def _artifact_equal(got_dir, want_dir):
    got = np.load(os.path.join(got_dir, "arrays.npz"))
    want = np.load(os.path.join(want_dir, "arrays.npz"))
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    with open(os.path.join(got_dir, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(want_dir, "meta.json")) as f:
        assert meta == json.load(f)
    return meta


def test_build_artifact_two_models_misaligned(tmp_path):
    chunks = _chunk_dicts(12)
    dbs = {}
    for model, dim, keep in (("voyage-3-large", 8, range(12)),
                             ("text-embedding-3-large", 6,
                              [9, 2, 11, 4, 0, 7, 5])):
        db = str(tmp_path / f"{model}.db")
        embed_db.embed_chunks_incremental([chunks[i] for i in keep],
                                          _Embedder(dim), db)
        dbs[model] = db
    token_lists = {c["title"]: c["content"].split()[:4 + i % 3]
                   for i, c in enumerate(chunks) if i != 3}
    for name, mod in (("jax", jax_embed_db), ("port", embed_db)):
        kw = {"device": "cpu"} if mod is embed_db else {}
        mod.build_artifact_from_chunk_dbs(
            dbs, str(tmp_path / name), token_lists_by_id=token_lists,
            k1=1.5, b=0.7, epsilon=0.1, **kw)
    meta = _artifact_equal(tmp_path / "port", tmp_path / "jax")
    arrays = np.load(tmp_path / "port" / "arrays.npz")
    second = arrays["dense/text-embedding-3-large"]
    missing = [i for i, cid in enumerate(meta["ids"])
               if cid not in {chunks[k]["title"]
                              for k in (9, 2, 11, 4, 0, 7, 5)}]
    assert len(missing) == 5 and not second[missing].any()
    assert meta["bm25_stats"]["k1"] == 1.5


# -- nice_api -----------------------------------------------------------------


def _patch_get(monkeypatch, respond):
    calls = []

    def fake(url, api_key, accept="application/json"):
        calls.append((url, api_key, accept))
        return respond(url)

    for mod in (jax_nice, nice_api):
        monkeypatch.setattr(mod, "_get", fake)
    return calls


@pytest.mark.parametrize("form", ["list", "dict"])
def test_fetch_guidance_index(form, monkeypatch):
    items = [{"GuidanceNumber": "NG1"}, {"GuidanceNumber": "CG2"}]
    body = items if form == "list" else {"Guidance": items, "Count": 2}
    calls = _patch_get(monkeypatch, lambda url: json.dumps(body).encode())
    monkeypatch.setenv("NICE_API_KEY", "k")
    assert nice_api.fetch_guidance_index() == \
        jax_nice.fetch_guidance_index() == items
    assert calls[0] == calls[1] == (f"{nice_api.API_BASE}/current.json", "k",
                                    "application/json")


def _http_error(code):
    return urllib.error.HTTPError("u", code, "m", {}, None)


@pytest.mark.parametrize("status", [200, 404, 401, 429, 500, "network"])
def test_download_statuses(status, tmp_path, monkeypatch, caplog):
    def respond(url):
        if status == 200:
            return b"<Guidance/>"
        if status == "network":
            raise urllib.error.URLError("no route")
        raise _http_error(status)

    calls = _patch_get(monkeypatch, respond)
    out, logs = {}, {}
    for name, mod in (("jax", jax_nice), ("port", nice_api)):
        caplog.clear()
        with caplog.at_level("INFO"):
            path = mod.download_guideline_xml("NG12", str(tmp_path / name),
                                              api_key="key")
        out[name] = path and os.path.relpath(path, tmp_path / name)
        logs[name] = [(r.levelname, r.getMessage()) for r in caplog.records]
    assert out["port"] == out["jax"]
    assert logs["port"] == logs["jax"]
    assert calls[0] == calls[1] == (
        f"{nice_api.API_BASE}/ng12/structured-document.xml", "key",
        "application/xml")
    if status == 200:
        assert out["port"] == "NG12_structured_document.xml"
        assert (tmp_path / "port" / out["port"]).read_bytes() == b"<Guidance/>"
    else:
        assert out["port"] is None and len(logs["port"]) == 1
        assert not (tmp_path / "port").exists()


def test_download_all_skips_and_resumes(tmp_path, monkeypatch):
    sleeps = []
    fetched = _patch_get(
        monkeypatch, lambda url: (_ for _ in ()).throw(_http_error(404))
        if "cg3" in url else b"<Guidance/>")
    results = {}
    for name, mod in (("jax", jax_nice), ("port", nice_api)):
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        out_dir = tmp_path / name
        out_dir.mkdir()
        (out_dir / "NG1_structured_document.xml").write_text("kept")
        got = mod.download_all(["NG1", "NG2", "CG3"], str(out_dir),
                               api_key="k", delay_s=0.25)
        # The rerun resumes: only the failed one is fetched again.
        again = mod.download_all(["NG1", "NG2", "CG3"], str(out_dir),
                                 api_key="k", delay_s=0.25)
        assert (out_dir / "NG1_structured_document.xml").read_text() == "kept"
        results[name] = [
            {k: v and os.path.relpath(v, out_dir) for k, v in r.items()}
            for r in (got, again)]
    assert results["port"] == results["jax"]
    assert results["port"][0] == {"NG1": "NG1_structured_document.xml",
                                  "NG2": "NG2_structured_document.xml",
                                  "CG3": None}
    assert sleeps == [0.25] * 6
    assert len(fetched) == 6


# -- run_pipeline -------------------------------------------------------------


def _workdir(tmp_path, name, docs):
    w = tmp_path / name
    write_guidelines(str(w / "xml"), docs)
    (w / "xml" / "NG1_structured_document.xml").write_text(CLI_XML)
    return w


def _files(w):
    return {str(p.relative_to(w)): p.read_bytes()
            for p in sorted(w.rglob("*")) if p.is_file()
            and p.suffix in (".md", ".json", ".csv")}


def test_pipeline_cli_convert_chunk_preprocess(tmp_path, heuristic_only):
    # One workdir for both: the chunks name their markdown file's path.
    docs = _small_docs(5, 11)
    w = _workdir(tmp_path, "w", docs)
    out = {}
    for name, mod in (("jax", jax_pipeline), ("port", run_pipeline)):
        mod.main(["--workdir", str(w), "--stages",
                  "convert,chunk,preprocess", "--max-tokens", "200",
                  "--min-tokens", "20"])
        out[name] = _files(w)
        for p in w.rglob("*"):
            if p.is_file() and p.suffix in (".md", ".json", ".csv"):
                p.unlink()
    assert out["port"] == out["jax"]
    assert "md/NG1_structured_document.md" in out["port"]
    assert "chunked_guidelines.json" in out["port"]
    assert "chunks_bm25.csv" in out["port"]
    chunks = json.loads(out["port"]["chunked_guidelines.json"])
    assert {c["source"] for c in chunks} == {d.number for d in docs}


def test_pipeline_download_needs_guidelines(tmp_path):
    for mod in (jax_pipeline, run_pipeline):
        with pytest.raises(SystemExit, match="--guidelines required"):
            mod.main(["--workdir", str(tmp_path), "--stages", "download"])


def test_pipeline_embed_and_artifact(tmp_path, monkeypatch, heuristic_only):
    from a_nice_rag_tpu.retrieval import embed as jax_embed
    from a_nice_rag_tpu_torch.retrieval import embed as port_embed

    made = []

    def embedder(model):
        made.append(model)
        return _Embedder(16)

    for mod in (jax_embed, port_embed):
        monkeypatch.setattr(mod, "VoyageEmbedder", embedder)
        monkeypatch.setattr(mod, "OpenAIEmbedder", embedder)
    docs = _small_docs(3, 5)
    for name, mod in (("jax", jax_pipeline), ("port", run_pipeline)):
        w = _workdir(tmp_path, name, docs)
        args = ["--workdir", str(w), "--artifact", str(w / "artifact")]
        mod.main(args + ["--stages", "convert,chunk,preprocess"])
        for model in ("voyage-3-large", "text-embedding-3-large"):
            mod.main(args + ["--stages", "embed", "--embed-model", model])
        device = ["--device", "cpu"] if mod is run_pipeline else []
        mod.main(args + ["--stages", "artifact", "--k1", "1.2"] + device)
    assert made == ["voyage-3-large", "text-embedding-3-large"] * 2
    for model in ("voyage-3-large", "text-embedding-3-large"):
        db = f"{model}_chunks.db"
        assert _rows(tmp_path / "port" / db) == _rows(tmp_path / "jax" / db)
    meta = _artifact_equal(tmp_path / "port" / "artifact",
                           tmp_path / "jax" / "artifact")
    assert meta["dense_models"] == ["voyage-3-large"]
    assert meta["bm25_stats"]["k1"] == 1.2 and meta["n_docs"] > 3


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without a device argument the artifact is built on the card; on a
    machine without one that raises rather than staying on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = str(tmp_path / "voyage-3-large_chunks.db")
    embed_db.write_chunk_db(db, ["NG1_A"], ["text"], ["NG1"],
                            np.ones((1, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        embed_db.build_artifact_from_chunk_dbs({"voyage-3-large": db},
                                               str(tmp_path / "a"))
    (tmp_path / "chunks_bm25.csv").write_text(
        "id,source,content,tokens_regular,tokens_lemmatized\n"
        "NG1_A,NG1,text,['text'],['text']\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pipeline.main(["--workdir", str(tmp_path), "--stages",
                           "artifact", "--artifact", str(tmp_path / "b")])
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


# -- the slice as a whole -----------------------------------------------------


def test_slice_end_to_end_against_jax(tmp_path, heuristic_only):
    """XML -> markdown -> chunks -> BM25 tokens -> on-device embeddings
    (the JAX encoder and the port's, its params carried across) -> chunk
    DB -> artifact -> each package's SearchEngine."""
    import jax
    import jax.numpy as jnp

    from a_nice_rag_tpu.index import load_index as jax_load_index
    from a_nice_rag_tpu.index.io import (
        load_preprocessed_tokens_csv as jax_tokens_csv,
    )
    from a_nice_rag_tpu.models import EncoderConfig as JaxEncoderConfig
    from a_nice_rag_tpu.models import OnDeviceEmbedder as JaxEmbedder
    from a_nice_rag_tpu.retrieval import SearchEngine as JaxEngine
    from a_nice_rag_tpu.text import preprocess_text as jax_preprocess
    from a_nice_rag_tpu_torch.index import load_index
    from a_nice_rag_tpu_torch.index.io import (
        load_preprocessed_tokens_csv as tokens_csv,
    )
    from a_nice_rag_tpu_torch.models import EncoderConfig, OnDeviceEmbedder
    from a_nice_rag_tpu_torch.models.convert import encoder_state_from_flax
    from a_nice_rag_tpu_torch.retrieval import SearchEngine
    from a_nice_rag_tpu_torch.testing.parity import check_top_k
    from a_nice_rag_tpu_torch.text import preprocess_text

    model = "voyage-3-large"
    widths = dict(vocab_size=4096, dim=64, n_layers=2, n_heads=4,
                  max_len=128, out_dim=32)
    jemb = JaxEmbedder(JaxEncoderConfig(**widths, dtype=jnp.float32), seed=3)
    emb = OnDeviceEmbedder(
        EncoderConfig(**widths, dtype=torch.float32),
        state_dict=encoder_state_from_flax(jax.device_get(jemb.params)),
        device="cpu")
    docs = _small_docs(6, 21)
    engines, queries = {}, {}
    for name, mod, e, db_mod in (
            ("jax", jax_pipeline, jemb, jax_embed_db),
            ("port", run_pipeline, emb, embed_db)):
        w = _workdir(tmp_path, name, docs)
        mod.main(["--workdir", str(w), "--stages",
                  "convert,chunk,preprocess"])
        with open(w / "chunked_guidelines.json") as f:
            chunks = json.load(f)
        db = str(w / f"{model}_chunks.db")
        assert db_mod.embed_chunks_incremental(chunks, e, db,
                                               batch_size=16) == len(chunks)
        toks = (jax_tokens_csv if name == "jax" else tokens_csv)(
            str(w / "chunks_bm25.csv"))
        kw = {"device": "cpu"} if db_mod is embed_db else {}
        db_mod.build_artifact_from_chunk_dbs({model: db}, str(w / "art"),
                                             token_lists_by_id=toks, **kw)
        sample = chunks[::max(1, len(chunks) // 24)]
        if name == "jax":
            engines[name] = JaxEngine(jax_load_index(str(w / "art")))
            q = np.asarray(jemb.embed_queries([c["content"] for c in sample]))
            t = [jax_preprocess(c["content"], True) for c in sample]
        else:
            engines[name] = SearchEngine(load_index(str(w / "art"),
                                                    device="cpu"))
            q = emb.embed_queries([c["content"] for c in sample])
            t = [preprocess_text(c["content"], True) for c in sample]
        queries[name] = (q, t, [c["title"] for c in sample])
    (jq, jt, jids), (pq, pt, pids) = queries["jax"], queries["port"]
    assert pids == jids and pt == jt and len(pids) >= 20
    np.testing.assert_allclose(pq, jq, rtol=0, atol=EMB_ATOL)
    # Same chunks and tokens: the DBs differ only in their float32 rows.
    kw = dict(query_token_lists=pt, similarity_k=10, common_sections_n=10,
              model_weights={model: 1.0, "BM25": 1.0},
              use_hybrid_search=True)
    got = engines["port"].retrieve({model: pq}, **kw)
    want = engines["jax"].retrieve({model: jq}, **kw)
    assert got == want
    assert sum(cid in ids for cid, ids in zip(pids, got)) == len(pids)
    gv, gi = engines["port"].similarity_search_batch(pq, model, 10)
    wv, wi = engines["jax"].similarity_search_batch(jq, model, 10)
    check_top_k(np.asarray(wv), np.asarray(wi), np.asarray(gv),
                np.asarray(gi), DENSE_ATOL)
