"""The port's serve CLI stack (index -> scheduler pool -> HTTP), against
the JAX package's.

Mirrors tests/test_serve_cli.py's serving cases on the CPU: single
device, sharded over 4 "cpu" slots with a health swap (the retriever and
its pool replaced live), an int8 index, the IVF route on both paths and
the sharded IVF cache, and the batched base64 RPC in f32 and bf16. The
flags of modules the port does not have yet exit naming their ROADMAP
item. Last, /v1/search payloads (single JSON, b64 f32, b64 bf16) through
the JAX package's build_state and the port's: equal result ids, scores
within 1e-6.
"""

import base64
import json
import os
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest

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


@pytest.mark.parametrize("argv,item", [
    (["--embedder", "hashing", "--embedder-ckpt", "ckpt"], "item 9"),
    (["--embedder-ckpt", "ckpt"], "item 9"),
    (["--llm", "local"], "item 8"),
    (["--draft-ckpt", "d"], "item 8"),
    (["--json-mode"], "item 8"),
    (["--lm-tp", "2"], "item 8"),
    (["--gen-slots", "4"], "item 8"),
    (["--pallas-rounded"], "packed bf16-key fold"),
    (["--pallas-rounded=1"], "packed bf16-key fold"),
])
def test_unported_flags_exit_with_their_item(argv, item):
    with pytest.raises(SystemExit) as e:
        main(["--demo", "--device", "cpu"] + argv)
    assert item in str(e.value) and "not ported" in str(e.value)


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
