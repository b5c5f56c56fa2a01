"""The port's IVF ANN route against the JAX package's.

Covered: the cluster-major layout and spill slots, the IVF builders, the
tile table, K3/K4's plain versions (what the port's wrappers run on CPU
tensors) against the JAX package's TPU kernels run in interpret mode,
``ivf_search`` and ``tune_nprobe`` on JAX-built IVFs carried over by
``from_reference_ivf``, the engine's ``nprobe`` route, online updates,
and index artifacts with IVF saved by one package and loaded by the
other. Inputs are made with numpy from a seed.

Tolerances: f32 scores 1e-5 (the same products summed in another
order), ids tie-normalized with ``check_top_k``; int8 ids equal and
values within 1e-6 relative (exact int32 dots, the same two f32
multiplies). Layouts, tables and appended arrays are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.index import ivf as jivf
from a_nice_rag_tpu.index import load_index as jax_load_index
from a_nice_rag_tpu.index import save_index as jax_save_index
from a_nice_rag_tpu.index import updates as jup
from a_nice_rag_tpu.ops import kmeans as jk
from a_nice_rag_tpu.ops.pallas.ivf_topk import (
    ivf_dense_top_k as jax_k3,
    ivf_dense_top_k_int8 as jax_k4,
)
from a_nice_rag_tpu.ops.quantized import quantize_embeddings, quantize_queries
from a_nice_rag_tpu.retrieval import FusedRetriever as JaxRetriever
from a_nice_rag_tpu.retrieval.engine import _ivf_coverage as jax_coverage
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import from_reference_index, load_index
from a_nice_rag_tpu_torch.index import ivf as tivf
from a_nice_rag_tpu_torch.index import save_index
from a_nice_rag_tpu_torch.index import updates as tup
from a_nice_rag_tpu_torch.index.convert import from_reference_ivf
from a_nice_rag_tpu_torch.ops import kmeans as tkm
from a_nice_rag_tpu_torch.ops.kernels import (
    ivf_dense_top_k,
    ivf_dense_top_k_int8,
)
from a_nice_rag_tpu_torch.ops.quantized import QuantizedDense
from a_nice_rag_tpu_torch.retrieval import FusedRetriever
from a_nice_rag_tpu_torch.retrieval import engine as tengine
from a_nice_rag_tpu_torch.testing.parity import check_top_k

F32_ATOL = 1e-5
MODEL = "voyage-3-large"


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(7)
    c_true, d, per = 12, 48, 40
    cents = _unit(rng.normal(size=(c_true, d)))
    x = _unit(np.repeat(cents, per, axis=0)
              + 0.08 * rng.normal(size=(c_true * per, d))).astype(np.float32)
    gold = rng.integers(0, len(x), 16)
    q = _unit(x[gold] + 0.12 * rng.normal(size=(16, d))).astype(np.float32)
    return x, q, gold


def _jax_ivf(x, int8=False, **kw):
    kw = dict(dict(n_clusters=12, tile_n=128, n_iters=8, seed=0), **kw)
    if int8:
        return jivf.build_ivf_quantized(quantize_embeddings(jnp.asarray(x)),
                                        **kw)
    return jivf.build_ivf_dense(jnp.asarray(x), **kw)


def _assert_ivf_equal(port, ref):
    """A port IVFDense holds exactly the arrays and layout of ``ref``."""
    assert (port.tile_n, port.n_real, port.max_cluster_tiles, port.spilled) \
        == (ref.tile_n, ref.n_real, ref.max_cluster_tiles, ref.spilled)
    for name in ("centroids", "perm", "cluster_start", "emb", "values",
                 "scales"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(
                a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy(),
                np.asarray(b).astype(np.float32) if a.dtype == torch.bfloat16
                else np.asarray(b), err_msg=name)


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("spill,margin", [(False, None), (True, None),
                                          (True, 0.05)])
def test_layout_and_spill_slots_match_jax(clustered, spill, margin):
    x = clustered[0]
    cent, assign = jk.spherical_kmeans(jnp.asarray(x), 12, n_iters=8, seed=0)
    assign_np = np.asarray(assign)
    rows = None
    j_assign = t_assign = assign_np
    if spill:
        rows, j_assign = jivf._spill_slots(jnp.asarray(x), cent, assign_np,
                                           margin)
        t_rows, t_assign = tivf._spill_slots(_t(x), _t(cent), assign_np,
                                             margin)
        np.testing.assert_array_equal(t_rows, rows)
        np.testing.assert_array_equal(t_assign, j_assign)
    want = jivf._ivf_layout(j_assign, len(x), 12, 128, rows=rows)
    got = tivf._ivf_layout(t_assign, len(x), 12, 128, rows=rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("int8,spill", [(False, False), (False, True),
                                        (True, False)])
def test_build_ivf_from_jax_init_matches_jax(clustered, int8, spill,
                                             monkeypatch):
    x = clustered[0]
    ref = _jax_ivf(x, int8=int8, spill=spill)
    # The port's k-means starts from the JAX package's initial rows.
    monkeypatch.setattr(
        tkm, "kmeans_init_rows",
        lambda n, c, seed: _t(jk.kmeans_init_rows(n, c, seed)).long())
    kw = dict(n_clusters=12, tile_n=128, n_iters=8, spill=spill)
    if int8:
        qd = quantize_embeddings(jnp.asarray(x))
        port = tivf.build_ivf_quantized(
            QuantizedDense(values=_t(qd.values), scales=_t(qd.scales)), **kw)
    else:
        port = tivf.build_ivf_dense(_t(x), **kw)
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids), atol=F32_ATOL)
    port.centroids = _t(ref.centroids)
    _assert_ivf_equal(port, ref)


def test_default_clusters_match_jax():
    for n in (10, 300, 2**21, 10**10):
        for c in (None, 7, 1 << 20):
            assert tivf._default_clusters(n, c) \
                == jivf._default_clusters(n, c)


# ------------------------------------------------------------ tile table


@pytest.mark.parametrize("case", ["full", "partial", "truncated", "padded"])
def test_tile_table_matches_jax(clustered, case):
    x, q, _ = clustered
    ref = _jax_ivf(x)
    iv = from_reference_ivf(ref)
    nprobe, max_tiles, qb = {
        "full": (12, ref.n_tiles, q),
        "partial": (3, None, q),
        "truncated": (12, 2, q),
        "padded": (1, ref.n_tiles, x[:2]),  # fewer candidates than slots
    }[case]
    if max_tiles is None:
        max_tiles = tivf.default_max_tiles(iv, qb.shape[0], nprobe)
    args = dict(nprobe=nprobe, max_tiles=max_tiles, tile_n=128,
                mct=ref.max_cluster_tiles)
    jt, jn = jivf.build_tile_table(ref.centroids, ref.cluster_start,
                                   jnp.asarray(qb), **args)
    tt, tn = tivf.build_tile_table(iv.centroids, iv.cluster_start, _t(qb),
                                   **args)
    assert tt.dtype == torch.int32 and tt.shape == (max_tiles,)
    assert isinstance(tn, torch.Tensor) and tn.ndim == 0
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tn) == int(jn)
    real = tt[tt >= 0]
    assert bool((real[1:] > real[:-1]).all())  # ascending, deduped
    assert bool((tt[len(real):] == -1).all())  # real entries first


# ------------------------------------------------------ K3/K4 plain


_TABLES = {
    # Np = 640 rows in 5 tiles of 128; n_real = 600 (last tile ragged).
    "full": ([0, 1, 2, 3, 4], 600, 9),
    "padded": ([1, 3, 4, -1, -1], 600, 16),
    "dynamic": ([0, 2, 4, -1, 600], 0, 9),  # count in the trailing slot
    "k_past_valid": ([4, -1], 600, 100),  # tile 4: 88 valid rows
}


def _k3_inputs(seed):
    rng = np.random.default_rng(seed)
    # Rows past n_real are NOT zero: masking, not zeros, keeps them out.
    emb = rng.normal(size=(640, 32)).astype(np.float32)
    emb[300:310] = emb[:10]  # exact ties across tiles
    q = rng.normal(size=(5, 32)).astype(np.float32)
    return emb, q


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_TABLES))
def test_k3_plain_matches_jax_kernel(case, dtype):
    table, n_real, k = _TABLES[case]
    emb, q = _k3_inputs(31)
    jemb = jnp.asarray(emb, dtype=jnp.dtype(dtype))
    jv, ji = jax_k3(jemb, jnp.asarray(q), jnp.asarray(table, jnp.int32), k,
                    tile_n=128, n_real=n_real, interpret=True)
    before = ivf_dense_top_k.launches
    tv, ti = ivf_dense_top_k(_t(emb).to(getattr(torch, dtype)), _t(q),
                             torch.tensor(table, dtype=torch.int32), k,
                             tile_n=128, n_real=n_real)
    assert ivf_dense_top_k.launches == before  # CPU: the plain version
    check_top_k(jv, ji, tv, ti, F32_ATOL)
    live = ti[ti >= 0]
    assert bool((live < 600).all())
    if case == "k_past_valid":
        assert (ti[:, :88] >= 512).all() and (ti[:, 88:] == -1).all()


@pytest.mark.parametrize("case", sorted(_TABLES))
def test_k4_plain_matches_jax_kernel(case):
    table, n_real, k = _TABLES[case]
    emb, q = _k3_inputs(37)
    qd = quantize_embeddings(jnp.asarray(emb))
    scales = np.array(qd.scales)
    scales[600:] = 0.0  # the IVF layout's pad-row scale
    qv, qs = quantize_queries(jnp.asarray(q))
    jv, ji = jax_k4(qd.values, jnp.asarray(scales), qv, qs,
                    jnp.asarray(table, jnp.int32), k, tile_n=128,
                    n_real=n_real, interpret=True)
    tv, ti = ivf_dense_top_k_int8(_t(qd.values), _t(scales), _t(qv), _t(qs),
                                  torch.tensor(table, dtype=torch.int32), k,
                                  tile_n=128, n_real=n_real)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("bad", ["k_big", "npad", "n_real", "table_dtype",
                                 "depth"])
def test_ivf_wrappers_reject_unsupported_calls(bad):
    emb, q = torch.zeros((256, 8)), torch.zeros((2, 8))
    table = torch.tensor([0, 1], dtype=torch.int32)
    kw = dict(k=4, tile_n=128, n_real=200)
    if bad == "k_big":
        kw["k"] = 257
    elif bad == "npad":
        kw["tile_n"] = 100
    elif bad == "n_real":
        kw["n_real"] = 300
    elif bad == "table_dtype":
        table = table.long()
    else:
        q = torch.zeros((2, 9))
    with pytest.raises((ValueError, TypeError)):
        ivf_dense_top_k(emb, q, table, **kw)


# ------------------------------------------------- search and tuning


@pytest.mark.parametrize("int8,spill", [(False, False), (False, True),
                                        (True, False), (True, True)])
@pytest.mark.parametrize("nprobe", [3, 12])
def test_ivf_search_on_converted_jax_ivf(clustered, int8, spill, nprobe):
    x, q, _ = clustered
    ref = _jax_ivf(x, int8=int8, spill=spill)
    iv = from_reference_ivf(ref)
    _assert_ivf_equal(iv, ref)
    jv, ji, jn = jivf.ivf_search(ref, jnp.asarray(q), 9, nprobe=nprobe,
                                 interpret=True)
    tv, ti, tn = tivf.ivf_search(iv, _t(q), 9, nprobe=nprobe)
    assert int(tn) == int(jn)
    if int8:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    else:
        check_top_k(jv, ji, tv, ti, F32_ATOL)
    for row in ti.numpy():
        live = row[row >= 0]
        assert len(set(live)) == len(live)  # spilled copies deduped


def test_ivf_search_full_probe_is_exact(clustered):
    x, q, _ = clustered
    iv = from_reference_ivf(_jax_ivf(x))
    vals, ids, n_unique = tivf.ivf_search(iv, _t(q), 9, nprobe=12)
    assert int(n_unique) == iv.n_tiles
    ref = q @ x.T
    order = np.argsort(-ref, axis=1, kind="stable")[:, :9]
    check_top_k(np.take_along_axis(ref, order, 1), order, vals, ids,
                F32_ATOL)


def test_tune_nprobe_matches_jax(clustered):
    x, q, _ = clustered
    ref = _jax_ivf(x, n_iters=12, seed=1)
    kw = dict(k=5, target_recall=0.9, candidates=(1, 2, 4, 8, 64))
    want = jivf.tune_nprobe(ref, jnp.asarray(q), interpret=True, **kw)
    got = tivf.tune_nprobe(from_reference_ivf(ref), _t(q), **kw)
    assert got == want
    assert got[1][got[0]] >= 0.9


# -------------------------------------------------------------- engine


def _engine_index(n_docs, seed, spill=False, n_clusters=8, tile_n=32,
                  **build):
    c = synth_corpus(n_docs=n_docs, dim=32, n_queries=8, seed=seed)
    jidx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                       embeddings=c.embeddings, token_lists=c.tokens,
                       **build)
    jivf.attach_ivf(jidx, MODEL, n_clusters=n_clusters, tile_n=tile_n,
                    n_iters=6, spill=spill)
    return c, jidx


def _pair(jidx, tidx, use_bm25=True, **kw):
    kw = dict(dict(use_bm25=use_bm25, similarity_k=10, common_sections_n=10,
                   budget=1024), **kw)
    return JaxRetriever(jidx, (MODEL,), **kw), FusedRetriever(
        tidx, (MODEL,), **kw)


def _fused_equal(jr, tr, q, terms, w, filt=None):
    jf, _, jl = jr(q, terms, w, filt, 40.0)
    tf, _, tl = tr(q, terms, w, filt, 40.0)
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_array_equal(tf, np.asarray(jf))
    return tf


def test_engine_ivf_route_and_filtered_fallback(tmp_path):
    c, jidx = _engine_index(128, seed=41)
    # The artifact the JAX package wrote loads here with its IVF.
    jax_save_index(jidx, str(tmp_path))
    tidx = load_index(str(tmp_path))
    assert tidx.ivf and MODEL in tidx.ivf
    _assert_ivf_equal(tidx.ivf[MODEL], jidx.ivf[MODEL])
    q = {MODEL: c.query_embeddings[MODEL]}
    terms = jidx.pad_term_ids(c.query_tokens, 8)
    w = {MODEL: 5.0, "BM25": 1.0}
    exact = FusedRetriever(tidx, (MODEL,), use_bm25=True, similarity_k=10,
                           common_sections_n=10, budget=1024)
    f_exact, _, _ = exact(q, terms, w, None, 40.0)
    for nprobe in (8, 3):
        for route in ("auto", "always"):
            jr, tr = _pair(jidx, tidx, nprobe=nprobe, ivf_route=route)
            f = _fused_equal(jr, tr, q, terms, w)
            if nprobe == 8:  # full probe == the exact engine
                np.testing.assert_array_equal(f, f_exact)
            hits = sum(c.gold_ids[b] in [tidx.meta.ids[i] for i in f[b]
                                         if i >= 0] for b in range(8))
            assert hits >= 6, hits
            # Filtered call: the exact masked route, filter respected.
            f4 = _fused_equal(jr, tr, q, terms, w, "CG")
            np.testing.assert_array_equal(
                f4, exact(q, terms, w, "CG", 40.0)[0])
            assert all(tidx.meta.sources[i].upper().startswith("CG")
                       for i in f4.ravel() if i >= 0)


def test_engine_spilled_ivf_route():
    # 640 docs: no doc-axis padding, so unfiltered calls carry no mask
    # and really take the IVF route.
    c, jidx = _engine_index(640, seed=3, spill=True, n_clusters=10,
                            tile_n=128)
    tidx = from_reference_index(jidx)
    assert tidx.ivf[MODEL].spilled and tidx.filter_mask_or_none(None) is None
    q = {MODEL: c.query_embeddings[MODEL]}
    w = {MODEL: 1.0}
    jr, tr = _pair(jidx, tidx, use_bm25=False, nprobe=10,
                   ivf_route="always")
    f = _fused_equal(jr, tr, q, None, w)
    for row in f:
        live = row[row >= 0]
        assert len(set(live)) == len(live), "duplicate ids surfaced"
    exact = FusedRetriever(tidx, (MODEL,), use_bm25=False, similarity_k=10,
                           common_sections_n=10)
    np.testing.assert_array_equal(f, exact(q, None, w, None, 40.0)[0])
    jr3, tr3 = _pair(jidx, tidx, use_bm25=False, nprobe=3,
                     ivf_route="always")
    _fused_equal(jr3, tr3, q, None, w)


def test_engine_ivf_route_auto_batches(monkeypatch):
    c, jidx = _engine_index(128, seed=7)
    tidx = from_reference_index(jidx)
    q8 = {MODEL: c.query_embeddings[MODEL]}
    q2 = {MODEL: c.query_embeddings[MODEL][:2]}
    terms8 = jidx.pad_term_ids(c.query_tokens, 8)
    w = {MODEL: 5.0, "BM25": 1.0}
    for b, p, cl in [(1, 8, 8), (2, 2, 8), (8, 2, 8), (16, 16, 1448),
                     (32, 16, 1448), (8, 8, 4096), (256, 8, 4096), (3, 4, 0)]:
        assert tengine._ivf_coverage(b, p, cl) == jax_coverage(b, p, cl)
    calls = []
    real = tengine.build_tile_table
    monkeypatch.setattr(tengine, "build_tile_table",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def fresh(nprobe=2, **kw):
        return _pair(jidx, tidx, nprobe=nprobe, **kw)

    assert fresh()[1].ivf_max_coverage == 0.25
    # auto + wide batch: exact stream, no probe.
    _fused_equal(*fresh(), q8, terms8, w)
    assert not calls
    # auto + narrow batch (coverage 0.44 <= 0.5): probes.
    _fused_equal(*fresh(ivf_max_coverage=0.5), q2, terms8[:2], w)
    assert calls
    calls.clear()
    _fused_equal(*fresh(), q2, terms8[:2], w)  # 0.44 > 0.25: exact
    assert not calls
    _fused_equal(*fresh(nprobe=8, ivf_route="always"), q8, terms8, w)
    assert calls
    with pytest.raises(ValueError):
        FusedRetriever(tidx, (MODEL,), use_bm25=True, nprobe=2,
                       ivf_route="sometimes")


# ------------------------------------------------------------- updates


def _assert_index_equal(t, j):
    assert t.meta.ids == j.meta.ids and t.meta.n_docs_padded \
        == j.meta.n_docs_padded
    np.testing.assert_array_equal(t.meta.deleted, j.meta.deleted)
    for m in j.dense:
        np.testing.assert_array_equal(
            t.dense[m].float().numpy(),
            np.asarray(j.dense[m]).astype(np.float32))
    for m in j.dense_q or {}:
        np.testing.assert_array_equal(t.dense_q[m].values.numpy(),
                                      np.asarray(j.dense_q[m].values))
        np.testing.assert_array_equal(t.dense_q[m].scales.numpy(),
                                      np.asarray(j.dense_q[m].scales))
    for f in ("indptr", "doc_ids", "impact"):
        np.testing.assert_array_equal(getattr(t.bm25, f).numpy(),
                                      np.asarray(getattr(j.bm25, f)))
    assert t.vocab == j.vocab and t.bm25_stats == j.bm25_stats
    np.testing.assert_array_equal(t.bm25_doc_mask, j.bm25_doc_mask)
    assert (t.bm25_dense is None) == (j.bm25_dense is None)
    if j.bm25_dense is not None:
        np.testing.assert_array_equal(t.bm25_dense.impact.numpy(),
                                      np.asarray(j.bm25_dense.impact))


def test_ivf_with_online_updates(monkeypatch):
    c, jidx = _engine_index(128, seed=17)
    tidx = from_reference_index(jidx)
    jr, tr = _pair(jidx, tidx, use_bm25=False, nprobe=8,
                   ivf_route="always")
    q = {MODEL: c.query_embeddings[MODEL][:1]}
    w = {MODEL: 1.0}
    calls = []
    real = tengine.build_tile_table
    monkeypatch.setattr(tengine, "build_tile_table",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    f0 = _fused_equal(jr, tr, q, None, w)
    gold_row = tidx.meta.id_to_row[c.gold_ids[0]]
    assert gold_row in f0[0] and calls
    # A tombstone forces the exact masked route, in both packages.
    assert tup.delete_documents(tidx, [c.gold_ids[0]]) == 1
    assert jup.delete_documents(jidx, [c.gold_ids[0]]) == 1
    calls.clear()
    f1 = _fused_equal(jr, tr, q, None, w)
    assert gold_row not in f1[0] and not calls
    assert tup.undelete_documents(tidx, [c.gold_ids[0]]) == 1
    jup.undelete_documents(jidx, [c.gold_ids[0]])
    np.testing.assert_array_equal(_fused_equal(jr, tr, q, None, w), f0)
    # Appends return an index without the stale IVF, equal to JAX's.
    rng = np.random.default_rng(5)
    emb = _unit(rng.normal(size=(4, 32))).astype(np.float32)
    args = ([f"new{i}" for i in range(4)], ["NG1"] * 4, ["text"] * 4)
    kw = dict(embeddings={MODEL: emb},
              token_lists=[["alpha"], ["beta"], ["gamma"], ["term3"]])
    t2 = tup.append_documents(tidx, *args, **kw)
    j2 = jup.append_documents(jidx, *args, **kw)
    assert t2.ivf is None and j2.ivf is None
    _assert_index_equal(t2, j2)


@pytest.mark.parametrize("build", [
    dict(), dict(emb_dtype="bfloat16"), dict(quantize_dense=True),
    dict(bm25_dense_max_bytes=0),
])
def test_append_documents_matches_jax_bit_for_bit(build):
    c = synth_corpus(n_docs=200, dim=16, n_queries=4, seed=23)
    jidx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                       embeddings=c.embeddings, token_lists=c.tokens,
                       **build)
    tidx = from_reference_index(jidx)
    jup.delete_documents(jidx, c.ids[:3])
    tup.delete_documents(tidx, c.ids[:3])
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(70, 16)).astype(np.float32)
    toks = [list(rng.choice(["term1", "term9", "fresh", "term40"], 3))
            for _ in range(69)] + [[]]
    args = ([f"a{i}" for i in range(70)], ["QS"] * 70, ["x"] * 70)
    kw = dict(embeddings={MODEL: emb}, token_lists=toks)
    _assert_index_equal(tup.append_documents(tidx, *args, **kw),
                        jup.append_documents(jidx, *args, **kw))
    with pytest.raises(ValueError):
        tup.append_documents(tidx, c.ids[:1], ["QS"], ["x"],
                             embeddings={MODEL: emb[:1]},
                             token_lists=[["a"]])


# --------------------------------------------------------- save / load


def _two_model_jax_index(emb_dtype="float32"):
    models = [MODEL, "text-embedding-3-large"]
    c = synth_corpus(n_docs=256, dim=32, n_queries=4, seed=29, models=models)
    jidx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                       embeddings=c.embeddings, token_lists=c.tokens,
                       emb_dtype=emb_dtype, quantize_dense=[models[1]])
    for m, spill in zip(models, (False, True)):
        jivf.attach_ivf(jidx, m, n_clusters=8, tile_n=64, n_iters=4,
                        spill=spill)
    return jidx


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_jax_saved_ivf_loads_in_port(tmp_path, emb_dtype):
    jidx = _two_model_jax_index(emb_dtype)
    jax_save_index(jidx, str(tmp_path))
    tidx = load_index(str(tmp_path), emb_dtype=emb_dtype)
    assert sorted(tidx.ivf) == sorted(jidx.ivf)
    for m, ref in jidx.ivf.items():
        _assert_ivf_equal(tidx.ivf[m], ref)


def test_port_saved_ivf_loads_in_jax(tmp_path):
    jidx = _two_model_jax_index()
    save_index(from_reference_index(jidx), str(tmp_path))
    back = jax_load_index(str(tmp_path))
    assert sorted(back.ivf) == sorted(jidx.ivf)
    for m, ref in jidx.ivf.items():
        _assert_ivf_equal(from_reference_ivf(back.ivf[m]), ref)
    tivf.save_ivf(from_reference_ivf(jidx.ivf[MODEL]),
                  str(tmp_path / "one.npz"))
    _assert_ivf_equal(tivf.load_ivf(str(tmp_path / "one.npz")),
                      jivf.load_ivf(str(tmp_path / "one.npz")))
