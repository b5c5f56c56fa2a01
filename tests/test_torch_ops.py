"""The port's ops against the JAX package's, on the same seeded inputs.

Tolerances: dense values 1e-5 (f32 sums in another order), BM25 values
1e-4 (the cumsum-difference segment totals cancel ~P*eps absolute,
ops/bm25.py _segment_totals), int8 quantization bit-exact. Ids must agree
up to swaps between scores within the tolerance
(a_nice_rag_tpu_torch.testing.parity.check_top_k).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.ops import bm25 as jbm25
from a_nice_rag_tpu.ops import dense as jdense
from a_nice_rag_tpu.ops import fusion as jfusion
from a_nice_rag_tpu.ops import quantized as jquant
from a_nice_rag_tpu.ops import topk as jtopk
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import from_reference_index
from a_nice_rag_tpu_torch.ops import bm25 as tbm25
from a_nice_rag_tpu_torch.ops import dense as tdense
from a_nice_rag_tpu_torch.ops import fusion as tfusion
from a_nice_rag_tpu_torch.ops import quantized as tquant
from a_nice_rag_tpu_torch.ops import topk as ttopk
from a_nice_rag_tpu_torch.testing.parity import check_top_k

DENSE_ATOL = 1e-5
BM25_ATOL = 1e-4


def _t(x):
    return torch.as_tensor(np.array(x))


def _tied_scores(rng, b=6, n=300):
    # Coarse values force many exact ties, at the k boundary too.
    return (rng.integers(0, 12, size=(b, n)) / 4.0).astype(np.float32)


def test_masked_top_k_tie_rule_matches_lax_top_k():
    rng = np.random.default_rng(1)
    s = _tied_scores(rng)
    mask = rng.random(s.shape) < 0.8
    jv, ji = jtopk.masked_top_k(jnp.asarray(s), 40, jnp.asarray(mask))
    tv, ti = ttopk.masked_top_k(_t(s), 40, _t(mask))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # Tie rule: equal scores come out in ascending id order.
    for r in range(s.shape[0]):
        v, i = tv[r].numpy(), ti[r].numpy()
        same = v[1:] == v[:-1]
        assert (i[1:][same] > i[:-1][same]).all()


def test_masked_top_k_unfilled_slots():
    s = np.zeros((2, 5), np.float32)
    mask = np.array([True, False, True, False, False])
    tv, ti = ttopk.masked_top_k(_t(s), 4, _t(mask)[None, :])
    assert ti.tolist() == [[0, 2, -1, -1], [0, 2, -1, -1]]
    assert np.isneginf(tv.numpy()[:, 2:]).all()


def test_hierarchical_top_k_matches_jax():
    rng = np.random.default_rng(2)
    s = _tied_scores(rng, b=4, n=4096)
    jv, ji = jtopk.hierarchical_top_k(jnp.asarray(s), 32, tile=1024)
    tv, ti = ttopk.hierarchical_top_k(_t(s), 32, tile=1024)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_merge_top_k_matches_jax():
    rng = np.random.default_rng(3)
    v = -np.sort(-_tied_scores(rng, b=12, n=16).reshape(3, 4, 16), axis=-1)
    ids = rng.permutation(3 * 4 * 16).reshape(3, 4, 16).astype(np.int32)
    jv, ji = jtopk.merge_top_k(jnp.asarray(v), jnp.asarray(ids), 10)
    tv, ti = ttopk.merge_top_k(_t(v), _t(ids), 10)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_dedup_ranked_matches_jax():
    rng = np.random.default_rng(4)
    v = -np.sort(-rng.integers(0, 6, size=(8, 20)).astype(np.float32), -1)
    ids = rng.integers(-1, 12, size=(8, 20)).astype(np.int32)
    jv, ji = jtopk.dedup_ranked(jnp.asarray(v), jnp.asarray(ids))
    tv, ti = ttopk.dedup_ranked(_t(v), _t(ids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_top_k_matches_jax(emb_dtype, masked):
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((1500, 48)).astype(np.float32)
    q = rng.standard_normal((9, 48)).astype(np.float32)
    mask = rng.random(1500) < 0.6 if masked else None
    jemb = jnp.asarray(emb, dtype=jnp.dtype(emb_dtype))
    temb = from_np_like(jemb)
    jv, ji = jdense.dense_top_k(
        jemb, jnp.asarray(q), 20,
        mask=None if mask is None else jnp.asarray(mask),
    )
    tv, ti = tdense.dense_top_k(
        temb, _t(q), 20, mask=None if mask is None else _t(mask)
    )
    check_top_k(jv, ji, tv, ti, DENSE_ATOL)
    auto_v, auto_i = tdense.dense_top_k_auto(
        temb, _t(q), 20, mask=None if mask is None else _t(mask)
    )
    np.testing.assert_array_equal(auto_i.numpy(), ti.numpy())


def from_np_like(jarr):
    from a_nice_rag_tpu_torch.index.io import numpy_to_torch

    return numpy_to_torch(np.asarray(jarr), torch.device("cpu"))


def test_dense_scores_upcast_bf16_to_f32():
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((64, 32)).astype(np.float32)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    jemb = jnp.asarray(emb, dtype=jnp.bfloat16)
    js = np.asarray(jdense.dense_scores(jemb, jnp.asarray(q)))
    ts = tdense.dense_scores(from_np_like(jemb), _t(q))
    assert ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), js, atol=DENSE_ATOL)


def test_quantize_bit_exact_and_int8_top_k():
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((700, 40)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[5] = 0.0  # an all-zero row takes the 1e-12 floor
    q = rng.standard_normal((8, 40)).astype(np.float32)
    jq = jquant.quantize_embeddings(jnp.asarray(emb))
    tq = tquant.quantize_embeddings(_t(emb))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    jqv, jqs = jquant.quantize_queries(jnp.asarray(q))
    tqv, tqs = tquant.quantize_queries(_t(q))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tqs.numpy(), np.asarray(jqs))
    js = np.asarray(jquant.quantized_dense_scores(jq, jqv, jqs))
    ts = tquant.quantized_dense_scores(tq, tqv, tqs).numpy()
    np.testing.assert_array_equal(ts, js)
    mask = rng.random(700) < 0.5
    jv, ji = jquant.quantized_dense_top_k(jq, jnp.asarray(q), 15,
                                          jnp.asarray(mask))
    tv, ti = tquant.quantized_dense_top_k(tq, _t(q), 15, _t(mask))
    # Inside one jit XLA may reorder the two scale multiplies: 1 ulp.
    check_top_k(jv, ji, tv, ti, 1e-6)


def test_int8_dot_exact_past_f32_depth():
    rng = np.random.default_rng(8)
    a = rng.integers(-127, 128, size=(3, 2500)).astype(np.int8)
    b = rng.integers(-127, 128, size=(5, 2500)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = tquant.int8_dot(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)


def _lists(rng, l=3, b=5, k=12, n=200):
    idx = np.stack([
        np.stack([rng.permutation(n)[:k] for _ in range(b)]) for _ in range(l)
    ]).astype(np.int32)
    idx[rng.random(idx.shape) < 0.15] = -1
    w = rng.uniform(0.5, 5.0, size=l).astype(np.float32)
    return idx, w


def test_wrrf_scores_and_top_n_match_jax():
    rng = np.random.default_rng(9)
    idx, w = _lists(rng)
    mask = rng.random(200) < 0.7
    js = np.asarray(jfusion.wrrf_scores(jnp.asarray(idx), jnp.asarray(w), 200))
    ts = tfusion.wrrf_scores(_t(idx), _t(w), 200).numpy()
    np.testing.assert_allclose(ts, js, atol=1e-7)
    jv, ji = jfusion.wrrf_top_n(jnp.asarray(idx), jnp.asarray(w), 10, 200,
                                mask=jnp.asarray(mask))
    tv, ti = tfusion.wrrf_top_n(_t(idx), _t(w), 10, 200, mask=_t(mask))
    check_top_k(jv, ji, tv, ti, 1e-7)


def test_wrrf_sparse_matches_jax_and_dense_form():
    rng = np.random.default_rng(10)
    idx, w = _lists(rng)
    jv, ji = jfusion.wrrf_top_n_sparse(jnp.asarray(idx), jnp.asarray(w), 10)
    tv, ti = tfusion.wrrf_top_n_sparse(_t(idx), _t(w), 10)
    check_top_k(jv, ji, tv, ti, 1e-7)
    dv, di = tfusion.wrrf_top_n(_t(idx), _t(w), 10, 200)
    check_top_k(dv, di, tv, ti, 1e-7)


def _bm25_setup(n_docs=400, seed=31):
    # Sized so a query touches ~2k postings: the cumsum cancellation of
    # the sparse forms (~P * eps * mean impact) then stays inside 1e-4.
    c = synth_corpus(n_docs=n_docs, dim=8, n_queries=12, seed=seed,
                     vocab_size=400)
    jidx = jax_build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    terms = jidx.pad_term_ids(c.query_tokens, 16)
    terms[0, :3] = terms[0, 0]  # repeated query term counts each time
    terms[1, 2] = -1
    return jidx, from_reference_index(jidx), terms


def test_bm25_scatter_scores_and_top_k_match_jax():
    jidx, tidx, terms = _bm25_setup()
    js = np.asarray(jbm25.bm25_scores(jidx.bm25, jnp.asarray(terms), 8192))
    ts = tbm25.bm25_scores(tidx.bm25, _t(terms), 8192).numpy()
    np.testing.assert_allclose(ts, js, atol=BM25_ATOL)
    mask = np.asarray(jidx.filter_mask("CG,NG"))
    jv, ji = jbm25.bm25_top_k(jidx.bm25, jnp.asarray(terms), 10,
                              jnp.asarray(mask), budget=8192)
    tv, ti = tbm25.bm25_top_k(tidx.bm25, _t(terms), 10, _t(mask), budget=8192)
    check_top_k(jv, ji, tv, ti, BM25_ATOL)


@pytest.mark.parametrize("fetch", ["flat", "df_cap"])
def test_bm25_sparse_top_k_matches_jax(fetch):
    jidx, tidx, terms = _bm25_setup()
    cap = jbm25.max_df(jidx.bm25) if fetch == "df_cap" else None
    assert tbm25.max_df(tidx.bm25) == jbm25.max_df(jidx.bm25)
    mask = np.asarray(jidx.filter_mask("QS"))
    for m in (None, mask):
        jv, ji = jbm25.bm25_top_k_sparse(
            jidx.bm25, jnp.asarray(terms), 10,
            mask=None if m is None else jnp.asarray(m), budget=8192,
            df_cap=cap,
        )
        tv, ti = tbm25.bm25_top_k_sparse(
            tidx.bm25, _t(terms), 10, mask=None if m is None else _t(m),
            budget=8192, df_cap=cap,
        )
        check_top_k(jv, ji, tv, ti, BM25_ATOL)


def test_bm25_sparse_pads_when_window_narrower_than_k():
    jidx, tidx, terms = _bm25_setup(n_docs=200, seed=33)
    narrow = terms[:, :1]
    jv, ji = jbm25.bm25_top_k_sparse(jidx.bm25, jnp.asarray(narrow), 64,
                                     df_cap=20)
    tv, ti = tbm25.bm25_top_k_sparse(tidx.bm25, _t(narrow), 64, df_cap=20)
    assert tv.shape == (narrow.shape[0], 64)
    check_top_k(jv, ji, tv, ti, BM25_ATOL)


def test_bm25_dense_impact_forms_match_jax():
    jidx, tidx, terms = _bm25_setup()
    np.testing.assert_array_equal(tidx.bm25_dense.impact.numpy(),
                                  np.asarray(jidx.bm25_dense.impact))
    jt = jnp.asarray(terms)
    for jf, tf in ((jbm25.bm25_scores_dense, tbm25.bm25_scores_dense),
                   (jbm25.bm25_scores_dense_gather,
                    tbm25.bm25_scores_dense_gather)):
        js = np.asarray(jf(jidx.bm25_dense, jt))
        ts = tf(tidx.bm25_dense, _t(terms)).numpy()
        np.testing.assert_allclose(ts, js, atol=BM25_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_tier_split_and_top_k_match_jax(dtype):
    jidx, tidx, terms = _bm25_setup()
    jtt = jbm25.split_two_tier(jidx.bm25, v_common=8, dtype=dtype)
    ttt = tbm25.split_two_tier(tidx.bm25, v_common=8, dtype=dtype)
    np.testing.assert_array_equal(ttt.common_map.numpy(),
                                  np.asarray(jtt.common_map))
    np.testing.assert_array_equal(
        ttt.common_impact_t.float().numpy(),
        np.asarray(jtt.common_impact_t).astype(np.float32),
    )
    for f in ("indptr", "doc_ids", "impact"):
        np.testing.assert_array_equal(getattr(ttt.rare, f).numpy(),
                                      np.asarray(getattr(jtt.rare, f)))
    js = np.asarray(jbm25.bm25_scores_two_tier(jtt, jnp.asarray(terms), 4096))
    ts = tbm25.bm25_scores_two_tier(ttt, _t(terms), 4096).numpy()
    np.testing.assert_allclose(ts, js, atol=BM25_ATOL)
    mask = np.asarray(jidx.filter_mask("CG"))
    rare_cap = int(np.diff(np.asarray(jtt.rare.indptr)).max())
    for cap in (None, rare_cap):
        jv, ji = jbm25.bm25_top_k_two_tier(
            jtt, jnp.asarray(terms), 10, mask=jnp.asarray(mask),
            budget=4096, block_q=4, block_n=1024, interpret=True, df_cap=cap,
        )
        tv, ti = tbm25.bm25_top_k_two_tier(
            ttt, _t(terms), 10, mask=_t(mask), budget=4096, df_cap=cap,
        )
        check_top_k(jv, ji, tv, ti, BM25_ATOL)
    need = tbm25.postings_required(ttt.rare, _t(terms)).numpy()
    np.testing.assert_array_equal(
        need, np.asarray(jbm25.postings_required(jtt.rare, jnp.asarray(terms)))
    )
