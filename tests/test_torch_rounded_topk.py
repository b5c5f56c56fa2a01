"""The rounded fold (K1r / K2r) of the port against the JAX package's
``algo="packed"`` (the TPU bodies ``_kernel_packed`` and
``_kernel_packed_int8``), run in interpret mode as its own tests run it.

On the CPU the port's wrappers take their plain versions: scores rounded
to bf16 (to nearest, ties to even), the top k under (score desc, id asc).
The same seeded numpy inputs go through both packages.

Tolerances and what is compared:
- bf16-exact inputs (integer grids, int8 with unit scales): values equal
  exactly; ids equal to an independent numpy ranking of the rounded
  scores, and to the JAX kernel's up to its order among equal values. The
  TPU kernel keeps the boundary ties its eviction order leaves (not
  always the lower id: its own tests compare the selected scores), so
  its ids are held through ``check_top_k`` at atol 0.
- random normals: sorted values within rtol 8e-3 / atol 1e-6 (the JAX
  test's own tolerance); id sets equal on every row whose k-th and
  (k+1)-th rounded scores differ.
- int8 with random scales: values equal exactly (the same f32 product
  float(acc) * doc scale is rounded, then times the query scale).
- masked or misaligned calls: the exact fold in both packages.
- bf16 -0.0 ranks below +0.0 in both.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.ops.pallas import (
    FusedKernelConfig,
    fused_dense_top_k as jax_fused,
    fused_dense_top_k_int8 as jax_fused_int8,
)
from a_nice_rag_tpu.ops.quantized import quantize_embeddings, quantize_queries
from a_nice_rag_tpu.parallel import make_mesh as jax_make_mesh
from a_nice_rag_tpu.parallel import shard_index as jax_shard_index
from a_nice_rag_tpu.parallel.sharded import ShardedRetriever as JaxSharded
from a_nice_rag_tpu.retrieval import FusedRetriever as JaxRetriever
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.ops import kernels
from a_nice_rag_tpu_torch.ops.kernels import (
    fused_dense_top_k,
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_rounded,
    fused_dense_top_k_rounded,
)
from a_nice_rag_tpu_torch.ops.kernels.autotune import (
    KernelConfig,
    _memory_cache,
    _signature,
    pick_fastest,
    rounded_candidates,
    tune_fused_blocks,
)
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    TAU_STRIDE,
    _lowered,
    round_scores,
)
from a_nice_rag_tpu_torch.parallel import (
    ShardedRetriever,
    make_mesh,
    shard_index,
)
from a_nice_rag_tpu_torch.retrieval import FusedRetriever
from a_nice_rag_tpu_torch.testing.parity import check_top_k

MODEL = "voyage-3-large"
W = {MODEL: 5.0, "BM25": 1.0}
VALUE_RTOL, VALUE_ATOL = 8e-3, 1e-6
GRID_SHAPES = [(2048, 64, 32, 8), (4096, 64, 24, 16), (3072, 128, 16, 5)]
MISALIGNED = (1536, 32, 8, 4)


def _t(x):
    return torch.as_tensor(np.array(x))


def _block_q(b):
    return 16 if b % 16 == 0 else 8


def _rounded_np(scores):
    """Independent numpy rounding: bf16 (ml_dtypes, to nearest even) back
    to f32, and a ranking key that puts -0.0 below +0.0."""
    r = np.asarray(scores, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)
    key = np.where((r == 0) & np.signbit(r), -np.float32(1e-45), r)
    return r, key


def _ranked_ids(key, k):
    n = key.shape[1]
    return np.stack([np.lexsort((np.arange(n), -row))[:k] for row in key])


def _sorted_rows(vals, ids):
    """Each row by (value desc, id asc), -0.0 below +0.0."""
    vals, ids = np.asarray(vals), np.asarray(ids)
    keys = _rounded_np(vals)[1]
    order = np.stack([np.lexsort((i, -v)) for v, i in zip(keys, ids)])
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


def _hold_exact(jax_out, port_out, scores, k, rounded=True):
    """bf16-exact scores: values equal, ids the numpy ranking's, and the
    JAX kernel's up to its choice among the k-th value's ties."""
    jv, ji = _sorted_rows(*jax_out)
    tv, ti = port_out[0].numpy(), port_out[1].numpy()
    np.testing.assert_array_equal(tv, jv)
    if rounded:
        _, key = _rounded_np(scores)
    else:
        key = scores
    np.testing.assert_array_equal(ti, _ranked_ids(key, k))
    check_top_k(jv, ji, tv, ti, 0.0)
    above = tv > tv[:, -1:]
    np.testing.assert_array_equal(ti[above], ji[above])


@pytest.mark.parametrize("block_n", [512, 1024])
@pytest.mark.parametrize("levels", [(-1.0, 1.0), (-1.0, 0.0, 1.0)],
                         ids=["pm1", "tri"])
@pytest.mark.parametrize("shape", GRID_SHAPES + [MISALIGNED],
                         ids=lambda s: "x".join(map(str, s)))
def test_integer_grid_matches_packed(shape, levels, block_n):
    """Integer scores (bf16-exact up to 256): ties everywhere, across
    tiles and the k boundary. The misaligned shape takes the exact fold in
    both packages."""
    n, d, b, k = shape
    rng = np.random.default_rng([n, len(levels), block_n])
    emb = rng.choice(levels, (n, d)).astype(np.float32)
    # Duplicated rows further on: exact ties across tiles.
    emb[n // 2:n // 2 + 64] = emb[:64]
    q = rng.choice([-1.0, 1.0], (b, d)).astype(np.float32)
    jax_out = jax_fused(jnp.asarray(emb), jnp.asarray(q), k=k,
                        block_q=_block_q(b), block_n=block_n,
                        algo="packed", interpret=True)
    port = fused_dense_top_k(_t(emb), _t(q), k, rounded=True)
    aligned = n % kernels.fused_topk.ROUNDED_ALIGN == 0
    _hold_exact(jax_out, port, q @ emb.T, k, rounded=aligned)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GRID_SHAPES + [MISALIGNED],
                         ids=lambda s: "x".join(map(str, s)))
def test_random_normals_match_packed(shape, dtype):
    n, d, b, k = shape
    rng = np.random.default_rng(n + d)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    jemb = jnp.asarray(emb, dtype=jnp.dtype(dtype))
    temb = _t(emb).to(getattr(torch, dtype))
    jv, ji = jax_fused(jemb, jnp.asarray(q), k=k, block_q=_block_q(b),
                       block_n=1024, algo="packed", interpret=True)
    tv, ti = fused_dense_top_k(temb, _t(q), k, rounded=True)
    np.testing.assert_allclose(np.sort(tv.numpy(), 1),
                               np.sort(np.asarray(jv), 1),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)
    scores = q @ temb.float().numpy().T
    r = _rounded_np(scores)[0] if n % 1024 == 0 else scores
    kth = -np.sort(-r, 1)[:, k - 1:k + 1]
    clear = kth[:, 0] != kth[:, 1]
    assert clear.sum() >= b // 2
    for row in np.flatnonzero(clear):
        assert set(ti[row].tolist()) == set(np.asarray(ji)[row].tolist())


def test_rounded_values_are_bf16_within_half_an_ulp():
    """The rounded fold returns bf16 values: each is an exact bf16, and
    the rounding moved each score by at most half a bf16 ulp (2^-8 of
    it)."""
    rng = np.random.default_rng(5)
    emb = _t(rng.standard_normal((2048, 48)).astype(np.float32))
    q = _t(rng.standard_normal((6, 48)).astype(np.float32))
    tv, ti = fused_dense_top_k(emb, q, 12, rounded=True)
    assert torch.equal(tv, tv.to(torch.bfloat16).float())
    exact = (q @ emb.T).gather(1, ti.long())
    assert bool(((tv - exact).abs() <= exact.abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("scales", ["unit", "random"])
def test_int8_matches_packed(scales):
    rng = np.random.default_rng(121 if scales == "unit" else 122)
    n, d, b, k = 3072, 64, 16, 10
    if scales == "unit":
        vals = rng.integers(-90, 91, (n, d)).astype(np.int8)
        sc = np.ones(n, np.float32)
        qv = rng.integers(-90, 91, (b, d)).astype(np.int8)
        qs = np.ones(b, np.float32)
    else:
        emb = rng.standard_normal((n, d)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        qd = quantize_embeddings(jnp.asarray(emb))
        jqv, jqs = quantize_queries(
            jnp.asarray(rng.standard_normal((b, d)).astype(np.float32)))
        vals, sc = np.asarray(qd.values), np.asarray(qd.scales)
        qv, qs = np.asarray(jqv), np.asarray(jqs)
    jax_out = jax_fused_int8(jnp.asarray(vals), jnp.asarray(sc),
                             jnp.asarray(qv), jnp.asarray(qs), k,
                             block_q=16, block_n=1024, algo="packed",
                             interpret=True)
    port = fused_dense_top_k_int8(_t(vals), _t(sc), _t(qv), _t(qs), k,
                                  rounded=True)
    sel = (qv.astype(np.int32) @ vals.astype(np.int32).T).astype(
        np.float32) * sc[None, :]
    jv, ji = _sorted_rows(*jax_out)
    tv, ti = port[0].numpy(), port[1].numpy()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, _ranked_ids(_rounded_np(sel)[1], k))
    check_top_k(jv, ji, tv, ti, 0.0)
    # The values: the rounded selection score times the query scale.
    want = np.take_along_axis(_rounded_np(sel)[0], ti, 1) * qs[:, None]
    np.testing.assert_array_equal(tv, want)


def test_masked_calls_take_the_exact_fold():
    """A mask (and, for K2, the same) routes algo="packed" to the exact
    fold in the JAX package and rounded=True to K1 / K2 in the port."""
    rng = np.random.default_rng(119)
    n, d, b, k = 3072, 64, 16, 8
    emb = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(n) > 0.4
    jv, ji = jax_fused(jnp.asarray(emb), jnp.asarray(q), k=k, block_q=16,
                       block_n=1024, mask=jnp.asarray(mask), algo="packed",
                       interpret=True)
    xv, xi = jax_fused(jnp.asarray(emb), jnp.asarray(q), k=k, block_q=16,
                       block_n=1024, mask=jnp.asarray(mask),
                       algo="iterate", interpret=True)
    np.testing.assert_array_equal(np.asarray(ji), np.asarray(xi))
    tv, ti = fused_dense_top_k(_t(emb), _t(q), k, mask=_t(mask),
                               rounded=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    assert not torch.equal(tv, tv.to(torch.bfloat16).float())  # exact
    vals = rng.integers(-90, 91, (n, d)).astype(np.int8)
    qv = rng.integers(-90, 91, (b, d)).astype(np.int8)
    ones_n, ones_b = np.ones(n, np.float32), np.ones(b, np.float32)
    jv8, j8 = jax_fused_int8(jnp.asarray(vals), jnp.asarray(ones_n),
                             jnp.asarray(qv), jnp.asarray(ones_b), k,
                             block_q=16, block_n=1024, algo="packed",
                             mask=jnp.asarray(mask), interpret=True)
    t8 = fused_dense_top_k_int8(_t(vals), _t(ones_n), _t(qv), _t(ones_b),
                                k, mask=_t(mask), rounded=True)
    e8 = fused_dense_top_k_int8(_t(vals), _t(ones_n), _t(qv), _t(ones_b),
                                k, mask=_t(mask))
    assert torch.equal(t8[0], e8[0]) and torch.equal(t8[1], e8[1])
    check_top_k(jv8, j8, e8[0], e8[1], 0.0)


def test_rounded_wrappers_take_aligned_maskless_calls_only():
    emb, q = torch.zeros((1536, 8)), torch.zeros((2, 8))
    with pytest.raises(ValueError, match="multiple of 1024"):
        fused_dense_top_k_rounded(emb, q, 4)
    v8 = torch.zeros((1536, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 1024"):
        fused_dense_top_k_int8_rounded(v8, torch.ones(1536),
                                       v8[:2], torch.ones(2), 4)
    before = (fused_dense_top_k_rounded.launches,
              fused_dense_top_k_int8_rounded.launches)
    fused_dense_top_k(emb[:1024], q, 4, rounded=True)
    assert (fused_dense_top_k_rounded.launches,
            fused_dense_top_k_int8_rounded.launches) == before  # CPU


def test_signed_zero_ranks_below_positive_zero():
    """int8 rows with doc scales of both signs against a zero query row:
    float(0) * scale is +0.0 or -0.0, and the packed key ranks -0.0 below
    +0.0 (and above every negative score); the float path's zero query
    scores +0.0 everywhere in both packages."""
    rng = np.random.default_rng(9)
    n, d, b, k = 2048, 16, 8, 8
    vals = rng.integers(-4, 5, (n, d)).astype(np.int8)
    sc = -np.ones(n, np.float32)
    plus = rng.choice(n, 3, replace=False)
    sc[plus] = 1.0
    qv = rng.integers(-4, 5, (b, d)).astype(np.int8)
    qv[0] = 0
    qs = np.ones(b, np.float32)
    jv, ji = jax_fused_int8(jnp.asarray(vals), jnp.asarray(sc),
                            jnp.asarray(qv), jnp.asarray(qs), k,
                            block_q=8, block_n=1024, algo="packed",
                            interpret=True)
    tv, ti = fused_dense_top_k_int8(_t(vals), _t(sc), _t(qv), _t(qs), k,
                                    rounded=True)
    jv, ji = _sorted_rows(jv, ji)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.signbit(tv), np.signbit(jv))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti[0, :3], np.sort(plus))
    assert not np.signbit(tv[0, :3]).any() and np.signbit(tv[0, 3:]).all()
    # The rest of row 0: the lowest -0.0 ids (the port's rule).
    minus = np.setdiff1d(np.arange(n), plus)[:k - 3]
    np.testing.assert_array_equal(ti[0, 3:], minus)
    check_top_k(jv, ji, tv, ti, 0.0)
    sel = (qv.astype(np.int32) @ vals.astype(np.int32).T).astype(
        np.float32) * sc[None, :]
    np.testing.assert_array_equal(ti, _ranked_ids(_rounded_np(sel)[1], k))
    emb = rng.standard_normal((n, d)).astype(np.float32)
    qz = np.zeros((2, d), np.float32)
    fjv, fji = jax_fused(jnp.asarray(emb), jnp.asarray(qz), k=k, block_q=2,
                         block_n=1024, algo="packed", interpret=True)
    ftv, fti = fused_dense_top_k(_t(emb), _t(qz), k, rounded=True)
    np.testing.assert_array_equal(fti.numpy(), np.asarray(fji))
    np.testing.assert_array_equal(np.signbit(ftv.numpy()),
                                  np.signbit(np.asarray(fjv)))


def test_round_scores_order_and_tau_bound():
    """round_scores: bf16 to nearest even, -0.0 carried between the
    negative bf16s and +0.0. The warm start's lowered k-th best of a
    subsample of rounded scores stays at or below the k-th best of all
    of them, so seeding the lists with it keeps the result (the kernel's
    tau pass rounds the subsample exactly as the main pass rounds it)."""
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0, 0.0,
                      -2.0 ** -133, 2.0 ** -140, -1.0e-45])
    r = round_scores(x)
    assert r[:2].tolist() == [1.0, 1.0 + 2.0 ** -6]
    assert r[2].view(torch.int32) == r[6].view(torch.int32) == -0x7FFFFFFF
    assert r[3] == 0.0 and r[5] == 0.0 and r[4] == -(2.0 ** -133)
    assert bool(r[4] < r[2] < r[3])
    rng = np.random.default_rng(17)
    n, d, b = 8192, 32, 12
    emb = _t(rng.integers(-2, 3, (n, d)).astype(np.float32))
    q = _t(rng.choice([-1.0, 0.0, 1.0], (b, d)).astype(np.float32))
    s = round_scores(q @ emb.T)
    for k in (1, 25, 128):
        kth = torch.topk(s[:, ::TAU_STRIDE], k, dim=1).values[:, -1]
        tau = _lowered(kth)
        assert bool((tau <= torch.topk(s, k, dim=1).values[:, -1]).all())
        v, i = kernels.fused_topk._plain_top_k(
            kernels.fused_topk._float_scores(emb, q, None, True), n, b, d,
            k, emb.device, tau=tau)
        ref = fused_dense_top_k(emb, q, k, rounded=True)
        assert torch.equal(i, ref[1])


@pytest.fixture(scope="module")
def corpus():
    c = synth_corpus(n_docs=4096, dim=32, n_queries=16, seed=23)
    args = dict(ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings=c.embeddings, token_lists=c.tokens)
    return c, build_index(device="cpu", **args), jax_build_index(**args)


def _call(retr, c, idx):
    return retr({MODEL: c.query_embeddings[MODEL]},
                idx.pad_term_ids(c.query_tokens, 16), W, None, 40.0)


def _hold_dense(dense, j_dense, emb, q, k):
    """A retriever's rounded dense list [B, k]: K1r's plain version's ids,
    and the JAX packed retriever's up to the TPU kernel's choice among
    equal values. Returns the rows where the two lists are equal."""
    want = fused_dense_top_k(emb, q, k, rounded=True)
    np.testing.assert_array_equal(dense, want[1].numpy())
    j_vals = np.take_along_axis(round_scores(q @ emb.float().T).numpy(),
                                j_dense, 1)
    check_top_k(*_sorted_rows(j_vals, j_dense), want[0], want[1], 0.0)
    rows = (dense == j_dense).all(axis=1)
    assert rows.sum() >= len(rows) // 4
    return rows


def test_fused_retriever_rounded_at_an_untuned_batch(corpus):
    """KernelConfig(rounded=True) tuned at batch 64, called at 16: the plan
    is dropped, the rounding is not. The dense list is K1r's and the JAX
    retriever's with FusedKernelConfig(..., "packed") (``_hold_dense``);
    where the two dense lists are equal, so are the fused ids."""
    c, idx, jidx = corpus
    kw = dict(use_bm25=True, similarity_k=10, common_sections_n=5)
    cfg = KernelConfig(16, 1, batch=64, rounded=True)
    fr = FusedRetriever(idx, (MODEL,), dense_backend="kernel",
                        kernel_config=cfg, **kw)
    jfr = JaxRetriever(jidx, (MODEL,), dense_backend="pallas",
                       pallas_config=FusedKernelConfig(128, 1024, 2,
                                                       "packed"), **kw)
    ids, _, lists = _call(fr, c, idx)
    j_ids, _, j_lists = _call(jfr, c, jidx)
    rows = _hold_dense(np.asarray(lists)[0], np.asarray(j_lists)[0],
                       idx.dense[MODEL],
                       torch.as_tensor(c.query_embeddings[MODEL]), 10)
    np.testing.assert_array_equal(np.asarray(ids)[rows],
                                  np.asarray(j_ids)[rows])
    exact = _call(FusedRetriever(idx, (MODEL,), dense_backend="kernel",
                                 kernel_config=cfg._replace(rounded=False),
                                 **kw), c, idx)[2]
    assert not np.array_equal(np.asarray(exact), np.asarray(lists))


def test_sharded_retriever_rounded_on_every_shard(corpus):
    """4 CPU slots of 1024 rows each: every shard takes the rounded fold.
    The merged lists and fused ids equal the unsharded rounded
    retriever's. Against the JAX sharded retriever with the packed config
    over 4 devices: its dense-only fused ids (its merged dense list) are
    held as the unsharded list is (``_hold_dense``), and where the dense
    lists are equal the hybrid fused ids hold the same documents
    (tests/test_torch_parallel.py's rule for exact WRRF ties)."""
    import jax

    c, idx, jidx = corpus
    qd = {MODEL: c.query_embeddings[MODEL]}
    terms = idx.pad_term_ids(c.query_tokens, 16)
    sidx = shard_index(idx, make_mesh(shape=(1, 4), devices=["cpu"] * 4))
    jsidx = jax_shard_index(jidx, jax_make_mesh(
        shape=(1, 4), axis_names=("dp", "corpus"),
        devices=jax.devices()[:4]))
    assert sidx.n_local % 1024 == 0
    packed = FusedKernelConfig(128, 1024, 2, "packed")
    out = {}
    for bm25, n in ((True, 5), (False, 10)):
        kw = dict(use_bm25=bm25, similarity_k=10, common_sections_n=n)
        w = W if bm25 else {MODEL: 1.0}
        sr = ShardedRetriever(sidx, (MODEL,), dense_backend="kernel",
                              kernel_config=KernelConfig(rounded=True), **kw)
        s_ids, _, s_lists = sr.retrieve_lists(qd, terms, w, None, 40.0)
        fr = FusedRetriever(idx, (MODEL,), dense_backend="kernel",
                            kernel_config=KernelConfig(rounded=True), **kw)
        ids, _, lists = fr(qd, terms, w, None, 40.0)
        np.testing.assert_array_equal(np.asarray(s_ids), ids)
        np.testing.assert_array_equal(np.asarray(s_lists), np.asarray(lists))
        jsr = JaxSharded(jsidx, (MODEL,), dense_backend="pallas",
                         pallas_config=packed, **kw)
        out[bm25] = (np.asarray(s_ids), np.asarray(s_lists)[0],
                     np.asarray(jsr(qd, terms, w, None, 40.0)[1]))
    s_dense, _, j_dense = out[False]
    rows = _hold_dense(s_dense, j_dense, idx.dense[MODEL],
                       torch.as_tensor(c.query_embeddings[MODEL]), 10)
    s_ids, _, j_ids = out[True]
    for a, b in zip(s_ids[rows], j_ids[rows]):
        assert set(a.tolist()) == set(b.tolist())


def test_tuner_returns_the_rounded_default_off_the_card():
    rng = np.random.default_rng(0)
    emb = _t(rng.standard_normal((2048, 32)).astype(np.float32))
    q = _t(rng.standard_normal((16, 32)).astype(np.float32))
    assert tune_fused_blocks(emb, q, 8, allow_rounded=True) == \
        KernelConfig(rounded=True)
    assert tune_fused_blocks(emb, q, 8) == KernelConfig()
    assert _signature(emb, 16, 8) + ":rounded" not in _memory_cache


def test_tuner_holds_rounded_candidates_to_the_rounded_default():
    """The id guard compares a rounded candidate with the rounded default
    plan, an exact one with the exact default; both kinds can win."""
    cands = rounded_candidates((KernelConfig(16, 2), KernelConfig(64, 4)))
    assert cands[2:] == (KernelConfig(16, 2, rounded=True),
                         KernelConfig(64, 4, rounded=True))
    ids = {False: torch.arange(4), True: torch.arange(4) + 1}
    ms = {cands[0]: 3.0, cands[1]: 2.0, cands[2]: 1.0, cands[3]: 0.5}

    def run(cfg):
        if cfg.bq == 64 and cfg.rounded:
            return ids[False]  # diverges from the rounded default
        return ids[cfg.rounded]

    best, timed = pick_fastest(run, ms.__getitem__, cands)
    assert best == KernelConfig(16, 2, rounded=True)
    assert set(timed) == set(cands[:3])


def test_build_state_pallas_rounded_serves_the_gold(corpus, monkeypatch):
    """build_state(rounded_fold=True) (the JAX build_state's
    pallas_rounded=True) serves KernelConfig(rounded=True) and answers
    /v1/search with the planted gold (tests/test_serve_cli.py's case);
    main's --rounded-fold, and the JAX CLI's --pallas-rounded, reach
    build_state; the sharded route stays on the exact fold, as the JAX
    CLI's does; a flag of any other name is rejected."""
    import json
    import urllib.request

    from a_nice_rag_tpu_torch.serving import serve_cli
    from a_nice_rag_tpu_torch.serving.serve_cli import (
        build_state,
        serve_state,
    )

    c, idx, _ = corpus
    state = build_state(idx, (MODEL,), use_bm25=True, rounded_fold=True)
    assert isinstance(state.retriever, FusedRetriever)
    assert state.retriever.kernel_config == KernelConfig(rounded=True)
    srv = serve_state(state, W, port=0, background=True)
    try:
        port = srv.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/search",
            data=json.dumps({
                "query_embedding":
                    c.query_embeddings[MODEL][0].tolist(),
                "terms": idx.pad_term_ids(c.query_tokens, 16)[0].tolist(),
            }).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["results"][0]["id"] == c.gold_ids[0]
    finally:
        srv.shutdown()
    served = []

    def capture(state, w, **kw):
        served.append(state.retriever.kernel_config)

    monkeypatch.setattr(serve_cli, "serve_state", capture)
    serve_cli.main(["--demo", "--device", "cpu", "--pallas-rounded"])
    serve_cli.main(["--demo", "--device", "cpu", "--rounded-fold",
                    "--shards", "2"])
    serve_cli.main(["--demo", "--device", "cpu"])
    assert served == [KernelConfig(rounded=True), None, None]
    for flag in ("--unknown-flag", "--foo-rounded", "--no-rounded",
                 "--pallas-rounded=1"):
        with pytest.raises(SystemExit):
            serve_cli.main(["--demo", "--device", "cpu", flag])
    assert len(served) == 3
