"""The port's corpus-sharded retrieval against the JAX package's.

Mirrors tests/test_parallel.py: the JAX package runs on the 8-device
virtual CPU mesh that tests/conftest.py forces, the port on an 8-slot
virtual mesh of "cpu", both from the same seeded corpus. The port's
kernel wrappers take their plain versions on CPU tensors (the JAX
package's Pallas kernels run in interpret mode). Also covered: the slot
mesh itself and ``spherical_kmeans_batched``.

Tolerances: dense ids equal and values within 1e-5 relative (f32 sums of
the same products in another order); fused WRRF scores within 1e-5
relative with equal id sets (order may differ among exact RRF ties);
BM25 scores within 1e-5 relative + 1e-6 (segment totals summed in
another order); int8 ids equal, values within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.ops import kmeans as jkm
from a_nice_rag_tpu.parallel import make_mesh as jax_make_mesh
from a_nice_rag_tpu.parallel import shard_index as jax_shard_index
from a_nice_rag_tpu.parallel import sharded_dense_top_k as jax_sharded_top_k
from a_nice_rag_tpu.parallel.sharded import ShardedRetriever as JaxSharded
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.ops import bm25_scores, dense_top_k
from a_nice_rag_tpu_torch.ops import kmeans as tkm
from a_nice_rag_tpu_torch.ops.fusion import wrrf_top_n, wrrf_top_n_sparse
from a_nice_rag_tpu_torch.ops.quantized import quantized_dense_top_k
from a_nice_rag_tpu_torch.ops.topk import masked_top_k
from a_nice_rag_tpu_torch.parallel import (
    DeviceMesh,
    Slot,
    make_mesh,
    shard_index,
    sharded_dense_top_k,
)
from a_nice_rag_tpu_torch.parallel.sharded import (
    ShardedRetriever,
    hierarchical_gather_merge,
)
from a_nice_rag_tpu_torch.retrieval import FusedRetriever

MODEL = "voyage-3-large"
MODELS = [MODEL]
CPU8 = ["cpu"] * 8
RTOL = 1e-5
W = {MODEL: 5.0, "BM25": 1.0}


def _indexes(c, **kw):
    args = dict(ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings=c.embeddings, token_lists=c.tokens, **kw)
    return jax_build_index(**args), build_index(device="cpu", **args)


@pytest.fixture(scope="module")
def setup():
    c = synth_corpus(n_docs=900, dim=64, n_queries=16, seed=41,
                     models=MODELS)
    jidx, idx = _indexes(c)
    jsidx = jax_shard_index(jidx, jax_make_mesh(shape=(2, 4),
                                                axis_names=("dp", "corpus")))
    mesh = make_mesh(shape=(2, 4), axis_names=("dp", "corpus"),
                     devices=CPU8)
    return c, jidx, jsidx, idx, mesh, shard_index(idx, mesh)


def _same_sets(a, b):
    for ra, rb in zip(a, b):
        assert set(ra[ra >= 0].tolist()) == set(rb[rb >= 0].tolist())


def test_mesh_shapes(setup):
    c, jidx, jsidx, idx, mesh, sidx = setup
    assert len(mesh.slots) == 8 and mesh.shape == {"dp": 2, "corpus": 4}
    assert sidx.n_shards == 4 and sidx.n_dp == 2
    assert sidx.n_local == jsidx.n_local and sidx.n_local % 128 == 0
    assert sidx.n_local * 4 >= idx.n_docs_padded
    # One device: the two dp groups share their shard objects, and the
    # shards that need no pad rows are views of the base matrix.
    assert sidx.replicas[0] is not sidx.replicas[1]
    assert all(a is b for a, b in zip(*sidx.replicas))
    base = idx.dense[MODEL]
    for sh in sidx.shards:
        view = sh.dense[MODEL].untyped_storage().data_ptr() \
            == base.untyped_storage().data_ptr()
        assert view == (sh.offset + sidx.n_local <= idx.n_docs_padded)
        assert sh.offset == sidx.shards.index(sh) * sidx.n_local


def test_sharded_dense_matches_single_device(setup):
    c, jidx, jsidx, idx, mesh, sidx = setup
    q = c.query_embeddings[MODEL]
    vals, ids = sharded_dense_top_k(sidx, MODEL, q, 25)
    jvals, jids = jax_sharded_top_k(jsidx, MODEL, q, 25)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(vals.numpy(), jvals, rtol=RTOL, atol=1e-6)
    v1, i1 = dense_top_k(idx.dense[MODEL], torch.as_tensor(q), 25,
                         mask=idx.filter_mask(None))
    np.testing.assert_array_equal(ids.numpy(), i1.numpy())
    np.testing.assert_allclose(vals.numpy(), v1.numpy(), rtol=RTOL,
                               atol=1e-6)


def test_sharded_dense_with_filter(setup):
    c, jidx, jsidx, idx, mesh, sidx = setup
    q = c.query_embeddings[MODEL][:4]
    vals, ids = sharded_dense_top_k(sidx, MODEL, q, 10, "NG")
    _, jids = jax_sharded_top_k(jsidx, MODEL, q, 10, "NG")
    np.testing.assert_array_equal(ids.numpy(), jids)
    for row in ids.numpy():
        for i in row:
            assert c.sources[int(i)].upper().startswith("NG")
    # Filtered shards keep their masks; unfiltered shards without pad
    # rows drop theirs.
    assert all(m is not None for m in sidx.filter_mask("NG")[0])
    pads = [sh.offset + sidx.n_local > idx.n_docs for sh in sidx.shards]
    assert [m is not None for m in sidx.filter_mask(None)[0]] == pads


def test_wrrf_sparse_matches_dense_impl():
    from a_nice_rag_tpu.ops import wrrf_top_n_sparse as jax_sparse

    rng = np.random.default_rng(43)
    l, b, k, n_pad = 3, 5, 20, 512
    idx = rng.integers(0, 400, size=(l, b, k)).astype(np.int32)
    idx[0, 0, -3:] = -1  # padding
    w = torch.tensor([5.0, 2.0, 1.0])
    v1, i1 = wrrf_top_n(torch.as_tensor(idx), w, 10, n_pad, k_rrf=40.0)
    v2, i2 = wrrf_top_n_sparse(torch.as_tensor(idx), w, 10, k_rrf=40.0)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=1e-6)
    jv, ji = jax_sparse(jnp.asarray(idx), jnp.asarray(w.numpy()), 10,
                        k_rrf=40.0)
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji))
    for bq in range(b):
        vals = v1.numpy()[bq]
        for j in range(10):
            if (np.abs(vals - vals[j]) < 1e-9).sum() == 1:
                assert int(i1[bq, j]) == int(i2[bq, j])


def test_sharded_hybrid_matches_fused_single_device(setup):
    c, jidx, jsidx, idx, mesh, sidx = setup
    terms = idx.pad_term_ids(c.query_tokens, 16)
    q = {MODEL: c.query_embeddings[MODEL]}
    kw = dict(use_bm25=True, similarity_k=12, common_sections_n=10,
              budget=4096)
    retr = ShardedRetriever(sidx, MODELS, **kw)
    s_vals, s_ids = retr(q, terms, W, None, 40.0)
    f_ids, f_vals, f_lists = FusedRetriever(idx, MODELS, **kw)(
        q, terms, W, None, 40.0)
    # The merged per-ranker lists: the dense one equal to the unsharded
    # list, the BM25 one equal as sets (near-tie totals may swap).
    _, _, lists = retr.retrieve_lists(q, terms, W, None, 40.0)
    np.testing.assert_array_equal(lists[0].numpy(), f_lists[0])
    _same_sets(lists[1].numpy(), f_lists[1])
    with pytest.raises(ValueError, match="ranker"):
        ShardedRetriever(sidx, [], use_bm25=False)
    j_vals, j_ids = JaxSharded(jsidx, MODELS, **kw)(q, terms, W, None, 40.0)
    np.testing.assert_allclose(s_vals, f_vals, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(s_vals, j_vals, rtol=RTOL, atol=1e-7)
    _same_sets(s_ids, f_ids)
    _same_sets(s_ids, j_ids)


def test_sharded_bm25_scores_exact(setup):
    """Per-shard CSR with global stats reproduces the global BM25 scores,
    and each shard's postings equal the JAX package's."""
    c, jidx, jsidx, idx, mesh, sidx = setup
    terms = torch.as_tensor(idx.pad_term_ids(c.query_tokens[:4], 16))
    global_scores = bm25_scores(idx.bm25, terms, budget=4096).numpy()
    parts = [bm25_scores(sh.bm25, terms, budget=4096).numpy()
             for sh in sidx.shards]
    stitched = np.concatenate(parts, axis=1)[:, :idx.n_docs_padded]
    np.testing.assert_allclose(stitched, global_scores, rtol=RTOL, atol=1e-6)
    for s, sh in enumerate(sidx.shards):
        nnz = sh.bm25.nnz
        np.testing.assert_array_equal(sh.bm25.indptr.numpy(),
                                      np.asarray(jsidx.bm25_indptr)[s])
        np.testing.assert_array_equal(sh.bm25.doc_ids[:nnz].numpy(),
                                      np.asarray(jsidx.bm25_doc_ids)[s][:nnz])
        np.testing.assert_array_equal(sh.bm25.impact[:nnz].numpy(),
                                      np.asarray(jsidx.bm25_impact)[s][:nnz])


def test_sharded_kernel_backend_matches_torch(setup):
    """The kernel route per shard (K1's plain version on CPU tensors)
    against materialized scores, and the JAX package's Pallas route."""
    c, jidx, jsidx, idx, mesh, sidx = setup
    weights = {MODEL: 1.0}
    q = c.query_embeddings[MODEL][:8]
    kw = dict(use_bm25=False, similarity_k=16, common_sections_n=16)
    r_k = ShardedRetriever(sidx, MODELS, dense_backend="kernel", **kw)
    r_t = ShardedRetriever(sidx, MODELS, dense_backend="torch", **kw)
    assert r_k.use_kernel and not r_t.use_kernel
    _, ids_k = r_k({MODEL: q}, None, weights, None, 40.0)
    _, ids_t = r_t({MODEL: q}, None, weights, None, 40.0)
    np.testing.assert_array_equal(ids_k, ids_t)
    qp = np.zeros((128, q.shape[1]), np.float32)
    qp[:8] = q
    _, jids = JaxSharded(jsidx, MODELS, dense_backend="pallas", **kw)(
        {MODEL: qp}, None, weights, None, 40.0)
    np.testing.assert_array_equal(ids_k, jids[:8])


def test_hierarchical_multihost_merge():
    """2 hosts x 4 shards of 128 docs: the two-level merge equals brute
    force and the JAX package's hierarchical merge."""
    from jax.sharding import Mesh, PartitionSpec as P
    from a_nice_rag_tpu.ops.dense import dense_scores as jax_scores
    from a_nice_rag_tpu.ops.topk import masked_top_k as jax_top_k
    from a_nice_rag_tpu.parallel.sharded import (
        hierarchical_gather_merge as jax_merge,
    )

    n, d, b, k = 1024, 32, 4, 10
    rng = np.random.default_rng(47)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    n_local = n // 8
    vals, gidx = [], []
    for s in range(8):
        scores = torch.as_tensor(q) @ torch.as_tensor(
            emb[s * n_local:(s + 1) * n_local]).T
        v, i = masked_top_k(scores, k)
        vals.append(v)
        gidx.append(i + s * n_local)
    mv, mi = hierarchical_gather_merge(vals, gidx, k, 4, torch.device("cpu"))
    expect = np.argsort(-(q @ emb.T), axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(mi.numpy(), expect)

    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("dcn", "ici"))

    def shard_fn(e_l, q_l):
        v, i = jax_top_k(jax_scores(e_l, q_l), k)
        shard = jax.lax.axis_index("dcn") * 4 + jax.lax.axis_index("ici")
        return jax_merge(v, i + shard * n_local, k, "ici", "dcn")

    jv, ji = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(("dcn", "ici"), None), P(None, None)),
        out_specs=(P(None, None), P(None, None)), check_vma=False,
    ))(jnp.asarray(emb), jnp.asarray(q))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(mv.numpy(), np.asarray(jv), rtol=RTOL)


def test_sharded_k_exceeds_shard_size(setup):
    c, jidx, jsidx, idx, mesh, sidx = setup
    q = c.query_embeddings[MODEL][:2]
    k = sidx.n_local + 50
    vals, ids = sharded_dense_top_k(sidx, MODEL, q, k)
    _, jids = jax_sharded_top_k(jsidx, MODEL, q, k)
    np.testing.assert_array_equal(ids.numpy(), jids)
    scores = q @ c.embeddings[MODEL].T
    for b in range(2):
        expect = np.argsort(scores[b])[::-1][:ids.shape[1]]
        got = ids[b][ids[b] >= 0].numpy()
        np.testing.assert_array_equal(got, expect[:len(got)])
        assert len(got) >= idx.n_docs or len(got) == ids.shape[1]


def test_host_axis_retriever_matches_single_axis(setup):
    c, jidx, jsidx, idx, mesh, sidx = setup
    terms = idx.pad_term_ids(c.query_tokens, 16)
    q = {MODEL: c.query_embeddings[MODEL]}
    mh = make_mesh(shape=(2, 2, 2), axis_names=("dp", "host", "corpus"),
                   devices=CPU8)
    sidx_mh = shard_index(idx, mh, host_axis="host")
    assert sidx_mh.n_shards == 4 and sidx_mh.n_local == sidx.n_local
    kw = dict(use_bm25=True, similarity_k=12, common_sections_n=10,
              budget=4096)
    v_mh, i_mh = ShardedRetriever(sidx_mh, MODELS, **kw)(q, terms, W, None,
                                                         40.0)
    v_1, i_1 = ShardedRetriever(sidx, MODELS, **kw)(q, terms, W, None, 40.0)
    np.testing.assert_allclose(v_mh, v_1, rtol=RTOL, atol=1e-7)
    _same_sets(i_mh, i_1)


def test_host_axis_dense_top_k_exact(setup):
    c, jidx, jsidx, idx, mesh, sidx = setup
    mh = make_mesh(shape=(1, 2, 4), axis_names=("dp", "host", "corpus"),
                   devices=CPU8)
    sidx_mh = shard_index(idx, mh, host_axis="host")
    assert sidx_mh.n_shards == 8
    q = c.query_embeddings[MODEL][:4]
    _, ids = sharded_dense_top_k(sidx_mh, MODEL, q, 15)
    scores = q @ c.embeddings[MODEL].T
    for b in range(4):
        np.testing.assert_array_equal(ids[b].numpy(),
                                      np.argsort(scores[b])[::-1][:15])
    jsidx_mh = jax_shard_index(
        jidx, jax_make_mesh(shape=(1, 2, 4),
                            axis_names=("dp", "host", "corpus")),
        host_axis="host")
    _, jids = jax_sharded_top_k(jsidx_mh, MODEL, q, 15)
    np.testing.assert_array_equal(ids.numpy(), jids)


def test_sharded_quantized_index_matches_single_device():
    c = synth_corpus(n_docs=700, dim=64, n_queries=12, seed=43,
                     models=MODELS)
    jidx, idx = _indexes(c, quantize_dense=True)
    mesh = make_mesh(shape=(2, 4), axis_names=("dp", "corpus"),
                     devices=CPU8)
    sidx = shard_index(idx, mesh)
    jsidx = jax_shard_index(jidx, jax_make_mesh(
        shape=(2, 4), axis_names=("dp", "corpus")))
    q = c.query_embeddings[MODEL]
    vals, ids = sharded_dense_top_k(sidx, MODEL, q, 20)
    v1, i1 = quantized_dense_top_k(idx.dense_q[MODEL], torch.as_tensor(q),
                                   20, mask=idx.filter_mask(None))
    np.testing.assert_array_equal(ids.numpy(), i1.numpy())
    np.testing.assert_allclose(vals.numpy(), v1.numpy(), rtol=RTOL,
                               atol=1e-6)
    jv, ji = jax_sharded_top_k(jsidx, MODEL, q, 20)
    np.testing.assert_array_equal(ids.numpy(), ji)
    np.testing.assert_allclose(vals.numpy(), jv, rtol=RTOL, atol=1e-6)
    # The kernel route: K2's plain version per shard, the same ids.
    kw_d = dict(use_bm25=False, similarity_k=20, common_sections_n=20)
    _, ids_k = ShardedRetriever(sidx, MODELS, dense_backend="kernel",
                                **kw_d)({MODEL: q}, None, {MODEL: 1.0})
    np.testing.assert_array_equal(ids_k, ids.numpy())

    terms = idx.pad_term_ids(c.query_tokens, 16)
    kw = dict(use_bm25=True, similarity_k=12, common_sections_n=10,
              budget=4096)
    s_vals, s_ids = ShardedRetriever(sidx, MODELS, **kw)({MODEL: q}, terms,
                                                         W, None, 40.0)
    f_ids, f_vals, _ = FusedRetriever(idx, MODELS, **kw)({MODEL: q}, terms,
                                                         W, None, 40.0)
    j_vals, j_ids = JaxSharded(jsidx, MODELS, **kw)({MODEL: q}, terms, W,
                                                    None, 40.0)
    np.testing.assert_allclose(s_vals, f_vals, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(s_vals, j_vals, rtol=RTOL, atol=1e-7)
    _same_sets(s_ids, f_ids)
    _same_sets(s_ids, j_ids)


# -- the slot mesh and the batched k-means -----------------------------------


def test_slots_sharing_one_device(setup):
    """Eight slots on one device stay eight slots: distinct, hashable,
    each with its grid position, and the dp x corpus grid follows the
    axis names."""
    c, jidx, jsidx, idx, mesh, sidx = setup
    assert len(set(mesh.slots)) == 8
    assert set(mesh.devices) == {torch.device("cpu")}
    assert [s.index for s in mesh.slots] == list(range(8))
    grid = mesh.slot_grid("dp", None, "corpus")
    assert grid.shape == (2, 4) and grid[1, 0] is mesh.slots[4]
    assert mesh.slot_grid("corpus", "dp")[0, 1] is mesh.slots[4]
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(shape=(3, 3), devices=CPU8)
    with pytest.raises(ValueError, match="twice"):
        DeviceMesh([mesh.slots[0]] * 2, (1, 2), ("dp", "corpus"))
    assert Slot(0, torch.device("cpu")) == mesh.slots[0]
    health = {s: True for s in mesh.slots}
    assert len(health) == 8


def test_default_mesh_needs_a_gpu(monkeypatch):
    """The default devices are the cards; without one, make_mesh raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=["cuda:0"] * 4)


def test_spherical_kmeans_batched_matches_jax():
    """S k-means from the same initial rows: centroids within 1e-5 and
    equal assignments on every real row; an empty shard keeps zero
    centroids."""
    rng = np.random.default_rng(5)
    s_cnt, npad, d, c = 3, 256, 16, 6
    cents = rng.normal(size=(c, d))
    xs = (cents[rng.integers(0, c, size=(s_cnt, npad))]
          + 0.1 * rng.normal(size=(s_cnt, npad, d)))
    xs = (xs / np.linalg.norm(xs, axis=-1, keepdims=True)).astype(np.float32)
    n_valids = np.array([256, 200, 0], np.int32)
    xs[1, 200:] = 0
    xs[2] = 0
    init = np.zeros((s_cnt, c, d), np.float32)
    for s in range(2):
        init[s] = xs[s, jkm.kmeans_init_rows(int(n_valids[s]), c, s)]
    jc, ja = jkm.spherical_kmeans_batched(jnp.asarray(xs), n_valids, c,
                                          n_iters=6, init=init)
    tc, ta = tkm.spherical_kmeans_batched(
        [torch.as_tensor(x) for x in xs], n_valids.tolist(), c, n_iters=6,
        init=torch.as_tensor(init))
    for s in range(s_cnt):
        np.testing.assert_allclose(tc[s].numpy(), np.asarray(jc)[s],
                                   atol=1e-5)
        real = int(n_valids[s])
        np.testing.assert_array_equal(ta[s][:real].numpy(),
                                      np.asarray(ja)[s][:real])
    assert not tc[2].any()
    # The default draw: rows of each shard, seeded seed + s.
    dc, _ = tkm.spherical_kmeans_batched(
        [torch.as_tensor(x) for x in xs], n_valids.tolist(), c, n_iters=0,
        seed=3)
    rows = tkm.kmeans_init_rows(256, c, 3)
    want = torch.as_tensor(xs[0])[rows]
    np.testing.assert_allclose(dc[0].numpy(), want.numpy(), atol=1e-6)


def test_tombstones_refresh_shard_masks():
    """Deleting documents bumps the index version: the version-keyed mask
    caches rebuild (stale entries evicted), deleted ids leave every list,
    and a shard with a tombstone keeps its mask, as in the JAX package."""
    from a_nice_rag_tpu.index import updates as jup
    from a_nice_rag_tpu_torch.index import updates as tup

    c = synth_corpus(n_docs=512, dim=32, n_queries=8, seed=45,
                     models=MODELS)
    jidx, idx = _indexes(c)
    mesh = make_mesh(shape=(1, 4), devices=["cpu"] * 4)
    sidx = shard_index(idx, mesh)
    jsidx = jax_shard_index(jidx, jax_make_mesh(
        shape=(1, 4), devices=jax.devices()[:4]))
    assert sidx.filter_mask(None)[0] == [None] * 4  # no pad, no filter
    q = c.query_embeddings[MODEL]
    _, before = sharded_dense_top_k(sidx, MODEL, q, 5)
    gone = sorted({int(i) for i in before[:, 0]})
    for pkg, index in ((tup, idx), (jup, jidx)):
        assert pkg.delete_documents(index, [c.ids[i] for i in gone]) \
            == len(gone)
    masks = sidx.filter_mask(None)[0]
    assert [m is not None for m in masks] == [
        any(s * sidx.n_local <= i < (s + 1) * sidx.n_local for i in gone)
        for s in range(4)]
    assert len(sidx._mask_cache) == 1
    _, after = sharded_dense_top_k(sidx, MODEL, q, 5)
    _, jafter = jax_sharded_top_k(jsidx, MODEL, q, 5)
    np.testing.assert_array_equal(after.numpy(), jafter)
    assert not set(after.numpy().ravel().tolist()) & set(gone)
    terms = idx.pad_term_ids(c.query_tokens, 16)
    kw = dict(use_bm25=True, similarity_k=8, common_sections_n=8)
    s_vals, s_ids = ShardedRetriever(sidx, MODELS, **kw)(
        {MODEL: q}, terms, W, None, 40.0)
    j_vals, j_ids = JaxSharded(jsidx, MODELS, **kw)({MODEL: q}, terms, W,
                                                    None, 40.0)
    np.testing.assert_allclose(s_vals, j_vals, rtol=RTOL, atol=1e-7)
    _same_sets(s_ids, j_ids)
    assert not set(s_ids.ravel().tolist()) & set(gone)


def test_multi_card_probe_runs_on_cpu_slots():
    """probes.multi_card at a tiny size on CPU slots (on the card it lays
    the corpus over distinct cards): both meshes agree in every part, and
    the recovery probes report the dead slot's device as healthy."""
    from a_nice_rag_tpu_torch.bench import Scale2MConfig
    from a_nice_rag_tpu_torch.probes import multi_card

    cfg = Scale2MConfig(n=4096, dim=32, batch=16, vocab=1024)
    out = multi_card.run(["cpu"] * 4, "cpu", cfg, ivf_batches=2, nprobe=1,
                         tile_n=128, time_ms=lambda fn, devices: 1.0)
    assert out["n_cards"] == 4 and out["n_local"] == 1024
    assert out["hybrid"]["equal"] and out["hybrid"]["recall10"] >= 0.9
    assert out["ivf"]["equal"] and out["ivf"]["clusters_per_shard"] == 32
    assert out["recover"]["equal"] and out["recover"]["survivors"] == 3
    assert out["recover"]["probes"] == [True] * 4
