"""The port's per-shard IVF (``parallel.shard_ivf``) against the JAX
package's.

Mirrors tests/test_sharded_ivf.py on an 8-slot virtual mesh of "cpu".
Both packages cluster alike: the port either loads the file the JAX
package's ``save_shard_ivf`` wrote, or takes the JAX package's initial
rows (``init=``), whose k-means it then reproduces. K3/K4 run as their
plain versions on CPU tensors; the JAX package's Pallas kernels run in
interpret mode.

Tolerances: layouts (permutations, cluster offsets, gathered rows) and
ids equal; centroids within 1e-5 (the same sums in another order); f32
scores within 1e-5; fused WRRF scores within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.index import ivf as jivf
from a_nice_rag_tpu.ops import kmeans as jkm
from a_nice_rag_tpu.ops.pallas.ivf_topk import ivf_dense_top_k as jax_k3
from a_nice_rag_tpu.parallel import load_shard_ivf as jax_load
from a_nice_rag_tpu.parallel import make_mesh as jax_make_mesh
from a_nice_rag_tpu.parallel import save_shard_ivf as jax_save
from a_nice_rag_tpu.parallel import shard_index as jax_shard_index
from a_nice_rag_tpu.parallel import shard_ivf as jax_shard_ivf
from a_nice_rag_tpu.parallel.sharded import ShardedRetriever as JaxSharded
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.ops.kernels import ivf_dense_top_k
from a_nice_rag_tpu_torch.ops.quantized import QuantizedDense
from a_nice_rag_tpu_torch.parallel import (
    load_shard_ivf,
    make_mesh,
    save_shard_ivf,
    shard_index,
    shard_ivf,
)
from a_nice_rag_tpu_torch.parallel.sharded import (
    ShardedRetriever,
    reshard_surviving,
)
from a_nice_rag_tpu_torch.retrieval.engine import _ivf_coverage
from a_nice_rag_tpu_torch.testing.parity import check_top_k

MODEL = "voyage-3-large"
MODELS = [MODEL]
W = {MODEL: 1.0}
CPU8 = ["cpu"] * 8


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _both(c, x, **kw):
    args = dict(ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings={MODEL: x}, token_lists=c.tokens, **kw)
    return jax_build_index(**args), build_index(device="cpu", **args)


def _jax_init(jsidx, x, seed=0):
    """The JAX package's initial rows of each shard's k-means ([S, C, D]
    unit rows), as its shard_ivf draws them."""
    nl, s_cnt = jsidx.n_local, jsidx.n_shards
    c = int(np.asarray(jsidx.ivf_centroids).shape[1])
    n = jsidx.base_index.n_docs
    init = np.zeros((s_cnt, c, x.shape[1]), np.float32)
    for s in range(s_cnt):
        real = int(np.clip(n - s * nl, 0, nl))
        if real:
            rows = x[s * nl + jkm.kmeans_init_rows(real, c, seed + s)]
            init[s] = _unit(rows.astype(np.float32))
    return torch.as_tensor(init)


def _ids(r, q, filt=None, terms=None, w=W):
    return r({MODEL: q}, terms, w, filt, 40.0)[1]


def _exact_sets(ids, q, x, k):
    ref = np.argsort(-(q @ x.T), axis=1)[:, :k]
    for b in range(q.shape[0]):
        assert set(ids[b][ids[b] >= 0]) == set(ref[b])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(11)
    n, d, c_true = 900, 48, 20
    cents = _unit(rng.normal(size=(c_true, d)))
    x = _unit(np.repeat(cents, n // c_true, axis=0)
              + 0.08 * rng.normal(size=(n, d))).astype(np.float32)
    gold = rng.integers(0, n, 16)
    q = _unit(x[gold] + 0.1 * rng.normal(size=(16, d))).astype(np.float32)
    c = synth_corpus(n_docs=n, dim=d, n_queries=16, seed=11, models=MODELS)
    jidx, idx = _both(c, x)
    jmesh = jax_make_mesh(shape=(2, 4), axis_names=("dp", "corpus"))
    jsidx = jax_shard_ivf(jax_shard_index(jidx, jmesh), MODEL, tile_n=128)
    path = str(tmp_path_factory.mktemp("ivf") / "jax_ivf.npz")
    jax_save(jsidx, path)
    mesh = make_mesh(shape=(2, 4), axis_names=("dp", "corpus"),
                     devices=CPU8)
    sidx = load_shard_ivf(shard_index(idx, mesh), path)
    return c, idx, x, q, gold, mesh, sidx, jidx, jsidx, path


def test_dynamic_n_real_matches_static(setup):
    """K3's dynamic real-row count (trailing table slot, n_real=0) equals
    the static form, and both equal the JAX kernel's."""
    _, _, x, q, _, _, _, _, _, _ = setup
    ivf = jivf.build_ivf_dense(jnp.asarray(x[:480]), n_clusters=12,
                               tile_n=128, n_iters=6, seed=0)
    table, _ = jivf.build_tile_table(
        ivf.centroids, ivf.cluster_start, jnp.asarray(q), nprobe=12,
        max_tiles=ivf.n_tiles, tile_n=128, mct=ivf.max_cluster_tiles)
    jv, ji = jax_k3(ivf.emb, jnp.asarray(q), table, 9, tile_n=128,
                    n_real=480, interpret=True)
    emb = torch.as_tensor(np.array(ivf.emb))
    t = torch.as_tensor(np.array(table))
    v_s, i_s = ivf_dense_top_k(emb, torch.as_tensor(q), t, 9, tile_n=128,
                               n_real=480)
    dyn = torch.cat([t, torch.tensor([480], dtype=torch.int32)])
    v_d, i_d = ivf_dense_top_k(emb, torch.as_tensor(q), dyn, 9, tile_n=128,
                               n_real=0)
    assert torch.equal(i_s, i_d) and torch.equal(v_s, v_d)
    check_top_k(np.asarray(jv), np.asarray(ji), v_s, i_s, 1e-5)


def test_shard_ivf_layout(setup):
    """The port's own clustering from the JAX package's initial rows:
    the JAX layout, permutations covering every real local row once,
    pads at the tail, rows the permuted local originals."""
    c, idx, x, _, _, mesh, _, _, jsidx, _ = setup
    sidx = shard_ivf(shard_index(idx, mesh), MODEL, tile_n=128,
                     init=_jax_init(jsidx, x))
    assert sidx.ivf_model == MODEL
    np.testing.assert_allclose(sidx.ivf_centroids.numpy(),
                               np.asarray(jsidx.ivf_centroids), atol=1e-5)
    np.testing.assert_array_equal(sidx.ivf_perm.numpy(),
                                  np.asarray(jsidx.ivf_perm))
    np.testing.assert_array_equal(sidx.ivf_cluster_start.numpy(),
                                  np.asarray(jsidx.ivf_cluster_start))
    assert (sidx.ivf_tile_n, sidx.ivf_mct) == (jsidx.ivf_tile_n,
                                               jsidx.ivf_mct)
    reals = sidx.ivf_n_real.numpy()
    assert reals.sum() == idx.n_docs
    perms = sidx.ivf_perm.numpy()
    for s, sh in enumerate(sidx.shards):
        real, p = int(reals[s]), perms[s]
        assert sorted(p[p >= 0].tolist()) == list(range(real))
        rows = sh.ivf.emb.numpy()
        local = x[s * sidx.n_local:s * sidx.n_local + real]
        np.testing.assert_array_equal(rows[p >= 0], local[p[p >= 0]])
        assert (rows[p < 0] == 0).all()
        np.testing.assert_array_equal(rows,
                                      np.asarray(jsidx.ivf_rows)[s])


def test_full_probe_matches_exact(setup):
    c, idx, x, q, _, mesh, sidx, _, jsidx, _ = setup
    cfull = sidx.ivf_n_clusters
    kw = dict(use_bm25=False, similarity_k=12, common_sections_n=12)
    r_ivf = ShardedRetriever(sidx, MODELS, nprobe=cfull, **kw)
    assert r_ivf.use_ivf
    ids_i = _ids(r_ivf, q)
    np.testing.assert_array_equal(ids_i, _ids(ShardedRetriever(
        sidx, MODELS, **kw), q))
    np.testing.assert_array_equal(ids_i, _ids(JaxSharded(
        jsidx, MODELS, nprobe=cfull, **kw), q))
    _exact_sets(ids_i, q, x, 12)


def test_partial_probe_recall_and_fallbacks(setup):
    c, idx, x, q, gold, mesh, sidx, _, jsidx, _ = setup
    kw = dict(use_bm25=False, similarity_k=12, common_sections_n=12)
    r_p = ShardedRetriever(sidx, MODELS, nprobe=4, **kw)
    ids_p = _ids(r_p, q)
    assert sum(gold[b] in set(ids_p[b]) for b in range(len(q))) >= 13
    np.testing.assert_array_equal(
        ids_p, _ids(JaxSharded(jsidx, MODELS, nprobe=4, **kw), q))
    # Filtered calls take the exact route (the mask is kept).
    f_p = _ids(r_p, q, "NG")
    np.testing.assert_array_equal(f_p, _ids(ShardedRetriever(
        sidx, MODELS, **kw), q, "NG"))
    for row in f_p:
        for i in row[row >= 0]:
            assert c.sources[int(i)].upper().startswith("NG")


def test_hybrid_ivf_full_probe_matches_exact(setup):
    c, idx, x, q, _, mesh, sidx, _, jsidx, _ = setup
    terms = idx.pad_term_ids(c.query_tokens, 16)
    w = {MODEL: 5.0, "BM25": 1.0}
    kw = dict(use_bm25=True, similarity_k=12, common_sections_n=10,
              budget=4096)
    cfull = sidx.ivf_n_clusters
    v_i, ids_i = ShardedRetriever(sidx, MODELS, nprobe=cfull, **kw)(
        {MODEL: q}, terms, w, None, 40.0)
    v_x, ids_x = ShardedRetriever(sidx, MODELS, **kw)({MODEL: q}, terms, w,
                                                      None, 40.0)
    v_j, ids_j = JaxSharded(jsidx, MODELS, nprobe=cfull, **kw)(
        {MODEL: q}, terms, w, None, 40.0)
    np.testing.assert_allclose(v_i, v_x, rtol=1e-6)
    np.testing.assert_allclose(v_i, v_j, rtol=1e-6)
    for b in range(len(q)):
        assert set(ids_i[b][ids_i[b] >= 0]) == set(ids_x[b][ids_x[b] >= 0])
        assert set(ids_i[b][ids_i[b] >= 0]) == set(ids_j[b][ids_j[b] >= 0])


def _quantized(setup, tmp_path, **ivf_kw):
    c, _, x, _, _, mesh, _, _, _, _ = setup
    jidx_q, idx_q = _both(c, x, quantize_dense=True)
    jsidx_q = jax_shard_ivf(jax_shard_index(jidx_q, jax_make_mesh(
        shape=(2, 4), axis_names=("dp", "corpus"))), MODEL, tile_n=128,
        **ivf_kw)
    path = str(tmp_path / "jax_ivfq.npz")
    jax_save(jsidx_q, path)
    return idx_q, jsidx_q, load_shard_ivf(shard_index(idx_q, mesh), path)


def test_quantized_shard_ivf_matches_exact(setup, tmp_path):
    _, _, x, q, _, _, _, _, _, _ = setup
    _, jsidx_q, sidx_q = _quantized(setup, tmp_path)
    assert isinstance(sidx_q.shards[0].dense[MODEL], QuantizedDense)
    assert sidx_q.shards[0].ivf.values is not None
    kw = dict(use_bm25=False, similarity_k=12, common_sections_n=12)
    cfull = sidx_q.ivf_n_clusters
    ids_i = _ids(ShardedRetriever(sidx_q, MODELS, nprobe=cfull, **kw), q)
    ids_x = _ids(ShardedRetriever(sidx_q, MODELS, **kw), q)
    np.testing.assert_array_equal(ids_i, ids_x)
    np.testing.assert_array_equal(ids_i, _ids(JaxSharded(
        jsidx_q, MODELS, nprobe=cfull, **kw), q))


def test_reshard_surviving_keeps_ivf(setup):
    c, idx, x, q, _, mesh, sidx, _, _, _ = setup
    sidx2 = reshard_surviving(sidx, mesh.slots[:4], dp=1)
    assert sidx2.ivf_model == MODEL and sidx2.n_shards == 4
    assert sidx2.mesh.slots == mesh.slots[:4]
    r = ShardedRetriever(sidx2, MODELS, use_bm25=False, similarity_k=12,
                         common_sections_n=12, nprobe=sidx2.ivf_n_clusters)
    assert r.use_ivf
    _exact_sets(_ids(r, q), q, x, 12)


def test_save_load_shard_ivf_roundtrip(setup, tmp_path):
    """The port's file and the JAX package's: each package reads the
    other's, with identical arrays and identical retrieval; a mismatched
    geometry is refused."""
    c, idx, x, q, _, mesh, sidx, jidx, jsidx, jax_path = setup
    path = str(tmp_path / "ivf.npz")
    save_shard_ivf(sidx, path)
    fresh = load_shard_ivf(shard_index(idx, mesh), path)
    np.testing.assert_array_equal(fresh.ivf_perm.numpy(),
                                  np.asarray(jsidx.ivf_perm))
    for a, b in zip(fresh.shards, sidx.shards):
        assert torch.equal(a.ivf.emb, b.ivf.emb)
    assert (fresh.ivf_tile_n, fresh.ivf_mct) == (sidx.ivf_tile_n,
                                                 sidx.ivf_mct)
    with np.load(path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    back = jax_load(jax_shard_index(jidx, jax_make_mesh(
        shape=(2, 4), axis_names=("dp", "corpus"))), path)
    np.testing.assert_array_equal(np.asarray(back.ivf_rows),
                                  np.asarray(jsidx.ivf_rows))
    kw = dict(use_bm25=False, similarity_k=12, common_sections_n=12,
              nprobe=sidx.ivf_n_clusters)
    np.testing.assert_array_equal(_ids(ShardedRetriever(fresh, MODELS, **kw),
                                       q),
                                  _ids(ShardedRetriever(sidx, MODELS, **kw),
                                       q))
    other = make_mesh(shape=(4, 2), axis_names=("dp", "corpus"),
                      devices=CPU8)
    with pytest.raises(ValueError, match="rebuild"):
        load_shard_ivf(shard_index(idx, other), path)


@pytest.mark.parametrize("n_docs,corpus,dp,tile_n", [
    (130, 2, 1, 64),    # tiny, heavy pad tail on shard 1
    (257, 4, 2, 32),    # prime-ish, all shards part-real
    (512, 8, 1, 64),    # exact fit, no pad
    (700, 4, 2, 128),   # tile_n > some shards' real rows
])
def test_fuzz_geometry_full_probe_exact(n_docs, corpus, dp, tile_n):
    """Full-probe sharded IVF equals brute force, and the JAX package's,
    across awkward corpus, shard and tile geometries."""
    rng = np.random.default_rng(n_docs)
    d = 32
    x = _unit(rng.normal(size=(n_docs, d))).astype(np.float32)
    q = _unit(rng.normal(size=(dp * 4, d))).astype(np.float32)
    c = synth_corpus(n_docs=n_docs, dim=d, n_queries=4, seed=n_docs,
                     models=MODELS)
    jidx, idx = _both(c, x)
    jsidx = jax_shard_ivf(jax_shard_index(jidx, jax_make_mesh(
        shape=(dp, corpus), axis_names=("dp", "corpus"),
        devices=jax.devices()[:dp * corpus])), MODEL, tile_n=tile_n)
    mesh = make_mesh(shape=(dp, corpus), axis_names=("dp", "corpus"),
                     devices=["cpu"] * (dp * corpus))
    sidx = shard_ivf(shard_index(idx, mesh), MODEL, tile_n=tile_n,
                     init=_jax_init(jsidx, x))
    np.testing.assert_array_equal(sidx.ivf_perm.numpy(),
                                  np.asarray(jsidx.ivf_perm))
    k = min(8, n_docs)
    kw = dict(use_bm25=False, similarity_k=k, common_sections_n=k,
              nprobe=sidx.ivf_n_clusters)
    ids = _ids(ShardedRetriever(sidx, MODELS, **kw), q)
    _exact_sets(ids, q, x, k)
    np.testing.assert_array_equal(ids, _ids(JaxSharded(jsidx, MODELS, **kw),
                                            q))


def test_multihost_ivf_full_probe_exact(setup):
    c, idx, x, q, _, _, _, _, _, _ = setup
    mesh = make_mesh(shape=(1, 2, 4), axis_names=("dp", "host", "corpus"),
                     devices=CPU8)
    sidx = shard_ivf(shard_index(idx, mesh, host_axis="host"), MODEL,
                     tile_n=128)
    assert sidx.n_shards == 8
    r = ShardedRetriever(sidx, MODELS, use_bm25=False, similarity_k=12,
                         common_sections_n=12, nprobe=sidx.ivf_n_clusters)
    _exact_sets(_ids(r, q), q, x, 12)


def test_save_load_shard_ivf_quantized(setup, tmp_path):
    """int8 rows and scales gathered again from the shards, exactly."""
    idx_q, jsidx_q, sidx_q = _quantized(setup, tmp_path)
    path = str(tmp_path / "ivfq.npz")
    save_shard_ivf(sidx_q, path)
    fresh = load_shard_ivf(shard_index(idx_q, sidx_q.mesh), path)
    for s, (a, b) in enumerate(zip(fresh.shards, sidx_q.shards)):
        assert torch.equal(a.ivf.values, b.ivf.values)
        assert torch.equal(a.ivf.scales, b.ivf.scales)
        np.testing.assert_array_equal(
            a.ivf.values.numpy(), np.asarray(jsidx_q.ivf_rows.values)[s])
        np.testing.assert_array_equal(
            a.ivf.scales.numpy(), np.asarray(jsidx_q.ivf_rows.scales)[s])


def test_spilled_shard_ivf_full_probe_matches_exact(setup):
    """Spilled per-shard layout from the JAX package's initial rows: the
    JAX slots, every real row stored once or twice, full probe equal to
    the exact route after per-shard dedup, no duplicate ids."""
    c, idx, x, q, _, mesh, _, jidx, jsidx0, _ = setup
    jsidx = jax_shard_ivf(jax_shard_index(jidx, jax_make_mesh(
        shape=(2, 4), axis_names=("dp", "corpus"))), MODEL, tile_n=128,
        spill=True)
    sidx = shard_ivf(shard_index(idx, mesh), MODEL, tile_n=128, spill=True,
                     init=_jax_init(jsidx0, x))
    assert sidx.ivf_spilled
    np.testing.assert_array_equal(sidx.ivf_perm.numpy(),
                                  np.asarray(jsidx.ivf_perm))
    reals = sidx.ivf_n_real.numpy()
    assert idx.n_docs < reals.sum() <= 2 * idx.n_docs
    for s, p in enumerate(sidx.ivf_perm.numpy()):
        counts = np.bincount(p[p >= 0])
        assert ((counts >= 1) & (counts <= 2)).all()
        assert (p >= 0).sum() == int(reals[s])
    kw = dict(use_bm25=False, similarity_k=12, common_sections_n=12)
    ids_i = _ids(ShardedRetriever(sidx, MODELS, nprobe=sidx.ivf_n_clusters,
                                  **kw), q)
    for row in ids_i:
        valid = row[row >= 0]
        assert len(set(valid.tolist())) == len(valid)
    np.testing.assert_array_equal(ids_i, _ids(ShardedRetriever(
        sidx, MODELS, **kw), q))


def test_spilled_shard_ivf_persistence_and_recovery(setup, tmp_path):
    c, idx, x, q, _, mesh, _, jidx, _, _ = setup
    jsidx = jax_shard_ivf(jax_shard_index(jidx, jax_make_mesh(
        shape=(2, 4), axis_names=("dp", "corpus"))), MODEL, tile_n=128,
        spill=True, spill_margin=0.2)
    jpath = str(tmp_path / "jax_spill.npz")
    jax_save(jsidx, jpath)
    sidx = load_shard_ivf(shard_index(idx, mesh), jpath)
    assert sidx.ivf_spilled and sidx.ivf_spill_margin == 0.2
    path = str(tmp_path / "spill.npz")
    save_shard_ivf(sidx, path)
    back = load_shard_ivf(shard_index(idx, mesh), path)
    assert back.ivf_spilled and back.ivf_spill_margin == 0.2
    assert torch.equal(back.ivf_perm, sidx.ivf_perm)
    kw = dict(use_bm25=False, similarity_k=12, common_sections_n=12,
              nprobe=4)
    ids_a = _ids(ShardedRetriever(sidx, MODELS, **kw), q)
    np.testing.assert_array_equal(ids_a, _ids(ShardedRetriever(
        back, MODELS, **kw), q))
    np.testing.assert_array_equal(ids_a, _ids(JaxSharded(jsidx, MODELS,
                                                         **kw), q))
    # Recovery keeps the spill settings and stays close to exact.
    out = reshard_surviving(sidx, mesh.slots[:6], dp=2)
    assert out.ivf_spilled and out.ivf_spill_margin == 0.2
    assert out.n_shards == 3 and out.n_dp == 2
    ids_r = _ids(ShardedRetriever(out, MODELS, **kw), q)
    ref = np.argsort(-(q @ x.T), axis=1)[:, :12]
    overlap = np.mean([len(set(ids_r[b][ids_r[b] >= 0]) & set(ref[b])) / 12
                       for b in range(len(q))])
    assert overlap >= 0.8, overlap


def test_spilled_quantized_shard_ivf(setup, tmp_path):
    _, _, _, q, _, _, _, _, _, _ = setup
    _, jsidx_q, sidx_q = _quantized(setup, tmp_path, spill=True)
    assert sidx_q.ivf_spilled
    kw = dict(use_bm25=False, similarity_k=12, common_sections_n=12)
    cfull = sidx_q.ivf_n_clusters
    ids_i = _ids(ShardedRetriever(sidx_q, MODELS, nprobe=cfull, **kw), q)
    np.testing.assert_array_equal(ids_i, _ids(ShardedRetriever(
        sidx_q, MODELS, **kw), q))
    np.testing.assert_array_equal(ids_i, _ids(JaxSharded(
        jsidx_q, MODELS, nprobe=cfull, **kw), q))


def test_sharded_ivf_batch_routing(setup):
    """"auto" probes while one dp group's per-shard coverage stays under
    ivf_max_coverage; wide, filtered and tombstoned calls take the exact
    route; "always" probes at any width; the JAX package decides alike."""
    c, idx, x, q, gold, mesh, sidx, _, jsidx, _ = setup
    cs, dp = sidx.ivf_n_clusters, sidx.n_dp
    kw = dict(use_bm25=False, similarity_k=8, common_sections_n=8)
    r = ShardedRetriever(sidx, MODELS, nprobe=1, ivf_max_coverage=0.5, **kw)
    jr = JaxSharded(jsidx, MODELS, nprobe=1, ivf_max_coverage=0.5, **kw)
    wide = dp * cs * 2
    assert _ivf_coverage(8 // dp, 1, cs) <= 0.5
    assert _ivf_coverage(wide // dp, 1, cs) > 0.5
    for b, filt, tomb, want in ((8, False, False, True),
                                (wide, False, False, False),
                                (8, True, False, False),
                                (8, False, True, False)):
        assert r._route_ivf(b, filt, tomb) is want
        assert jr._route_ivf(b, filt, tomb) is want
    r_always = ShardedRetriever(sidx, MODELS, nprobe=64, ivf_route="always",
                                **kw)
    assert r_always._route_ivf(wide, filtered=False, tombstoned=False)
    with pytest.raises(ValueError):
        ShardedRetriever(sidx, MODELS, nprobe=64, ivf_route="never", **kw)
    exact = ShardedRetriever(sidx, MODELS, **kw)
    r_full_auto = ShardedRetriever(sidx, MODELS, nprobe=64, **kw)
    assert not r_full_auto._route_ivf(8, filtered=False, tombstoned=False)
    qd = {MODEL: q}
    e = exact.retrieve_device(qd, None, W, None, 40.0)[0]
    assert torch.equal(r_always.retrieve_device(qd, None, W, None, 40.0)[0],
                       e)
    assert torch.equal(r_full_auto.retrieve_device(qd, None, W, None,
                                                   40.0)[0], e)
