"""The port's slot health monitor: injected deaths -> reshard over the
survivors -> rebuilt retrievers, against brute force and the JAX
package's monitor.

Mirrors tests/test_health_monitor.py on a 4-slot virtual mesh of "cpu".
Faults are injected per slot (the slots share one device). Tolerance:
dense ids equal to brute force; fused WRRF scores within 1e-5 relative
with equal id sets before and after recovery.
"""

import jax
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.parallel import DeviceHealthMonitor as JaxMonitor
from a_nice_rag_tpu.parallel import make_mesh as jax_make_mesh
from a_nice_rag_tpu.parallel import shard_index as jax_shard_index
from a_nice_rag_tpu.parallel.sharded import ShardedRetriever as JaxSharded
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.parallel import (
    DeviceHealthMonitor,
    default_probe,
    make_mesh,
    shard_index,
)
from a_nice_rag_tpu_torch.parallel.sharded import (
    ShardedRetriever,
    sharded_dense_top_k,
)

MODEL = "voyage-3-large"
W = {MODEL: 5.0, "BM25": 1.0}


@pytest.fixture(scope="module")
def corpus():
    c = synth_corpus(n_docs=400, dim=16, n_queries=4, seed=91)
    args = dict(ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings=c.embeddings, token_lists=c.tokens)
    return c, build_index(device="cpu", **args), jax_build_index(**args)


def _sharded(idx, n=4, **kw):
    mesh = make_mesh(shape=(1, n), devices=["cpu"] * n)
    return mesh, shard_index(idx, mesh, **kw)


def _rebuilder(state, **kw):
    def rebuild(sidx):
        state["r"] = ShardedRetriever(sidx, [MODEL], use_bm25=True,
                                      similarity_k=10, common_sections_n=8,
                                      budget=8192, **kw)
    return rebuild


def test_all_healthy_no_recovery(corpus):
    c, idx, _ = corpus
    _, sidx = _sharded(idx)
    calls = []
    mon = DeviceHealthMonitor(sidx, rebuild=calls.append,
                              probe_fn=lambda s, t: True)
    assert mon.check_and_recover() is False
    assert not calls and mon.events[-1]["dead_active"] == 0
    assert mon.events[-1]["healthy"] == 4


def test_injected_death_triggers_reshard_and_results_stay_exact(corpus):
    """One dead slot among four on one device: only that slot leaves."""
    c, idx, _ = corpus
    mesh, sidx = _sharded(idx)
    dead = {mesh.slots[1]}
    rebuilt = []
    mon = DeviceHealthMonitor(sidx, rebuild=rebuilt.append,
                              probe_fn=lambda s, t: s not in dead)
    assert mon.check_and_recover() is True
    assert rebuilt and rebuilt[0].n_shards == 3
    assert rebuilt[0].mesh.slots == (mesh.slots[0], mesh.slots[2],
                                     mesh.slots[3])
    assert mon.events[-1]["recovered"] is True
    assert mon.events[-1]["n_shards"] == 3
    q = c.query_embeddings[MODEL][:2]
    _, rows = sharded_dense_top_k(rebuilt[0], MODEL, q, 10)
    emb = c.embeddings[MODEL]
    for b in range(2):
        np.testing.assert_array_equal(rows[b].numpy(),
                                      np.argsort(-(emb @ q[b]))[:10])
    assert mon.check_and_recover() is False


def test_warm_spare_joins_on_recovery(corpus):
    c, idx, _ = corpus
    pool = make_mesh(shape=(1, 4), devices=["cpu"] * 4).slots
    from a_nice_rag_tpu_torch.parallel import DeviceMesh

    sidx = shard_index(idx, DeviceMesh(pool[:3], (1, 3), ("dp", "corpus")))
    spare, dead = pool[3], {pool[0]}
    rebuilt = []
    mon = DeviceHealthMonitor(sidx, rebuild=rebuilt.append, pool=pool,
                              probe_fn=lambda s, t: s not in dead)
    assert mon.check_and_recover() is True
    new = set(rebuilt[0].mesh.slots)
    assert spare in new and not (dead & new)
    assert rebuilt[0].n_shards == 3


def test_too_few_survivors_reports_unrecovered(corpus):
    c, idx, jidx = corpus
    mesh, sidx = _sharded(idx)
    rebuilt = []
    mon = DeviceHealthMonitor(sidx, rebuild=rebuilt.append, dp=2,
                              probe_fn=lambda s, t: s == mesh.slots[0])
    assert mon.check_and_recover() is False
    assert not rebuilt and mon.events[-1]["recovered"] is False
    jsidx = jax_shard_index(jidx, jax_make_mesh(
        shape=(1, 4), devices=jax.devices()[:4]))
    jmon = JaxMonitor(jsidx, rebuild=rebuilt.append, dp=2,
                      probe_fn=lambda d, t: d == jax.devices()[0])
    assert jmon.check_and_recover() is False
    assert {k: v for k, v in mon.events[-1].items() if k != "ts"} == \
        {k: v for k, v in jmon.events[-1].items() if k != "ts"}


def test_default_probe_on_real_devices(corpus):
    """A value read back from the slot's device; a failing device and a
    probe past its timeout report unhealthy."""
    _, idx, _ = corpus
    mesh, _ = _sharded(idx)
    assert default_probe(mesh.slots[0], timeout_s=30.0) is True
    assert default_probe(torch.device("cpu"), timeout_s=30.0) is True
    assert default_probe(torch.device("meta"), timeout_s=30.0) is False


def test_retriever_rebuild_path(corpus):
    """The monitor drives the ShardedRetriever's reconstruction; results
    equal those before the death and the JAX package's."""
    c, idx, jidx = corpus
    mesh, sidx = _sharded(idx)
    terms = idx.pad_term_ids(c.query_tokens, 16)
    q = {MODEL: c.query_embeddings[MODEL]}
    state = {}
    rebuild = _rebuilder(state)
    rebuild(sidx)
    v0, i0 = state["r"](q, terms, W, None, 40.0)
    mon = DeviceHealthMonitor(sidx, rebuild=rebuild,
                              probe_fn=lambda s, t: s is not mesh.slots[2])
    assert mon.check_and_recover() is True
    v1, i1 = state["r"](q, terms, W, None, 40.0)
    jsidx = jax_shard_index(jidx, jax_make_mesh(
        shape=(1, 4), devices=jax.devices()[:4]))
    jv, ji = JaxSharded(jsidx, [MODEL], use_bm25=True, similarity_k=10,
                        common_sections_n=8, budget=8192)(q, terms, W, None,
                                                          40.0)
    for v, i in ((v1, i1), (jv, ji)):
        np.testing.assert_allclose(v, v0, rtol=1e-5, atol=1e-7)
        for b in range(i0.shape[0]):
            assert set(i0[b][i0[b] >= 0]) == set(i[b][i[b] >= 0])


def test_recovery_preserves_two_tier_streaming_layout(corpus):
    """A recovered index keeps the two-tier layout, so
    bm25_backend="two_tier_streaming" (K1 on each shard's common tier)
    keeps serving."""
    c, idx, _ = corpus
    mesh, sidx = _sharded(idx, two_tier_common=8, two_tier_dtype="float32")
    assert sidx.two_tier_common == 8 and sidx.has_two_tier
    terms = idx.pad_term_ids(c.query_tokens, 16)
    q = {MODEL: c.query_embeddings[MODEL]}
    state = {}
    rebuild = _rebuilder(state, bm25_backend="two_tier_streaming")
    rebuild(sidx)
    v0, i0 = state["r"](q, terms, W, None, 40.0)
    mon = DeviceHealthMonitor(sidx, rebuild=rebuild,
                              probe_fn=lambda s, t: s is not mesh.slots[3])
    assert mon.check_and_recover() is True
    recovered = state["r"].sidx
    assert recovered.n_shards == 3 and recovered.two_tier_common == 8
    assert recovered.two_tier_dtype == "float32" and recovered.has_two_tier
    assert recovered.shards[0].two_tier.common_impact_t.dtype == \
        torch.float32
    v1, i1 = state["r"](q, terms, W, None, 40.0)
    np.testing.assert_allclose(v1, v0, rtol=1e-5, atol=1e-6)
    for b in range(i0.shape[0]):
        assert set(i0[b][i0[b] >= 0]) == set(i1[b][i1[b] >= 0])
