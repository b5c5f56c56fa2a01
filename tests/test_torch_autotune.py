"""K1's plan tuner (ops/kernels/autotune.py) and the plan override.

Mirrors tests/test_autotune.py: the defaults without measuring off the
card, the disk cache round trip and the memo, and the config reaching
FusedRetriever and ShardedRetriever (whose lists equal the JAX package's
with its own tuned config, and the port's default plan's). Then the
override itself: the accepted plans as ``topk_plan.override_plan``
resolves them, one that does not fit raising, and the id-parity guard
skipping a candidate whose ids diverge, with a stubbed timer. That an
override leaves K1's output as the default plan's is a CUDA test.
"""

import json
import logging

import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.ops.pallas import FusedKernelConfig
from a_nice_rag_tpu.retrieval import FusedRetriever as JaxRetriever
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.ops.kernels import fused_dense_top_k, topk_plan
from a_nice_rag_tpu_torch.ops.kernels.autotune import (
    KernelConfig,
    _memory_cache,
    _signature,
    default_candidates,
    pick_fastest,
    tune_fused_blocks,
)
from a_nice_rag_tpu_torch.retrieval import FusedRetriever

MODEL = "voyage-3-large"
H100_SMS = 132


def _arrays():
    rng = np.random.default_rng(0)
    emb = torch.as_tensor(rng.standard_normal((1024, 64)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((64, 64)).astype(np.float32))
    return emb, q


def test_off_cuda_returns_defaults_without_measuring():
    emb, q = _arrays()
    _memory_cache.pop(_signature(emb, 64, 8), None)
    assert tune_fused_blocks(emb, q, 8) == KernelConfig()
    # Nothing was memoized: no measurement ran.
    assert _signature(emb, 64, 8) not in _memory_cache


def test_disk_cache_roundtrip(tmp_path):
    emb, q = _arrays()
    sig = _signature(emb, 64, 8)
    assert sig == "cpu:n1024:d64:b64:k8:torch.float32"
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({sig: {"bq": 16, "splits": 3}}))
    _memory_cache.pop(sig, None)
    cfg = tune_fused_blocks(emb, q, 8, cache_path=str(path))
    assert cfg == KernelConfig(16, 3)
    assert _memory_cache[sig] == cfg  # memoized now
    _memory_cache.pop(sig, None)


@pytest.fixture(scope="module")
def corpus():
    c = synth_corpus(n_docs=256, dim=32, n_queries=8, seed=11)
    args = dict(ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings=c.embeddings, token_lists=c.tokens)
    return c, build_index(device="cpu", **args), jax_build_index(**args)


def _call(fr, c, idx):
    return fr({MODEL: c.query_embeddings[MODEL]},
              idx.pad_term_ids(c.query_tokens, 16),
              {MODEL: 5.0, "BM25": 1.0}, None, 40.0)


def test_config_plumbs_into_retrievers(corpus):
    from a_nice_rag_tpu_torch.parallel import (
        ShardedRetriever,
        make_mesh,
        shard_index,
    )

    c, idx, jidx = corpus
    kw = dict(use_bm25=True, similarity_k=10, common_sections_n=5)
    jfr = JaxRetriever(jidx, (MODEL,),
                       pallas_config=FusedKernelConfig(64, 8192, 2), **kw)
    j_ids = np.asarray(_call(jfr, c, jidx)[0])
    assert j_ids.shape[1] == 5
    cfg = KernelConfig(16, 1)
    fr = FusedRetriever(idx, (MODEL,), dense_backend="kernel",
                        kernel_config=cfg, **kw)
    assert fr.kernel_config == cfg
    default = FusedRetriever(idx, (MODEL,), dense_backend="kernel", **kw)
    got, ref = _call(fr, c, idx), _call(default, c, idx)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], j_ids)
    sidx = shard_index(idx, make_mesh(shape=(1, 4), devices=["cpu"] * 4))
    sr = ShardedRetriever(sidx, (MODEL,), dense_backend="kernel",
                          kernel_config=KernelConfig(64, 2), **kw)
    assert sr.kernel_config == KernelConfig(64, 2)
    s_vals, s_ids = sr({MODEL: c.query_embeddings[MODEL]},
                       idx.pad_term_ids(c.query_tokens, 16),
                       {MODEL: 5.0, "BM25": 1.0}, None, 40.0)
    np.testing.assert_array_equal(s_ids, ref[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plan", [(16, 1), (64, 3), (16, 10_000),
                                  (None, 7), (64, None), KernelConfig()])
def test_accepted_override_plans(dtype, plan):
    """An override that fits is accepted and resolved as documented (its
    bq, else the plan's; its splits cut to whole tiles, none empty), and
    on CPU tensors the call is the plain version's. K1 itself is held to
    the default plan on the card (test_torch_kernels_cuda.py)."""
    g = torch.Generator().manual_seed(5)
    n, d, b = 5 * topk_plan.TN + 37, 48, 20
    rows = "float32" if dtype == torch.float32 else "bfloat16"
    emb = torch.randn((n, d), generator=g).to(dtype)
    q = torch.randn((b, d), generator=g)
    mask = torch.rand(n, generator=g) > 0.3
    bq, splits = plan[0], plan[1]
    for k in (1, 25, 128):
        own = topk_plan.fused_plan(n, b, d, k, H100_SMS, rows)
        got = topk_plan.override_plan(n, b, d, k, H100_SMS, rows, bq, splits)
        assert got.bq == (own.bq if bq is None else bq)
        if splits is None:
            assert (got.splits, got.per) == (own.splits, own.per)
        else:
            tiles = -(-n // topk_plan.TN)
            assert got.splits == min(splits, tiles)
        assert got.per % topk_plan.TN == 0
        assert (got.splits - 1) * got.per < n <= got.splits * got.per
        for m in (None, mask):
            want = fused_dense_top_k(emb, q, k, mask=m)
            out = fused_dense_top_k(emb, q, k, mask=m, plan=plan)
            assert torch.equal(out[0], want[0]) and \
                torch.equal(out[1], want[1]), (plan, k)


def test_override_is_validated():
    emb, q = _arrays()
    for bad in ((32, None), (16, 0), (64, -2)):
        with pytest.raises(ValueError):
            fused_dense_top_k(emb, q, 8, plan=bad)
    # A query block that does not fit a CTA's shared memory raises (int8
    # rows hold theirs resident; 64 such rows at D = 4096 do not fit).
    with pytest.raises(ValueError, match="does not fit"):
        topk_plan.override_plan(1 << 20, 256, 4096, 128, H100_SMS, "int8",
                                bq=64)
    plan = topk_plan.override_plan(1 << 20, 256, 256, 32, H100_SMS,
                                   "bfloat16", bq=16, splits=5)
    assert plan.bq == 16 and plan.splits == 5
    assert plan.per % topk_plan.TN == 0 and plan.splits * plan.per >= 1 << 20
    # Splits past the tiles are cut to one tile each, no split empty.
    plan = topk_plan.override_plan(1000, 8, 64, 8, H100_SMS, "float32",
                                   splits=99)
    assert plan == topk_plan.FusedPlan(16, 8, topk_plan.TN)


def test_config_applies_at_its_batch(monkeypatch):
    """A tuned config reaches K1 for calls of the batch it was tuned at;
    other batches keep the plan's own (splits count CTAs for a batch)."""
    from a_nice_rag_tpu_torch.retrieval import engine

    cfg = KernelConfig(16, 3, batch=8)
    assert cfg.for_batch(8) is cfg and cfg.for_batch(16) is None
    assert KernelConfig(16, 3).for_batch(5) == KernelConfig(16, 3)
    assert engine.plan_for(None, 8) is None
    seen = []
    real = engine.fused_dense_top_k

    def spy(*args, plan=None, **kw):
        seen.append(plan)
        return real(*args, plan=plan, **kw)

    monkeypatch.setattr(engine, "fused_dense_top_k", spy)
    c = synth_corpus(n_docs=256, dim=32, n_queries=16, seed=12)
    idx = build_index(device="cpu", ids=c.ids, sources=c.sources,
                      contents=c.contents, embeddings=c.embeddings)
    fr = FusedRetriever(idx, (MODEL,), use_bm25=False, similarity_k=10,
                        dense_backend="kernel", kernel_config=cfg)
    for b in (8, 16):
        fr.retrieve_device({MODEL: c.query_embeddings[MODEL][:b]}, None,
                           {MODEL: 1.0})
    assert seen == [cfg, None]


def test_default_candidates():
    cands = default_candidates(1 << 21, 128, 256, 25, H100_SMS, "bfloat16")
    own = topk_plan.fused_plan(1 << 21, 128, 256, 25, H100_SMS, "bfloat16")
    assert cands[0] == KernelConfig(own.bq, own.splits)
    assert {c.bq for c in cands} == {16, 64}
    s64 = [c.splits for c in cands if c.bq == 64]
    assert s64 == [own.splits, own.splits // 2, 2 * own.splits]
    assert len(set(cands)) == len(cands)


def test_id_parity_guard_skips_a_diverging_candidate(caplog):
    """The fastest candidate's ids differ from the default plan's (a
    stubbed wrong kernel): it is skipped with a warning, and the fastest
    candidate that agrees wins."""
    emb, q = _arrays()
    cands = (KernelConfig(16, 2), KernelConfig(64, 4), KernelConfig(16, 8))
    ms = {cands[0]: 3.0, cands[1]: 1.0, cands[2]: 2.0}

    def run(cfg):
        ids = fused_dense_top_k(emb, q, 8, plan=cfg)[1]
        return ids.flip(1) if cfg == cands[1] else ids

    with caplog.at_level(logging.WARNING):
        best, timed = pick_fastest(run, ms.__getitem__, cands)
    assert best == cands[2]
    assert set(timed) == {cands[0], cands[2]}
    assert "DIVERGE" in caplog.text

    def fails(cfg):
        raise RuntimeError("no launch")

    assert pick_fastest(lambda cfg: run(KernelConfig()) if cfg ==
                        KernelConfig() else fails(cfg), ms.__getitem__,
                        cands) == (KernelConfig(), {})
