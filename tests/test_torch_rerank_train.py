"""The port's reranker training (a_nice_rag_tpu_torch/models/rerank_train.py)
against the JAX package's, on the CPU.

``mine_candidates`` is numpy only and equal for a seed. The listwise
fine-tune starts from the JAX package's initial params (its
``model.init(PRNGKey(seed), ...)``, carried across through ``init=``),
sees the same batches and holdout (the seeded permutation) and runs
float32: the per-step losses agree within 2e-5 absolute and 1e-5
relative (AdamW magnifies the summation-order noise of near-zero
gradients into the parameters), and the holdout accuracy is equal. The
result serves through the port's ``OnDeviceReranker``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.models import rerank_train as jax_rt
from a_nice_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from a_nice_rag_tpu.models.reranker import CrossEncoderReranker as JaxCE
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.models import (
    EncoderConfig,
    HashingTokenizer,
    OnDeviceReranker,
)
from a_nice_rag_tpu_torch.models.convert import reranker_state_from_flax
from a_nice_rag_tpu_torch.models.rerank_train import (
    RerankTrainResult,
    mine_candidates,
    train_cross_encoder_reranker,
)

SIZES = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=2, max_len=64,
             out_dim=64)
RTOL, ATOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def lists():
    c = synth_corpus(n_docs=96, dim=16, n_queries=48, seed=4)
    rng = np.random.default_rng(2)
    gold = rng.integers(0, 96, 48)
    ranked = rng.integers(-1, 96, (48, 12))
    ranked[::5, 0] = gold[::5]  # gold inside some retrieved lists
    texts = [" ".join(t) for t in c.query_tokens]
    return texts, gold, ranked, list(c.contents)


@pytest.mark.parametrize("n_negatives,seed", [(3, 0), (7, 1), (15, 2)])
def test_mine_candidates_equal_jax(lists, n_negatives, seed):
    texts, gold, ranked, contents = lists
    got = mine_candidates(texts, gold, ranked, contents, n_negatives, seed)
    want = jax_rt.mine_candidates(texts, gold, ranked, contents,
                                  n_negatives, seed)
    assert got == want
    assert all(c[0] == contents[g] for c, g in zip(got[1], gold))


@pytest.mark.parametrize("match", [True, False])
def test_losses_and_holdout_equal_jax(lists, match):
    texts, gold, ranked, contents = lists
    q, cands = mine_candidates(texts, gold, ranked, contents, 3, 0)
    jcfg = JaxConfig(**SIZES, dtype=jnp.float32)
    init = JaxCE(jcfg, use_match_features=match).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    kw = dict(batch_size=8, epochs=2, seed=0, use_match_features=match)
    want = jax_rt.train_cross_encoder_reranker(
        q, cands, cfg=jcfg, tokenizer=jax_rt.HashingTokenizer(
            vocab_size=1024, max_len=64), **kw)
    got = train_cross_encoder_reranker(
        q, cands, cfg=EncoderConfig(**SIZES, dtype=torch.float32),
        tokenizer=HashingTokenizer(vocab_size=1024, max_len=64),
        init=reranker_state_from_flax(jax.device_get(init)), device="cpu",
        **kw)
    assert isinstance(got, RerankTrainResult)
    assert len(got.losses) == len(want.losses) == 10
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL,
                               atol=ATOL)
    assert got.losses[-1] < got.losses[0]
    assert got.holdout_accuracy == want.holdout_accuracy
    assert isinstance(got.reranker, OnDeviceReranker)
    out = got.reranker.rerank(q[0], [{"id": i, "document": d}
                                     for i, d in enumerate(cands[0])])
    scores = [d["rerank_score"] for d in out]
    assert scores == sorted(scores, reverse=True)


def test_ragged_lists_raise():
    with pytest.raises(ValueError, match="ragged"):
        train_cross_encoder_reranker(
            ["a", "b"], [["x", "y"], ["z"]], device="cpu",
            cfg=EncoderConfig(**SIZES, dtype=torch.float32))
