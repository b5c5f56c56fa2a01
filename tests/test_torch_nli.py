"""The port's NLI scorer (models/nli.py) against the JAX package's, on
the CPU: the synthetic pairs equal for a seed, the scorer's probabilities
on converted cross-encoder params within 1e-5 (float32), the AUC helper
equal, and the training half: from the JAX package's initial params
(``init=``) on the same pairs, batches and holdout, the per-step BCE
losses within 2e-5 absolute and 1e-5 relative (AdamW magnifies the
summation-order noise of near-zero gradients) and the holdout AUC within
1e-6; ``nli_scorer_for_corpus`` trains from a corpus.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.models import nli as jax_nli
from a_nice_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from a_nice_rag_tpu.models.reranker import CrossEncoderReranker as JaxCE
from a_nice_rag_tpu.models.tokenizer import HashingTokenizer as JaxTokenizer
from a_nice_rag_tpu_torch.models import (
    EncoderConfig,
    HashingTokenizer,
    NliScorer,
    init_reranker,
    nli_scorer_for_corpus,
    synth_nli_pairs,
    train_nli_scorer,
)
from a_nice_rag_tpu_torch.models import nli
from a_nice_rag_tpu_torch.models.convert import reranker_state_from_flax

DOCS = [
    "Offer lifestyle advice to adults with hypertension. Blood pressure "
    "should be measured in both arms at diagnosis. Treatment with ACE "
    "inhibitors is recommended for adults under 55 years.",
    "Methotrexate is the first-line DMARD for rheumatoid arthritis. "
    "Folic acid supplementation reduces methotrexate toxicity. Monitor "
    "full blood count every 2 weeks until the dose is stable.",
    "Children with asthma should have a personalised action plan. "
    "Inhaled corticosteroids are the preferred preventer therapy. Review "
    "inhaler technique at every asthma consultation.",
    "Monitor the full blood count weekly at first. Adjust the dosing "
    "schedule after 12 weeks of stable response.",
]
SIZES = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=2, max_len=128,
             out_dim=64)


@pytest.mark.parametrize("seed,n_pairs", [(0, 64), (1, 64), (7, 33)])
def test_synth_nli_pairs_equal_jax(seed, n_pairs):
    prem, hyp, lab = synth_nli_pairs(DOCS, n_pairs=n_pairs, seed=seed)
    jprem, jhyp, jlab = jax_nli.synth_nli_pairs(DOCS, n_pairs=n_pairs,
                                                seed=seed)
    assert prem == jprem and hyp == jhyp
    np.testing.assert_array_equal(lab, jlab)
    assert lab.dtype == np.float32 and 0 < lab.mean() < 1


def test_sentences_and_negate_equal_jax():
    text = " ".join(DOCS)
    assert nli._sentences(text) == jax_nli._sentences(text)
    for s in nli._sentences(text) + ["Take 3 tablets daily thereafter",
                                     "plain words only here"]:
        r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
        assert nli._negate(s, r1) == jax_nli._negate(s, r2)
    with pytest.raises(ValueError, match="2 documents"):
        synth_nli_pairs(DOCS[:1])


def test_score_batch_matches_jax():
    """NliScorer over the converted cross-encoder (match features on, as
    the JAX recipe trains it): P(entailed) within 1e-5."""
    jcfg = JaxConfig(dtype=jnp.float32, **SIZES)
    jtok = JaxTokenizer(vocab_size=1024, max_len=128)
    prem, hyp, _ = synth_nli_pairs(DOCS, n_pairs=16, seed=2)
    model = JaxCE(jcfg, use_match_features=True)
    params = model.init(jax.random.PRNGKey(4), jnp.ones((1, 8), jnp.int32))
    want = jax_nli.NliScorer(model, params, jtok).score_batch(prem, hyp)
    ce = init_reranker(EncoderConfig(dtype=torch.float32, **SIZES),
                       device="cpu",
                       use_match_features=True)
    ce.load_state_dict(reranker_state_from_flax(jax.device_get(params)))
    scorer = NliScorer(ce, HashingTokenizer(vocab_size=1024, max_len=128))
    got = scorer.score_batch(prem, hyp)
    assert got.shape == (16,) and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert scorer(prem[0], hyp[0]) == pytest.approx(float(got[0]), abs=1e-6)


def test_auc_equal_jax():
    rng = np.random.default_rng(0)
    scores, labels = rng.random(50), (rng.random(50) > 0.5).astype(np.float32)
    assert nli._auc(scores, labels) == jax_nli._auc(scores, labels)
    assert np.isnan(nli._auc(scores, np.ones(50)))


@pytest.mark.parametrize("fn", [train_nli_scorer, nli_scorer_for_corpus])
def test_training_waits_for_item_9(fn):
    """Item 9 is done: both entry points train (at small widths here)
    and return a scorer over the trained cross-encoder."""
    kw = dict(cfg=EncoderConfig(**SIZES, dtype=torch.float32), epochs=1,
              batch_size=8, device="cpu")
    if fn is train_nli_scorer:
        out = fn(*synth_nli_pairs(DOCS, n_pairs=40, seed=0), **kw)
    else:
        out = fn(DOCS, n_pairs=40, **kw)
    assert len(out.losses) == 4 and np.isfinite(out.losses).all()
    assert isinstance(out.scorer, NliScorer)
    assert 0.0 <= out.scorer(DOCS[0], "Offer lifestyle advice.") <= 1.0


@pytest.mark.parametrize("match", [True, False])
def test_training_losses_and_auc_equal_jax(match):
    prem, hyp, lab = synth_nli_pairs(DOCS, n_pairs=96, seed=3)
    jcfg = JaxConfig(**SIZES, dtype=jnp.float32)
    init = JaxCE(jcfg, use_match_features=match).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    kw = dict(batch_size=16, epochs=2, seed=0, use_match_features=match)
    want = jax_nli.train_nli_scorer(prem, hyp, lab, cfg=jcfg, **kw)
    got = train_nli_scorer(
        prem, hyp, lab, cfg=EncoderConfig(**SIZES, dtype=torch.float32),
        init=reranker_state_from_flax(jax.device_get(init)), device="cpu",
        **kw)
    assert len(got.losses) == len(want.losses) == 10
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5,
                               atol=2e-5)
    assert got.holdout_auc == pytest.approx(want.holdout_auc, abs=1e-6)
    assert got.scorer.tokenizer.max_len == SIZES["max_len"]
