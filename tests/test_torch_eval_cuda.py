"""The port's eval harness on the card: its dense scores are IEEE float32
products. This file imports no jax, so it runs on a machine with a GPU
and the port alone; without a GPU it skips.

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_eval_cuda.py
"""

import numpy as np
import pytest
import torch

from a_nice_rag_tpu_torch.evals import RetrievalEvaluator
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.testing import synth_corpus

pytestmark = pytest.mark.cuda


def test_dense_scores_on_the_card_are_not_tf32():
    """TF32 would round the operands to 10 mantissa bits (errors near
    1e-3 at D = 256); the evaluator leaves torch's default (TF32 off) as
    it is, and its scores stay within 1e-5 of a float64 product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the card's matmul is what is checked")
    c = synth_corpus(n_docs=2000, dim=256, n_queries=64, seed=77,
                     models=["voyage-3-large"])
    idx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                      embeddings=c.embeddings, device="cuda")
    q = c.query_embeddings["voyage-3-large"]
    got = RetrievalEvaluator(idx)._ranker_scores("voyage-3-large", q, None)
    want = q.astype(np.float64) @ c.embeddings["voyage-3-large"].astype(
        np.float64).T
    np.testing.assert_allclose(got[:, :2000].cpu().numpy(), want, atol=1e-5,
                               rtol=0)
