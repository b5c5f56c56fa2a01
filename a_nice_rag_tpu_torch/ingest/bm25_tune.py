"""BM25 hyperparameter tuning with Gaussian-process Bayesian optimization.

Equivalent of the reference tuner (src/processing/bm25_test.py: skopt
gp_minimize, 50 calls / 10 initial / seed 42 over k1 in [0.5,3],
b in [0.1,1], epsilon in [0.05,0.5], tokenization in {regular,
lemmatized}, maximizing validation Recall@15, then a single final
test-set evaluation of the best config). Implemented natively on
sklearn's GaussianProcessRegressor with expected-improvement
acquisition, so no skopt dependency is needed. Per-config BM25 builds
are cached, mirroring the reference's per-parameter index pickle cache.

Counterpart of ``a_nice_rag_tpu/ingest/bm25_tune.py``: each trial's
BM25 build and scores live on ``device``. scikit-learn is imported only
where the GP is first fitted (``n_calls > n_initial``); the random draws
are the same calls in the same order either way.

One difference: a trial's BM25 totals are summed in float64
(:func:`_exact_scores`), where the JAX package sums them in float32. A
gold document and its near-duplicates often hold the same impacts, so
their float32 totals tie exactly in exact arithmetic but round by the
summation order of the product, which differs between the card and the
CPU; a tie then counts as a better document on one device and not on
the other. In float64 the totals are exact, so the objective, and the
tuner's path, is the same on every device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TuneSpace:
    k1: Tuple[float, float] = (0.5, 3.0)
    b: Tuple[float, float] = (0.1, 1.0)
    epsilon: Tuple[float, float] = (0.05, 0.5)
    tokenizations: Tuple[str, ...] = ("regular", "lemmatized")


@dataclasses.dataclass
class TuneResult:
    best_params: Dict
    best_score: float
    history: List[Dict]


def _expected_improvement(mu, sigma, best):
    from scipy.stats import norm

    sigma = np.maximum(sigma, 1e-9)
    z = (mu - best) / sigma
    return (mu - best) * norm.cdf(z) + sigma * norm.pdf(z)


def _exact_scores(bm25_dense, q_terms: torch.Tensor) -> torch.Tensor:
    """BM25 totals [B, N_pad] as term counts @ impacts in float64. A
    total is at most 32 float32 impacts times small integer counts;
    while the impacts span less than 2^16, float64's 53 bits hold every
    partial sum exactly, so the order of the additions does not matter."""
    v = bm25_dense.vocab_size
    cols = torch.where(q_terms >= 0, q_terms, v).long()
    q_tf = torch.zeros((q_terms.shape[0], v + 1), dtype=torch.float64,
                       device=q_terms.device)
    q_tf.scatter_add_(1, cols, torch.ones_like(cols, dtype=torch.float64))
    return q_tf[:, :v] @ bm25_dense.impact.to(torch.float64)


def gp_maximize(
    objective: Callable[[np.ndarray], float],
    bounds: Sequence[Tuple[float, float]],
    n_calls: int = 50,
    n_initial: int = 10,
    seed: int = 42,
) -> Tuple[np.ndarray, float, List[Tuple[np.ndarray, float]]]:
    """Maximize a black-box function over a box with GP + EI."""
    rng = np.random.RandomState(seed)
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])

    xs: List[np.ndarray] = []
    ys: List[float] = []
    for _ in range(min(n_initial, n_calls)):
        x = lo + rng.rand(len(bounds)) * (hi - lo)
        xs.append(x)
        ys.append(objective(x))
    gp = None
    while len(xs) < n_calls:
        if gp is None:
            from sklearn.gaussian_process import GaussianProcessRegressor
            from sklearn.gaussian_process.kernels import Matern

            gp = GaussianProcessRegressor(
                kernel=Matern(nu=2.5), normalize_y=True, random_state=seed
            )
        x_arr = (np.stack(xs) - lo) / (hi - lo)
        gp.fit(x_arr, np.asarray(ys))
        cand = rng.rand(256, len(bounds))
        mu, sigma = gp.predict(cand, return_std=True)
        ei = _expected_improvement(mu, sigma, max(ys))
        x = lo + cand[int(np.argmax(ei))] * (hi - lo)
        xs.append(x)
        ys.append(objective(x))
    best_i = int(np.argmax(ys))
    return xs[best_i], ys[best_i], list(zip(xs, ys))


def tune_bm25(
    corpus_rows: Sequence[Dict],
    val_query_tokens: Dict[str, Sequence[Sequence[str]]],
    val_gold_ids: Sequence[str],
    test_query_tokens: Optional[Dict[str, Sequence[Sequence[str]]]] = None,
    test_gold_ids: Optional[Sequence[str]] = None,
    space: Optional[TuneSpace] = None,
    n_calls: int = 50,
    n_initial: int = 10,
    seed: int = 42,
    recall_k: int = 15,
    device: DeviceLike = "cuda",
) -> TuneResult:
    """Tune (k1, b, epsilon, tokenization) maximizing validation
    Recall@k. ``val_query_tokens`` maps tokenization name -> per-query
    token lists (queries must be preprocessed per variant). Builds and
    scores on ``device``.
    """
    from a_nice_rag_tpu_torch.evals.metrics import calculate_metrics
    from a_nice_rag_tpu_torch.index.array_index import dense_impact_from_csr
    from a_nice_rag_tpu_torch.ingest.bm25_build import build_bm25_component

    dev = resolve_device(device)
    space = space or TuneSpace()
    n_docs = len(corpus_rows)
    n_pad = -(-n_docs // 128) * 128
    id_to_row = {r["id"]: i for i, r in enumerate(corpus_rows)}
    build_cache: Dict[tuple, tuple] = {}
    history: List[Dict] = []

    def evaluate(params: Dict, q_tokens, gold) -> Dict:
        key = (
            round(params["k1"], 4),
            round(params["b"], 4),
            round(params["epsilon"], 4),
            params["tokenization"],
        )
        if key not in build_cache:
            arrays, vocab, _ = build_bm25_component(
                corpus_rows,
                n_pad,
                use_lemmatized=params["tokenization"] == "lemmatized",
                k1=params["k1"],
                b=params["b"],
                epsilon=params["epsilon"],
                device=dev,
            )
            build_cache[key] = (dense_impact_from_csr(arrays), vocab)
        dense, vocab = build_cache[key]
        terms = np.full((len(q_tokens), 32), -1, np.int32)
        for i, toks in enumerate(q_tokens):
            ids = [vocab.get(t, -1) for t in toks[:32]]
            terms[i, : len(ids)] = ids
        scores = _exact_scores(
            dense, torch.as_tensor(terms, device=dev)).cpu().numpy()
        ranks = []
        for i, g in enumerate(gold):
            row = id_to_row.get(g, -1)
            if row < 0:
                ranks.append(-1)
                continue
            ranks.append(1 + int((scores[i] > scores[i, row]).sum()))
        return calculate_metrics(np.asarray(ranks))

    def objective(x: np.ndarray) -> float:
        tok = space.tokenizations[
            int(round(x[3])) % len(space.tokenizations)
        ]
        params = {
            "k1": float(x[0]),
            "b": float(x[1]),
            "epsilon": float(x[2]),
            "tokenization": tok,
        }
        m = evaluate(params, val_query_tokens[tok], val_gold_ids)
        history.append({**params, **{f"val_{k}": v for k, v in m.items()}})
        logger.info(
            "k1=%.3f b=%.3f eps=%.3f %s -> R@%d=%.4f",
            params["k1"], params["b"], params["epsilon"], tok, recall_k,
            m[f"recall@{recall_k}"],
        )
        return m[f"recall@{recall_k}"]

    bounds = [space.k1, space.b, space.epsilon,
              (0.0, len(space.tokenizations) - 1.0)]
    best_x, best_y, _ = gp_maximize(
        objective, bounds, n_calls=n_calls, n_initial=n_initial, seed=seed
    )
    best = {
        "k1": float(best_x[0]),
        "b": float(best_x[1]),
        "epsilon": float(best_x[2]),
        "tokenization": space.tokenizations[
            int(round(best_x[3])) % len(space.tokenizations)
        ],
    }
    if test_query_tokens is not None and test_gold_ids is not None:
        m = evaluate(
            best, test_query_tokens[best["tokenization"]], test_gold_ids
        )
        history.append({**best, **{f"test_{k}": v for k, v in m.items()}})
    return TuneResult(best_params=best, best_score=best_y, history=history)
