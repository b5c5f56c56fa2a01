"""Train the on-device cross-encoder reranker on retrieval candidates (the
port of the JAX package's ``models/rerank_train.py``).

The reference's best configuration is hybrid retrieval + the Voyage
rerank-2 API, lifting Recall@1 from 0.699 to 0.810 (reference
src/retrieval_eval.py:131-255; results/retrieval_evaluation_results.csv
rows 9-10). This module is the local analog: a listwise-trained
CrossEncoderReranker that drops into the same ``SearchEngine`` rerank
stage via ``OnDeviceReranker``.

Training objective: per query, softmax cross-entropy over the scores of
[gold ; K hard negatives], the gold at slot 0: the decision the rerank
stage makes at serving time (order a small candidate pool).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from a_nice_rag_tpu_torch.device import DeviceLike
from a_nice_rag_tpu_torch.models.encoder import EncoderConfig
from a_nice_rag_tpu_torch.models.reranker import (
    OnDeviceReranker,
    init_reranker,
    score_pairs,
)
from a_nice_rag_tpu_torch.models.tokenizer import HashingTokenizer
from a_nice_rag_tpu_torch.models.train import adamw


@dataclass
class RerankTrainResult:
    reranker: OnDeviceReranker
    losses: List[float]
    holdout_accuracy: float  # gold-ranked-first rate on held-out lists


def train_cross_encoder_reranker(
    queries: Sequence[str],
    candidates: Sequence[Sequence[str]],  # per query: [gold, neg1..negK]
    cfg: Optional[EncoderConfig] = None,
    batch_size: int = 16,
    epochs: int = 4,
    lr: float = 1e-3,
    seed: int = 0,
    holdout_fraction: float = 0.15,
    tokenizer: Optional[HashingTokenizer] = None,
    use_match_features: bool = True,
    init: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = "cuda",
) -> RerankTrainResult:
    """Listwise fine-tune on ``device`` (the card unless asked otherwise);
    the gold candidate must be listed first, and every list must share
    one length. ``init`` (a state dict) replaces the seeded initial
    weights. The holdout is the first ``holdout_fraction`` of the seeded
    permutation."""
    cfg = cfg or EncoderConfig(n_layers=2)
    tok = tokenizer or HashingTokenizer(vocab_size=cfg.vocab_size)
    model = init_reranker(cfg, seed, device, use_match_features)
    if init is not None:
        model.load_state_dict(init)
    dev = model.embed.weight.device
    rng = np.random.default_rng(seed)

    n = len(queries)
    k = len(candidates[0])
    if any(len(cs) != k for cs in candidates):
        raise ValueError("ragged candidate lists")
    flat_q = [q for q, cs in zip(queries, candidates) for _ in cs]
    flat_d = [d for cs in candidates for d in cs]
    ids = torch.as_tensor(tok.encode_pairs(flat_q, flat_d),
                          device=dev).reshape(n, k, -1)

    perm = rng.permutation(n)
    n_hold = max(1, int(n * holdout_fraction))
    hold, train = perm[:n_hold], perm[n_hold:]
    optimizer = adamw(model.parameters(), lr)
    gold = torch.zeros(batch_size, dtype=torch.long, device=dev)

    losses: List[float] = []
    for _ in range(epochs):
        order = rng.permutation(train)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            batch = ids[torch.as_tensor(order[i:i + batch_size], device=dev)]
            optimizer.zero_grad(set_to_none=True)
            logits = model(batch.reshape(batch_size * k, -1)).reshape(
                batch_size, k)
            loss = F.cross_entropy(logits, gold)
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))

    h = ids[torch.as_tensor(hold, device=dev)]
    logits = score_pairs(model, h.reshape(len(hold) * k, -1)).reshape(
        len(hold), k).cpu().numpy()
    acc = float(np.mean(np.argmax(logits, axis=1) == 0))
    return RerankTrainResult(
        reranker=OnDeviceReranker(cfg, model.state_dict(), tok,
                                  use_match_features=use_match_features,
                                  device=dev),
        losses=losses,
        holdout_accuracy=acc,
    )


def mine_candidates(
    query_texts: Sequence[str],
    gold_rows: Sequence[int],
    ranked_rows: np.ndarray,  # [Q, >=k] retrieval rows per query
    contents: Sequence[str],
    n_negatives: int = 7,
    seed: int = 0,
) -> Tuple[List[str], List[List[str]]]:
    """Build [gold ; hard negatives] training lists from retrieval output.

    Hard negatives are the retriever's own top-ranked non-gold documents
    — the exact confusions the rerank stage must fix at serving time.
    Short lists are topped up with random corpus rows.
    """
    rng = np.random.default_rng(seed)
    out_q: List[str] = []
    out_c: List[List[str]] = []
    n_docs = len(contents)
    for qi, (qt, g) in enumerate(zip(query_texts, gold_rows)):
        negs = [int(r) for r in ranked_rows[qi] if 0 <= r != g][:n_negatives]
        while len(negs) < n_negatives:
            r = int(rng.integers(0, n_docs))
            if r != g and r not in negs:
                negs.append(r)
        out_q.append(qt)
        out_c.append([contents[g]] + [contents[r] for r in negs])
    return out_q, out_c
