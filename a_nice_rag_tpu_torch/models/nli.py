"""The local faithfulness scorer (the port of the JAX package's
``models/nli.py``).

The reference's FaithfulnesswithHHEM (ragas_modified/metrics/
_faithfulness.py:214) swaps the judge-LLM NLI stage for a local
hallucination-detection classifier. Here the classifier is the
cross-encoder (models/reranker.CrossEncoderReranker) with a sigmoid on
its logit; ``NliScorer`` plugs into ``FaithfulnesswithHHEM(nli_scorer=
scorer)``.

Synthetic pair construction mirrors how faithfulness is actually
violated in RAG answers: entailed hypotheses are sentences drawn from the
premise (optionally truncated, as statement extraction produces);
non-entailed ones are sentences from OTHER documents (topic drift) and
corrupted in-premise sentences (negation insertion / entity swap, the
hard hallucination cases).

``train_nli_scorer`` fine-tunes the cross-encoder with binary
cross-entropy on such pairs; ``nli_scorer_for_corpus`` synthesizes them
from a corpus first.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from a_nice_rag_tpu_torch.device import DeviceLike
from a_nice_rag_tpu_torch.models.encoder import EncoderConfig
from a_nice_rag_tpu_torch.models.reranker import (
    CrossEncoderReranker,
    init_reranker,
    score_pairs,
)
from a_nice_rag_tpu_torch.models.tokenizer import HashingTokenizer
from a_nice_rag_tpu_torch.models.train import adamw

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def _sentences(text: str) -> List[str]:
    return [s.strip() for s in _SENT_SPLIT.split(text) if len(s.strip()) > 20]


def _negate(sentence: str, rng: np.random.Generator) -> str:
    """Corrupt a sentence into a plausible contradiction."""
    words = sentence.split()
    swaps = {
        "is": "is not", "are": "are not", "should": "should not",
        "can": "cannot", "increases": "decreases", "decreases": "increases",
        "recommended": "not recommended", "with": "without",
    }
    for i, w in enumerate(words):
        if w.lower() in swaps:
            words[i] = swaps[w.lower()]
            return " ".join(words)
    # no swap site: replace a number, else shuffle a content word in
    for i, w in enumerate(words):
        if any(ch.isdigit() for ch in w):
            words[i] = str(rng.integers(100, 999))
            return " ".join(words)
    j = int(rng.integers(0, len(words)))
    words[j] = "unrelated"
    return " ".join(words)


def synth_nli_pairs(
    documents: Sequence[str],
    n_pairs: int = 512,
    seed: int = 0,
) -> Tuple[List[str], List[str], np.ndarray]:
    """(premises, hypotheses, labels[0/1]) from a document collection."""
    rng = np.random.default_rng(seed)
    doc_sents = [_sentences(d) for d in documents]
    usable = [i for i, s in enumerate(doc_sents) if len(s) >= 2]
    if len(usable) < 2:
        raise ValueError("need at least 2 documents with 2+ sentences each")
    prem, hyp, lab = [], [], []
    while len(prem) < n_pairs:
        di = int(rng.choice(usable))
        sents = doc_sents[di]
        premise = " ".join(sents)
        kind = int(rng.integers(0, 4))
        if kind <= 1:  # entailed: an in-premise sentence (maybe truncated)
            s = sents[int(rng.integers(0, len(sents)))]
            if kind == 1 and len(s.split()) > 8:
                s = " ".join(s.split()[: int(rng.integers(6, len(s.split())))])
            prem.append(premise); hyp.append(s); lab.append(1)
        elif kind == 2:  # topic drift: sentence from another document
            dj = int(rng.choice([u for u in usable if u != di]))
            s = doc_sents[dj][int(rng.integers(0, len(doc_sents[dj])))]
            prem.append(premise); hyp.append(s); lab.append(0)
        else:  # hard negative: corrupted in-premise sentence
            s = sents[int(rng.integers(0, len(sents)))]
            prem.append(premise); hyp.append(_negate(s, rng)); lab.append(0)
    return prem, hyp, np.asarray(lab, np.float32)


class NliScorer:
    """``scorer(premise, hypothesis) -> P(entailed)`` for HHEM, over a
    ``CrossEncoderReranker`` on its device."""

    def __init__(self, model: CrossEncoderReranker,
                 tokenizer: HashingTokenizer):
        self.model = model
        self.tokenizer = tokenizer

    def score_batch(
        self, premises: Sequence[str], hypotheses: Sequence[str]
    ) -> np.ndarray:
        # The hypothesis rides the QUERY slot: encode_pairs caps the query
        # segment at max_len // 3, so a (long) premise there would be
        # truncated and every entailed sentence from the rest of the
        # document would read as hallucinated. The document slot keeps
        # the remainder of the window.
        ids = self.tokenizer.encode_pairs(list(hypotheses), list(premises))
        return torch.sigmoid(score_pairs(self.model, ids)).cpu().numpy()

    def __call__(self, premise: str, hypothesis: str) -> float:
        return float(self.score_batch([premise], [hypothesis])[0])


def _auc(scores: np.ndarray, labels: np.ndarray) -> float:
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float(
        (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    )


@dataclass
class NliTrainResult:
    scorer: NliScorer
    losses: List[float]
    holdout_auc: float


def train_nli_scorer(
    premises: Sequence[str],
    hypotheses: Sequence[str],
    labels: np.ndarray,
    cfg: Optional[EncoderConfig] = None,
    batch_size: int = 32,
    epochs: int = 3,
    lr: float = 1e-3,
    seed: int = 0,
    holdout_fraction: float = 0.15,
    tokenizer: Optional[HashingTokenizer] = None,
    use_match_features: bool = True,
    init: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = "cuda",
) -> NliTrainResult:
    """Binary cross-entropy fine-tune of the cross-encoder on NLI pairs,
    on ``device`` (the card unless asked otherwise); ``init`` (a state
    dict) replaces the seeded initial weights.

    ``use_match_features`` (default on) feeds the cross-segment lexical
    interaction features: entailment-as-containment is exactly the signal
    they encode, and without them a small from-scratch transformer cannot
    learn token-identity copy detection."""
    cfg = cfg or EncoderConfig(n_layers=2)
    # max_len follows cfg: the tokenizer's default (128) would re-truncate
    # long premises and read their tails as hallucinated.
    tok = tokenizer or HashingTokenizer(vocab_size=cfg.vocab_size,
                                        max_len=cfg.max_len)
    model = init_reranker(cfg, seed, device, use_match_features)
    if init is not None:
        model.load_state_dict(init)
    dev = model.embed.weight.device
    rng = np.random.default_rng(seed)
    n = len(premises)
    perm = rng.permutation(n)
    n_hold = max(1, int(n * holdout_fraction))
    hold, train = perm[:n_hold], perm[n_hold:]

    # Hypothesis in the query slot, premise in the (long) document slot,
    # as NliScorer.score_batch serves them.
    ids = torch.as_tensor(tok.encode_pairs(list(hypotheses), list(premises)),
                          device=dev)
    y = torch.as_tensor(np.asarray(labels, np.float32), device=dev)
    optimizer = adamw(model.parameters(), lr)

    losses: List[float] = []
    for _ in range(epochs):
        order = rng.permutation(train)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            b = torch.as_tensor(order[i:i + batch_size], device=dev)
            optimizer.zero_grad(set_to_none=True)
            loss = F.binary_cross_entropy_with_logits(model(ids[b]), y[b])
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))

    scorer = NliScorer(model, tok)
    hold_scores = torch.sigmoid(score_pairs(
        model, ids[torch.as_tensor(hold, device=dev)])).cpu().numpy()
    auc = _auc(hold_scores, np.asarray(labels)[hold])
    return NliTrainResult(scorer=scorer, losses=losses, holdout_auc=auc)


def nli_scorer_for_corpus(
    documents: Sequence[str],
    n_pairs: int = 512,
    seed: int = 0,
    **train_kwargs,
) -> NliTrainResult:
    """One-call recipe: synthesize pairs from the corpus and fine-tune.

    The returned result's ``.scorer`` drops into
    ``FaithfulnesswithHHEM(llm=judge, nli_scorer=result.scorer)``.
    """
    prem, hyp, lab = synth_nli_pairs(documents, n_pairs=n_pairs, seed=seed)
    return train_nli_scorer(prem, hyp, lab, seed=seed, **train_kwargs)
