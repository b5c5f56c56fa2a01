"""The local faithfulness scorer, inference half (the port of the JAX
package's ``models/nli.py``).

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

Fine-tuning (``train_nli_scorer``, ``nli_scorer_for_corpus``) is
training, which the port does not have yet (ROADMAP item 9).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.models.reranker import (
    CrossEncoderReranker,
    score_pairs,
)
from a_nice_rag_tpu_torch.models.tokenizer import HashingTokenizer

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")
_TRAINING = ("NLI fine-tuning is training, which is not ported to "
             "a_nice_rag_tpu_torch yet: ROADMAP queue 1, item 9 (training)")


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


def train_nli_scorer(*args, **kwargs):
    """Binary cross-entropy fine-tune of the cross-encoder on NLI pairs:
    waits for ROADMAP item 9 (training)."""
    raise NotImplementedError(_TRAINING)


def nli_scorer_for_corpus(*args, **kwargs):
    """Synthesize pairs from a corpus and fine-tune: waits for ROADMAP
    item 9 (training)."""
    raise NotImplementedError(_TRAINING)
