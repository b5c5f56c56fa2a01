"""String/overlap metrics (no LLM): ExactMatch, StringPresence,
NonLLMStringSimilarity (Levenshtein ratio), BLEU, ROUGE-L
(ragas_modified/metrics/_string.py, _bleu_score.py, _rouge_score.py) —
all self-contained implementations of the standard formulas.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import ClassVar, List

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import Metric, SingleTurnMetric


def levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(
                min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            )
        prev = cur
    return prev[-1]


def string_similarity(a: str, b: str) -> float:
    """1 - normalized Levenshtein distance."""
    if not a and not b:
        return 1.0
    denom = max(len(a), len(b))
    return 1.0 - levenshtein(a, b) / denom if denom else 1.0


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(candidate: str, reference: str, max_n: int = 4) -> float:
    """Sentence BLEU with uniform n-gram weights + brevity penalty."""
    cand = candidate.split()
    ref = reference.split()
    if not cand or not ref:
        return 0.0
    log_precisions = []
    for n in range(1, max_n + 1):
        cand_ngrams = _ngrams(cand, n)
        ref_ngrams = _ngrams(ref, n)
        total = sum(cand_ngrams.values())
        if total == 0:
            log_precisions.append(float("-inf"))
            continue
        clipped = sum(
            min(count, ref_ngrams.get(gram, 0))
            for gram, count in cand_ngrams.items()
        )
        # Smoothed precision (epsilon for zero matches).
        p = clipped / total if clipped else 0.1 / total
        log_precisions.append(math.log(p))
    if all(p == float("-inf") for p in log_precisions):
        return 0.0
    geo = math.exp(sum(log_precisions) / max_n)
    bp = (
        1.0
        if len(cand) >= len(ref)
        else math.exp(1 - len(ref) / max(len(cand), 1))
    )
    return bp * geo


def rouge_l(candidate: str, reference: str, mode: str = "fmeasure") -> float:
    """ROUGE-L via longest common subsequence of whitespace tokens."""
    cand = candidate.split()
    ref = reference.split()
    if not cand or not ref:
        return 0.0
    prev = [0] * (len(ref) + 1)
    for a in cand:
        cur = [0]
        for j, b in enumerate(ref, 1):
            cur.append(prev[j - 1] + 1 if a == b else max(prev[j], cur[-1]))
        prev = cur
    lcs = prev[-1]
    precision = lcs / len(cand)
    recall = lcs / len(ref)
    if mode == "precision":
        return precision
    if mode == "recall":
        return recall
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


class ExactMatch(SingleTurnMetric):
    name: ClassVar[str] = "exact_match"
    required_columns: ClassVar[set] = {"response", "reference"}

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        return float(sample.response == sample.reference)


class StringPresence(SingleTurnMetric):
    name: ClassVar[str] = "string_present"
    required_columns: ClassVar[set] = {"response", "reference"}

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        return float(sample.reference in sample.response)


class NonLLMStringSimilarity(SingleTurnMetric):
    name: ClassVar[str] = "non_llm_string_similarity"
    required_columns: ClassVar[set] = {"response", "reference"}

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        return string_similarity(sample.response, sample.reference)


class BleuScore(SingleTurnMetric):
    name: ClassVar[str] = "bleu_score"
    required_columns: ClassVar[set] = {"response", "reference"}

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        return bleu(sample.response, sample.reference)


class RougeScore(SingleTurnMetric):
    name: ClassVar[str] = "rouge_score"
    required_columns: ClassVar[set] = {"response", "reference"}

    def __init__(self, rouge_type: str = "rougeL", mode: str = "fmeasure"):
        self.rouge_type = rouge_type
        self.mode = mode

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        return rouge_l(sample.response, sample.reference, self.mode)
