"""Embedding cosine similarity between response and reference
(ragas_modified/metrics/_answer_similarity.py)."""

from __future__ import annotations

from typing import ClassVar

import numpy as np

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    MetricWithEmbeddings,
    SingleTurnMetric,
)


class SemanticSimilarity(MetricWithEmbeddings, SingleTurnMetric):
    name: ClassVar[str] = "semantic_similarity"
    required_columns: ClassVar[set] = {"response", "reference"}

    def __init__(self, embeddings=None, threshold=None):
        self.embeddings = embeddings
        self.threshold = threshold

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        vecs = await self.embeddings.aembed_texts(
            [sample.response, sample.reference]
        )
        a, b = np.asarray(vecs[0]), np.asarray(vecs[1])
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        sim = float(a @ b / denom) if denom else 0.0
        if self.threshold is not None:
            return float(sim >= self.threshold)
        return sim


AnswerSimilarity = SemanticSimilarity
