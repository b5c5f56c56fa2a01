"""Judge embedding wrappers (ragas_modified/embeddings/base.py surface)."""

from __future__ import annotations

import asyncio
from typing import Sequence

import numpy as np


class BaseJudgeEmbeddings:
    async def aembed_texts(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    async def aembed_query(self, text: str) -> np.ndarray:
        return (await self.aembed_texts([text]))[0]


class EmbedderJudgeEmbeddings(BaseJudgeEmbeddings):
    """Adapter over any retrieval.embed Embedder (Voyage/OpenAI/on-device)."""

    def __init__(self, embedder):
        self.embedder = embedder

    async def aembed_texts(self, texts):
        return await asyncio.to_thread(self.embedder.embed_queries, list(texts))


class FakeJudgeEmbeddings(BaseJudgeEmbeddings):
    """Deterministic hash-based unit vectors for tests. Identical texts
    embed identically; different texts are nearly orthogonal."""

    def __init__(self, dim: int = 64):
        self.dim = dim

    def _one(self, text: str) -> np.ndarray:
        rng = np.random.default_rng(abs(hash(text)) % (2**32))
        v = rng.standard_normal(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    async def aembed_texts(self, texts):
        return np.stack([self._one(t) for t in texts])
