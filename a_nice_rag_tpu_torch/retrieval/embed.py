"""Query/document embedding clients (a copy of the JAX package's
``retrieval/embed.py``, which imports no jax).

The reference embeds queries through the VoyageAI SDK
(``src/search_engine.py:148-159``, input_type="query",
output_dimension=2048) and documents through Voyage/OpenAI batched calls
(``src/processing/create_database.py:27-48``). Here the clients are a
small protocol so the serving path can swap between:

* ``VoyageEmbedder`` / ``OpenAIEmbedder`` — REST calls, env-key gated
  (no SDK dependency; plain HTTPS via urllib),
* ``PrecomputedEmbedder`` — offline lookup table (the reference's eval
  fixture pattern, src/retrieval_eval.py:17-25).

Embeddings come back as float32 numpy arrays; ``SearchEngine`` moves
them to its index's device.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Dict, Optional, Protocol, Sequence

import numpy as np


class Embedder(Protocol):
    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        """[B, D] float32 query embeddings."""
        ...

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        """[N, D] float32 document embeddings."""
        ...


def _post_json(url: str, payload: dict, headers: dict, timeout: float = 60.0) -> dict:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json", **headers},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


class VoyageEmbedder:
    """VoyageAI embeddings over REST. Requires VOYAGE_API_KEY."""

    def __init__(
        self,
        model: str = "voyage-3-large",
        output_dimension: int = 2048,
        api_key: Optional[str] = None,
    ):
        self.model = model
        self.output_dimension = output_dimension
        self.api_key = api_key or os.getenv("VOYAGE_API_KEY")
        if not self.api_key:
            raise ValueError("VOYAGE_API_KEY not set")

    def _embed(self, texts: Sequence[str], input_type: str) -> np.ndarray:
        out = _post_json(
            "https://api.voyageai.com/v1/embeddings",
            {
                "input": list(texts),
                "model": self.model,
                "input_type": input_type,
                "output_dimension": self.output_dimension,
                "truncation": True,
            },
            {"Authorization": f"Bearer {self.api_key}"},
        )
        data = sorted(out["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], dtype=np.float32)

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self._embed(texts, "query")

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return self._embed(texts, "document")


class OpenAIEmbedder:
    """OpenAI embeddings over REST. Requires OPENAI_API_KEY."""

    def __init__(
        self,
        model: str = "text-embedding-3-large",
        api_key: Optional[str] = None,
    ):
        self.model = model
        self.api_key = api_key or os.getenv("OPENAI_API_KEY")
        if not self.api_key:
            raise ValueError("OPENAI_API_KEY not set")

    def _embed(self, texts: Sequence[str]) -> np.ndarray:
        out = _post_json(
            "https://api.openai.com/v1/embeddings",
            {"input": list(texts), "model": self.model},
            {"Authorization": f"Bearer {self.api_key}"},
        )
        data = sorted(out["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], dtype=np.float32)

    embed_queries = _embed
    embed_documents = _embed


class PrecomputedEmbedder:
    """Offline embedder backed by a text -> vector table."""

    def __init__(self, table: Dict[str, np.ndarray]):
        self.table = table

    def _lookup(self, texts: Sequence[str]) -> np.ndarray:
        missing = [t for t in texts if t not in self.table]
        if missing:
            raise KeyError(f"No precomputed embedding for: {missing[:3]}")
        return np.stack([np.asarray(self.table[t], np.float32) for t in texts])

    embed_queries = _lookup
    embed_documents = _lookup
