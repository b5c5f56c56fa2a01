"""RetrievalEvaluationSystem: offline retrieval facade.

Counterpart of ``a_nice_rag_tpu/retrieval/eval_system.py``: the
reference's evaluation twin (src/query_rag_retrieval.py:20-411), with
precomputed query embeddings and tokens so benchmark runs need no
embedding APIs. A thin facade over ``SearchEngine.retrieve`` with the
reference's defaults (wrrf_k=60, rerank-2-lite top 5; they differ from
the serve path's defaults, as in the reference).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from a_nice_rag_tpu_torch.config import Config, InfoSource
from a_nice_rag_tpu_torch.index.array_index import ArrayIndex
from a_nice_rag_tpu_torch.retrieval.engine import SearchEngine
from a_nice_rag_tpu_torch.retrieval.rerank import Reranker


class RetrievalEvaluationSystem:
    def __init__(
        self,
        indexes: Optional[Dict[InfoSource, ArrayIndex]] = None,
        reranker: Optional[Reranker] = None,
    ):
        self.config = Config()
        self.engines: Dict[InfoSource, SearchEngine] = {}
        if indexes:
            for source, idx in indexes.items():
                self.engines[source] = SearchEngine(idx, reranker=reranker)

    def attach_index(self, source: InfoSource, index: ArrayIndex,
                     reranker: Optional[Reranker] = None) -> None:
        self.engines[source] = SearchEngine(index, reranker=reranker)

    def retrieve_documents(
        self,
        query_embeddings: Dict[str, np.ndarray],
        query_text: Optional[str] = None,
        query_tokens: Optional[Sequence[str]] = None,
        similarity_k: int = 25,
        common_sections_n: int = 15,
        info_source: str = "NICE",
        model_weights: Optional[Dict[str, float]] = None,
        filename_type_filter: Optional[str] = None,
        use_hybrid_search: bool = False,
        wrrf_k: float = 60.0,
        use_reranker: bool = True,
        reranker_model: str = "rerank-2-lite",
        reranker_top_k: Optional[int] = 5,
        return_docs: bool = False,
    ) -> List:
        """Single-query retrieval with precomputed inputs; returns ranked
        section ids (or doc dicts)."""
        if not query_embeddings:
            raise ValueError("Query embeddings dictionary cannot be empty")
        for model, emb in query_embeddings.items():
            arr = np.asarray(emb)
            if arr.size == 0:
                raise ValueError(f"Embedding for {model} cannot be empty")
        source = InfoSource(info_source.lower())
        if source not in self.engines:
            return []
        engine = self.engines[source]
        out = engine.retrieve(
            query_embeddings={
                m: np.atleast_2d(np.asarray(v)) for m, v in
                query_embeddings.items()
            },
            query_texts=[query_text] if query_text else None,
            query_token_lists=[list(query_tokens)] if query_tokens else None,
            similarity_k=similarity_k,
            common_sections_n=common_sections_n,
            wrrf_k=wrrf_k,
            model_weights=model_weights,
            filename_type_filter=filename_type_filter,
            use_hybrid_search=use_hybrid_search,
            use_reranker=use_reranker and query_text is not None,
            reranker_model=reranker_model,
            reranker_top_k=reranker_top_k,
            return_docs=return_docs,
        )
        return out[0]
