"""SearchEngine-contract adapter over the mesh-sharded retriever.

Counterpart of ``a_nice_rag_tpu/parallel/engine.py``.
``retrieval.SearchEngine`` serves one device; this adapter exposes the
SAME ``retrieve()`` contract (reference src/query_rag_retrieval.py:
149-407 semantics — per-model weighting, WRRF fusion, filename filter,
optional reranker stage, doc-dict assembly) over a
:class:`~a_nice_rag_tpu_torch.parallel.sharded.ShardedRetriever`, so the RAG
orchestration layer (``rag.RAGSystem``) runs unchanged on a corpus
sharded across a device mesh — including the IVF ANN route
(``nprobe``) and the two-tier streaming BM25 backend.

Retrievers are built lazily and memoized per (models, use_bm25, k, n):
a retriever fixes its list widths and routes at construction, and
serving configurations are stable, so this is a handful in practice.

Deviations from the single-device engine (documented, not silent):

* ``doc["similarity"]`` carries the FUSED WRRF score (the sharded
  retriever never materializes per-ranker score lists on the host); the
  single-device engine reports the first surfacing ranker's raw score.
* ``min_similarity`` is not supported (needs per-ranker dense scores).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from a_nice_rag_tpu_torch.config import Config
from a_nice_rag_tpu_torch.retrieval.engine import MODEL_ORDER
from a_nice_rag_tpu_torch.retrieval.rerank import Reranker, apply_rerank
from a_nice_rag_tpu_torch.text import preprocess_text

logger = logging.getLogger(__name__)


class ShardedSearchEngine:
    """Reference-parity ``retrieve()`` over a sharded corpus mesh."""

    def __init__(
        self,
        sidx,
        embedder=None,
        reranker: Optional[Reranker] = None,
        budget: int = 16384,
        dense_backend: str = "auto",
        bm25_backend: str = "auto",
        nprobe: Optional[int] = None,
        t_max: int = 32,
    ):
        self.sidx = sidx
        self.index = sidx.base_index  # metadata/vocab surface
        self.embedder = embedder
        self.reranker = reranker
        self.budget = budget
        self.dense_backend = dense_backend
        self.bm25_backend = bm25_backend
        self.nprobe = nprobe
        self.t_max = t_max
        self._retrievers: Dict[tuple, object] = {}

    # ------------------------------------------------------------------

    def _retriever(self, models: tuple, use_bm25: bool, k: int, n: int):
        from a_nice_rag_tpu_torch.parallel.sharded import ShardedRetriever

        key = (models, use_bm25, k, n)
        if key not in self._retrievers:
            self._retrievers[key] = ShardedRetriever(
                self.sidx,
                model_names=models,
                use_bm25=use_bm25,
                similarity_k=k,
                common_sections_n=n,
                budget=self.budget,
                dense_backend=self.dense_backend,
                bm25_backend=self.bm25_backend if use_bm25 else "auto",
                nprobe=self.nprobe,
            )
        return self._retrievers[key]

    def rerank_documents(
        self,
        query_text: str,
        documents: List[Dict],
        reranker_model: str = "rerank-2",
        reranker_top_k: Optional[int] = None,
    ) -> List[Dict]:
        return apply_rerank(
            self.reranker, query_text, documents, reranker_model,
            reranker_top_k,
        )

    # ------------------------------------------------------------------

    def retrieve(
        self,
        query_embeddings: Dict[str, np.ndarray],
        query_texts: Optional[Sequence[str]] = None,
        query_token_lists: Optional[Sequence[Sequence[str]]] = None,
        similarity_k: int = 25,
        common_sections_n: int = 15,
        wrrf_k: float = 60.0,
        model_weights: Optional[Dict[str, float]] = None,
        filename_type_filter: Optional[str] = None,
        use_hybrid_search: bool = False,
        use_reranker: bool = False,
        reranker_model: str = "rerank-2-lite",
        reranker_top_k: Optional[int] = 5,
        return_docs: bool = False,
        min_similarity: Optional[float] = None,
    ) -> List[List]:
        """Batched ``retrieve_documents`` semantics over the mesh (see
        module docstring for the two documented deviations)."""
        if min_similarity is not None:
            raise NotImplementedError(
                "min_similarity needs per-ranker dense scores; use the "
                "single-device SearchEngine for threshold-gated retrieval"
            )
        if model_weights is None:
            model_weights = Config.DEFAULT_MODEL_WEIGHTS.copy()
        if not query_embeddings:
            raise ValueError("Query embeddings dictionary cannot be empty")
        if similarity_k <= 0 or common_sections_n <= 0:
            raise ValueError(
                "similarity_k and common_sections_n must be positive integers"
            )

        batch = next(iter(query_embeddings.values()))
        b = np.atleast_2d(np.asarray(batch)).shape[0]
        index = self.index

        active = tuple(
            m
            for m in MODEL_ORDER
            if m in index.dense_model_names
            and model_weights.get(m, 0) > 0
            and m in query_embeddings
        )
        use_bm25 = (
            use_hybrid_search
            and index.bm25 is not None
            and model_weights.get("BM25", 0) > 0
        )
        terms = None
        if use_bm25:
            if query_token_lists is None and query_texts is not None:
                query_token_lists = [
                    preprocess_text(t, use_lemmatization=True)
                    for t in query_texts
                ]
            if query_token_lists is not None:
                # The batch dimension follows the embeddings dict (the
                # single-device engine's convention, incl. the RAG layer's
                # '__none__' placeholder); surplus token lists are cut.
                terms = index.pad_term_ids(query_token_lists, self.t_max)[:b]
                if terms.shape[0] < b:
                    terms = np.pad(
                        terms,
                        ((0, b - terms.shape[0]), (0, 0)),
                        constant_values=-1,
                    )
            else:
                logger.warning(
                    "BM25 search requested but no query_text or "
                    "query_tokens provided - skipping BM25"
                )
                use_bm25 = False
        if not active and not use_bm25:
            return [[] for _ in range(b)]

        retr = self._retriever(
            active, use_bm25, similarity_k, common_sections_n
        )
        q_embs = {
            m: np.atleast_2d(np.asarray(query_embeddings[m], np.float32))
            for m in active
        }

        # The retriever splits the batch over the dp axis; pad to a
        # multiple by repeating the last query, truncate after.
        dp = self.sidx.n_dp
        b_pad = -(-b // dp) * dp
        if b_pad != b:
            q_embs = {
                m: np.concatenate(
                    [q, np.repeat(q[-1:], b_pad - b, axis=0)]
                )
                for m, q in q_embs.items()
            }
            if terms is not None:
                terms = np.concatenate(
                    [terms, np.repeat(terms[-1:], b_pad - b, axis=0)]
                )

        fids, fvals, _ = retr.retrieve_device(
            q_embs, terms, dict(model_weights), filename_type_filter,
            float(wrrf_k),
        )
        fids = fids[:b].cpu().numpy()
        fvals = fvals[:b].cpu().numpy()

        out: List[List] = []
        meta = index.meta
        for qi in range(b):
            docs = []
            for j, row in enumerate(fids[qi]):
                row = int(row)
                if row < 0 or row >= meta.n_docs:
                    continue
                d = meta.doc(row)
                d["similarity"] = float(fvals[qi][j])
                docs.append(d)
            docs = docs[:common_sections_n]
            if use_reranker and len(docs) > 1 and query_texts is not None:
                docs = self.rerank_documents(
                    query_texts[qi], docs, reranker_model, reranker_top_k
                )
            out.append(docs if return_docs else [d["id"] for d in docs])
        return out
