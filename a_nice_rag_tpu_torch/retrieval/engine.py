"""Hybrid retrieval over the array index: :class:`SearchEngine` and
:class:`FusedRetriever`.

Counterpart of ``a_nice_rag_tpu/retrieval/engine.py``:

* :class:`SearchEngine` keeps the reference system's per-method API
  (similarity search, BM25 search, WRRF, rerank, ``retrieve``), batched
  first, with the JAX package's names and signatures. Like the JAX
  package's, it scores on the plain routes (materialized [B, N] scores
  and a stable top-k), never the fused kernels; scores and lists stay
  on the index's device, and results come back as numpy arrays and
  Python lists where the JAX package returns those.
* :class:`FusedRetriever` runs every active ranker (dense models, BM25),
  WRRF fusion and the final top-n in one call, with inputs and outputs
  on the index's device. At corpus scale on a CUDA device the dense
  lists and the common tier of two-tier BM25 stream through the fused
  top-k kernels (``ops.kernels``) instead of materializing [B, N]
  scores. With ``nprobe`` set, models with an attached IVF take the ANN
  route: a tile table built on the device and K3/K4 over its tiles only.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.config import Config
from a_nice_rag_tpu_torch.index.array_index import ArrayIndex
from a_nice_rag_tpu_torch.index.ivf import (
    build_tile_table,
    default_max_tiles,
    ivf_top_k,
)
from a_nice_rag_tpu_torch.ops.bm25 import (
    Bm25TwoTier,
    bm25_scores,
    bm25_scores_dense,
    bm25_scores_dense_gather,
    bm25_top_k_sparse,
    bm25_top_k_two_tier,
    split_two_tier,
)
from a_nice_rag_tpu_torch.ops.dense import dense_scores
from a_nice_rag_tpu_torch.ops.fusion import wrrf_top_n, wrrf_top_n_sparse
from a_nice_rag_tpu_torch.ops.kernels import (
    bm25_sparse_top_k,
    fused_dense_top_k,
    fused_dense_top_k_int8,
)
from a_nice_rag_tpu_torch.ops.kernels._launches import count_launch
from a_nice_rag_tpu_torch.ops.kernels.bm25_sparse import (
    kernel_route as bm25_kernel_route,
)
from a_nice_rag_tpu_torch.ops.quantized import (
    QuantizedDense,
    quantize_queries,
    quantized_dense_scores,
)
from a_nice_rag_tpu_torch.ops.topk import masked_top_k
from a_nice_rag_tpu_torch.retrieval.rerank import Reranker, apply_rerank
from a_nice_rag_tpu_torch.text import preprocess_text
from a_nice_rag_tpu_torch.utils.trace import span

logger = logging.getLogger(__name__)

# Model iteration order mirrors the reference's fixed search order
# (src/query_rag_retrieval.py:197-301).
MODEL_ORDER = ("voyage-3-large", "voyage-3.5", "text-embedding-3-large",
               "Qwen3")
DENSE_BACKENDS = ("auto", "kernel", "torch")
IVF_ROUTES = ("auto", "always")


def _ivf_coverage(batch: int, nprobe: int, n_clusters: int) -> float:
    """Expected fraction of clusters a batch's probe union schedules under
    uniform cluster draws: ``1 - (1 - p/C)^B``. Host arithmetic on ints,
    so the route it picks costs nothing per call."""
    if n_clusters <= 0:
        return 1.0
    p = min(nprobe, n_clusters) / n_clusters
    return 1.0 - (1.0 - p) ** max(1, batch)


def plan_for(kernel_config, b: int):
    """K1's plan override for a call of ``b`` queries: the retriever's
    ``KernelConfig`` where it applies (``for_batch``), else None."""
    return None if kernel_config is None else kernel_config.for_batch(b)


def rounded_fold(kernel_config) -> bool:
    """Whether the retriever's dense lists take the rounded fold
    (``KernelConfig.rounded``): at every batch, unlike its plan."""
    return kernel_config is not None and kernel_config.rounded


def _finite_ids(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(vals), idx, -1).to(torch.int32)


def _dense_list(emb, q, mask, k):
    """Per-model ranked list: (scores, ids) [B, k], -1 where masked out."""
    vals, idx = masked_top_k(dense_scores(emb, q), k, mask[None, :])
    return vals, _finite_ids(vals, idx)


def _dense_list_q(qd, q, mask, k):
    """Per-model ranked list over an int8-quantized matrix (queries
    quantized on the fly; exact int32 sums, selection on
    acc * s_q * s_d)."""
    qv, qs = quantize_queries(q)
    scores = quantized_dense_scores(qd, qv, qs)
    vals, idx = masked_top_k(scores, k, mask[None, :])
    return vals, _finite_ids(vals, idx)


def _bm25_list(bm25, q_terms, mask, k, budget):
    """BM25 list from the CSR scatter. Zero scores stay finite, so a short
    list is filled with zero-score ids under the tie rule, not -1."""
    vals, idx = masked_top_k(bm25_scores(bm25, q_terms, budget), k,
                             mask[None, :])
    return vals, _finite_ids(vals, idx)


def _bm25_list_dense(bm25_dense, q_terms, mask, k):
    """BM25 list from the dense impact matrix: small batches read only the
    query terms' impact rows; the matmul form once B*T passes V/2."""
    b, t = q_terms.shape
    if b * t <= bm25_dense.vocab_size // 2:
        scores = bm25_scores_dense_gather(bm25_dense, q_terms)
    else:
        scores = bm25_scores_dense(bm25_dense, q_terms)
    vals, idx = masked_top_k(scores, k, mask[None, :])
    return vals, _finite_ids(vals, idx)


class FusedRetriever:
    """Hybrid retrieval for a fixed configuration.

    Static configuration: which dense models participate, whether BM25
    participates, similarity_k, common_sections_n, postings budget.
    Per call: query embeddings, query term ids, filter, fusion weights,
    wrrf_k.
    """

    # From this document count on a CUDA device, scores are streamed
    # through the fused top-k kernels instead of materialized.
    KERNEL_THRESHOLD = 1 << 19

    @classmethod
    def _route_kernel(cls, dense_backend: str, n_pad: int,
                      similarity_k: int, device_type: str) -> bool:
        """Backend routing decision, factored out for direct testing."""
        if dense_backend == "kernel":
            return True
        return (
            dense_backend == "auto"
            and device_type == "cuda"
            and n_pad >= cls.KERNEL_THRESHOLD
            and similarity_k <= 128
        )

    def __init__(
        self,
        index: ArrayIndex,
        model_names: Sequence[str],
        use_bm25: bool,
        similarity_k: int = 25,
        common_sections_n: int = 15,
        budget: int = 16384,
        dense_backend: str = "auto",
        nprobe: Optional[int] = None,
        ivf_max_tiles: Optional[int] = None,
        ivf_route: str = "auto",
        ivf_max_coverage: float = 0.25,
        two_tier_common="auto",
        two_tier_dtype: str = "bfloat16",
        t_max_hint: int = 16,
        kernel_config=None,
    ):
        """``dense_backend``: "auto" (the kernels on CUDA at scale),
        "kernel" (always the kernels; on CPU tensors their plain
        versions) or "torch" (materialized scores).

        ``two_tier_common``: "auto" splits the top-df terms of a skewed
        CSR-only corpus into a dense tier streamed through the kernel
        when the sparse fetch would be unaffordable (smallest power of
        two that makes the rare side affordable, capped at 1 GB of bf16
        rows); an int forces that width; 0/None disables. Only on the
        kernel route.

        ``nprobe``: opt-in ANN. Models with an attached IVF
        (``index.ivf``, see ``index.ivf.attach_ivf``) probe their top
        ``nprobe`` clusters and score only the covering tiles (K3/K4).
        Only unmasked calls probe: a filter or a tombstone takes the
        exact route. ``ivf_max_tiles`` caps the tile table (default: no
        truncation). ``ivf_route`` "auto" probes while the expected
        cluster coverage ``1 - (1 - p/C)^B`` stays at or below
        ``ivf_max_coverage`` (wider batches stream the whole corpus,
        whose cost is shared by the batch); "always" probes at every
        batch size. The 0.25 default is the JAX package's.

        ``kernel_config``: K1's query block and doc splits
        (``ops.kernels.autotune.KernelConfig``, as ``tune_fused_blocks``
        picks them) for the float dense lists, at the batch it was tuned
        at (``KernelConfig.for_batch``); None keeps the plan's own. int8
        matrices keep K2's plan. It spreads the work only: the lists are
        the default plan's. Its ``rounded`` puts every dense list of the
        kernel route, float and int8, on the rounded fold (K1r / K2r; the
        JAX package's ``FusedKernelConfig(..., "packed")``) at every
        batch; a filtered call, or a matrix of N % 1024 != 0 rows, keeps
        the exact fold, as there.

        On the kernel route a CSR-only BM25 list reports -1 for
        zero-score slots, while the torch scatter route fills them with
        arbitrary zero-score ids, so a query matching fewer than
        similarity_k docs can yield a shorter fused list there.
        """
        if ivf_route not in IVF_ROUTES:
            raise ValueError(
                f"ivf_route must be one of {IVF_ROUTES}, got {ivf_route!r}"
            )
        if dense_backend not in DENSE_BACKENDS:
            raise ValueError(
                f"dense_backend must be one of {DENSE_BACKENDS}, got "
                f"{dense_backend!r}"
            )
        self.index = index
        self.device = index.device
        self.model_names = tuple(model_names)
        self.use_bm25 = use_bm25
        similarity_k = min(similarity_k, index.n_docs)
        common_sections_n = min(common_sections_n, index.n_docs_padded)
        self.similarity_k = similarity_k
        self.common_sections_n = common_sections_n
        self.budget = budget
        n_pad = index.n_docs_padded
        n_lists = len(self.model_names) + (1 if use_bm25 else 0)
        if n_lists == 0:
            raise ValueError("FusedRetriever needs at least one ranker")
        self._use_dense_bm25 = use_bm25 and index.bm25_dense is not None
        self._csr_df_cap = None
        if use_bm25 and not self._use_dense_bm25 and index.bm25_stats:
            self._csr_df_cap = (
                int(index.bm25_stats.get("max_df", 0) or 0) or None
            )
        use_kernel = self._route_kernel(
            dense_backend, n_pad, similarity_k, self.device.type
        )
        self._two_tier = None
        self._tt_rare_cap = None
        if (
            use_bm25 and not self._use_dense_bm25 and use_kernel
            and two_tier_common and index.bm25 is not None
        ):
            df = np.diff(index.bm25.indptr.cpu().numpy())
            if df.size:
                sorted_df = np.sort(df)[::-1]
                affordable = sorted_df * t_max_hint <= 4 * budget
                if two_tier_common == "auto":
                    if affordable[0]:
                        v_common = 0  # single tier already affordable
                    else:
                        first_ok = int(np.argmax(affordable))
                        v_common = 1 << max(first_ok - 1, 0).bit_length()
                        v_common = min(v_common, df.size)
                        if n_pad * v_common * 2 > (1 << 30):
                            v_common = 0  # dense tier too big: keep CSR
                else:
                    v_common = int(two_tier_common)
                if v_common > 0:
                    self._two_tier = split_two_tier(
                        index.bm25, v_common, two_tier_dtype
                    )
                    rare_df = np.diff(self._two_tier.rare.indptr.cpu().numpy())
                    rmax = int(rare_df.max()) if rare_df.size else 0
                    if rmax and rmax * t_max_hint <= 4 * budget:
                        self._tt_rare_cap = rmax
        # Exposed so callers can assert which route the configuration
        # took.
        self.use_kernel = use_kernel
        self.kernel_config = kernel_config
        self.nprobe = nprobe
        self.ivf_max_tiles = ivf_max_tiles
        self.ivf_route = ivf_route
        self.ivf_max_coverage = float(ivf_max_coverage)
        self._ivf_structs = tuple(
            (index.ivf or {}).get(m) if nprobe else None
            for m in self.model_names
        )
        # The serving fronts call retrieve_device from several dispatch
        # threads at once: the lock guards the cache's reads, inserts and
        # evictions.
        self._const_cache: Dict[tuple, torch.Tensor] = {}
        self._cache_lock = threading.Lock()

    def run(self, dense_mats, bm25_arrays, q_embs, q_terms, mask, bm25_mask,
            weights, wrrf_k) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """All rankers, fusion and top-n. Returns (fused ids [B, n] i32,
        fused scores [B, n] f32, per-list ids [L, B, k] i32)."""
        k = self.similarity_k
        n = self.common_sections_n
        rounded = rounded_fold(self.kernel_config)
        lists = []
        for mat, q, iv in zip(dense_mats, q_embs, self._ivf_structs):
            with span("dense"):
                if self._probe(iv, q.shape[0], mask):
                    lists.append(self._ivf_list(iv, q))
                    continue
                quantized = isinstance(mat, QuantizedDense)
                if self.use_kernel and quantized:
                    qv, qs = quantize_queries(q)
                    _, idx = fused_dense_top_k_int8(
                        mat.values, mat.scales, qv, qs, k, mask=mask,
                        rounded=rounded,
                    )
                    lists.append(idx)
                    continue
                if self.use_kernel:
                    _, idx = fused_dense_top_k(
                        mat, q, k, mask=mask,
                        plan=plan_for(self.kernel_config, q.shape[0]),
                        rounded=rounded)
                    lists.append(idx)
                    continue
                if quantized:
                    qv, qs = quantize_queries(q)
                    scores = quantized_dense_scores(mat, qv, qs)
                else:
                    scores = dense_scores(mat, q)
                vals, idx = masked_top_k(
                    scores, k, None if mask is None else mask[None, :]
                )
                lists.append(_finite_ids(vals, idx))
        if self.use_bm25:
            with span("bm25"):
                lists.append(self._bm25_list(bm25_arrays, q_terms,
                                             bm25_mask))
        if len(lists) == 1:
            ids = lists[0][:, :n]
            return (ids, torch.zeros(ids.shape, device=ids.device),
                    lists[0][None])
        with span("fusion"):
            all_idx = torch.stack(lists)  # [L, B, K]
            if self.use_kernel:
                # Large corpora: fuse on the id lists directly (the
                # scatter form would allocate [B, N_pad]).
                fvals, fids = wrrf_top_n_sparse(all_idx, weights, n, wrrf_k)
            else:
                fvals, fids = wrrf_top_n(
                    all_idx, weights, n, self.index.n_docs_padded, wrrf_k
                )
            return _finite_ids(fvals, fids), fvals, all_idx

    def _probe(self, iv, batch: int, mask) -> bool:
        """The IVF route for this call: an IVF is attached, no mask is
        active, and the route or the coverage rule allows it."""
        return iv is not None and mask is None and (
            self.ivf_route == "always"
            or _ivf_coverage(batch, self.nprobe, iv.n_clusters)
            <= self.ivf_max_coverage
        )

    def _ivf_list(self, iv, q: torch.Tensor) -> torch.Tensor:
        """ANN ids [B, similarity_k] (original rows, -1 unfilled): the
        tile table of the batch's probed clusters, then K3/K4."""
        mt = self.ivf_max_tiles or default_max_tiles(iv, q.shape[0],
                                                     self.nprobe)
        table, _ = build_tile_table(
            iv.centroids, iv.cluster_start, q,
            nprobe=min(self.nprobe, iv.n_clusters), max_tiles=mt,
            tile_n=iv.tile_n, mct=iv.max_cluster_tiles,
        )
        return ivf_top_k(iv, q, table, self.similarity_k)[1]

    def _bm25_list(self, bm25_arrays, q_terms, bm25_mask) -> torch.Tensor:
        k = self.similarity_k
        budget = self.budget
        cap = self._csr_df_cap
        if self._use_dense_bm25:
            # Small batches read only the query-term impact rows; the
            # matmul form pays off once B*T approaches the vocab size.
            b, t = q_terms.shape
            if b * t <= bm25_arrays.vocab_size // 2:
                scores = bm25_scores_dense_gather(bm25_arrays, q_terms)
            else:
                scores = bm25_scores_dense(bm25_arrays, q_terms)
            vals, idx = masked_top_k(
                scores, k, None if bm25_mask is None else bm25_mask[None, :]
            )
        elif isinstance(bm25_arrays, Bm25TwoTier):
            # Dense common tier through K1, rare CSR side window-sliced.
            vals, idx = bm25_top_k_two_tier(
                bm25_arrays, q_terms, k, mask=bm25_mask, budget=budget,
                df_cap=self._tt_rare_cap,
            )
        elif self.use_kernel:
            # Million-doc CSR index: sparse top-k, window fetch when the
            # corpus's df skew allows; on the card the slab kernel where
            # its rule allows, else the sort-based torch route.
            t = q_terms.shape[1]
            df_cap = cap if cap is not None and t * cap <= 4 * budget else None
            if bm25_kernel_route(bm25_arrays, k):
                vals, idx = bm25_sparse_top_k(
                    bm25_arrays, q_terms, k, mask=bm25_mask, budget=budget,
                    df_cap=df_cap,
                )
            else:
                count_launch(bm25_sparse_top_k, "torch_route")
                vals, idx = bm25_top_k_sparse(
                    bm25_arrays, q_terms, k, mask=bm25_mask, budget=budget,
                    df_cap=df_cap,
                )
        elif cap is not None and q_terms.shape[1] * cap <= 4 * budget:
            # CSR-only index on the torch route: the same lossless
            # window-fetch sparse top-k.
            vals, idx = bm25_top_k_sparse(
                bm25_arrays, q_terms, k, mask=bm25_mask, budget=budget,
                df_cap=cap,
            )
        else:
            scores = bm25_scores(bm25_arrays, q_terms, budget)
            vals, idx = masked_top_k(
                scores, k, None if bm25_mask is None else bm25_mask[None, :]
            )
        return _finite_ids(vals, idx)

    def _weights_device(self, weights: Dict[str, float]) -> torch.Tensor:
        """The small weights vector, cached on the device per value."""
        key = tuple(
            [weights.get(m, 1.0) for m in self.model_names]
            + ([weights.get("BM25", 1.0)] if self.use_bm25 else [])
        )
        with self._cache_lock:
            if key not in self._const_cache:
                self._const_cache[key] = torch.tensor(
                    key, dtype=torch.float32, device=self.device
                )
            return self._const_cache[key]

    def _as_device(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _bm25_mask(self, mask, filename_type_filter):
        """The filter mask & the index's BM25 doc mask, cached per filter
        and index version (None when all-true)."""
        idx = self.index
        version = getattr(idx, "_version", 0)
        key = ("bm25_mask", filename_type_filter or None, version)
        with self._cache_lock:
            if key not in self._const_cache:
                # Evict masks of older index versions so repeated
                # tombstone mutations cannot leak device tensors.
                for stale in [
                    c for c in self._const_cache
                    if c[0] == "bm25_mask" and c[-1] != version
                ]:
                    del self._const_cache[stale]
                doc_mask = idx.bm25_doc_mask_or_none()
                if doc_mask is None:
                    bm = mask
                elif mask is None:
                    bm = self._as_device(doc_mask)
                else:
                    bm = mask & self._as_device(doc_mask)
                self._const_cache[key] = bm
            return self._const_cache[key]

    def retrieve_device(
        self,
        q_embs: Dict[str, torch.Tensor],
        q_terms,
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ):
        """Device-to-device path: inputs and outputs stay on the index's
        device (no host sync). Returns (fused ids, fused scores, per-list
        ids) as tensors."""
        with span("retriever"):
            idx = self.index
            dense_mats = tuple(idx.dense_matrix(m) for m in self.model_names)
            with span("retriever.upload"):
                q_tuple = tuple(self._as_device(q_embs[m])
                                for m in self.model_names)
                terms = (self._as_device(q_terms, torch.int32)
                         if self.use_bm25 else None)
            # None when all-true: the kernels then run without a mask
            # operand.
            mask = idx.filter_mask_or_none(filename_type_filter)
            if self.use_bm25:
                bm25_mask = self._bm25_mask(mask, filename_type_filter)
                if self._two_tier is not None:
                    bm25_arrays = self._two_tier
                elif idx.bm25_dense is not None:
                    bm25_arrays = idx.bm25_dense
                else:
                    bm25_arrays = idx.bm25
            else:
                bm25_mask = mask
                bm25_arrays = idx.bm25
            return self.run(
                dense_mats, bm25_arrays, q_tuple, terms, mask, bm25_mask,
                self._weights_device(weights), float(wrrf_k),
            )

    def __call__(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms: Optional[np.ndarray],
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (fused ids [B, n], fused scores [B, n], per-list ids)
        as host arrays."""
        fids, fvals, all_idx = self.retrieve_device(
            q_embs, q_terms, weights, filename_type_filter, wrrf_k
        )
        return fids.cpu().numpy(), fvals.cpu().numpy(), all_idx.cpu().numpy()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class SearchEngine:
    """Reference-parity search API over one :class:`ArrayIndex`, on the
    index's device."""

    def __init__(
        self,
        index: ArrayIndex,
        embedder=None,
        reranker: Optional[Reranker] = None,
    ):
        self.index = index
        self.embedder = embedder
        self.reranker = reranker
        self._doc_mask: Optional[Tuple[np.ndarray, torch.Tensor]] = None

    def _queries(self, x) -> torch.Tensor:
        """[B, D] float32 queries on the index's device (numpy arrays or
        tensors)."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float32)
        q = torch.as_tensor(x, dtype=torch.float32, device=self.index.device)
        return q.reshape(1, -1) if q.ndim < 2 else q

    def _bm25_mask(self, filename_type_filter: Optional[str]):
        """The filter mask & the index's BM25 doc mask (docs with at least
        one token), the latter copied to the device once."""
        mask = self.index.filter_mask(filename_type_filter)
        doc_mask = self.index.bm25_doc_mask
        if doc_mask is None:
            return mask
        if self._doc_mask is None or self._doc_mask[0] is not doc_mask:
            self._doc_mask = (doc_mask, torch.as_tensor(
                doc_mask, device=self.index.device))
        return mask & self._doc_mask[1]

    # ------------------------------------------------------------------
    # Dense search
    # ------------------------------------------------------------------

    def similarity_search_batch(
        self,
        query_embeddings: np.ndarray,
        model_name: str = "voyage-3-large",
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched dense search: (scores [B, k], doc rows [B, k], -1 pad)."""
        emb = self.index.dense_matrix(model_name)
        mask = self.index.filter_mask(filename_type_filter)
        q = self._queries(query_embeddings)
        k = min(similarity_k, self.index.n_docs)
        if isinstance(emb, QuantizedDense):
            vals, idx = _dense_list_q(emb, q, mask, k)
        else:
            vals, idx = _dense_list(emb, q, mask, k)
        return _host(vals), _host(idx)

    def similarity_search_with_embedding(
        self,
        query_embedding: np.ndarray,
        model_name: str = "voyage-3-large",
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
    ) -> List[Dict]:
        """Single-query parity wrapper returning doc dicts with scores
        (reference src/search_engine.py:57-98)."""
        vals, idx = self.similarity_search_batch(
            query_embedding, model_name, similarity_k, filename_type_filter
        )
        return self._rows_to_docs(idx[0], vals[0])

    def similarity_search(
        self,
        query_text: str,
        model_name: str = "voyage-3-large",
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
        query_embedding: Optional[np.ndarray] = None,
    ) -> List[Dict]:
        """Dense search embedding the query text if needed
        (reference src/search_engine.py:100-146)."""
        if query_embedding is None:
            if self.embedder is None:
                raise ValueError("No embedder configured for text queries")
            query_embedding = self.embedder.embed_queries([query_text])[0]
        return self.similarity_search_with_embedding(
            query_embedding, model_name, similarity_k, filename_type_filter
        )

    # ------------------------------------------------------------------
    # BM25 search
    # ------------------------------------------------------------------

    def bm25_search_preprocessed_batch(
        self,
        query_token_lists: Sequence[Sequence[str]],
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
        t_max: int = 32,
        budget: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched BM25: (scores [B, k], doc rows [B, k], -1 pad)."""
        idx_ = self.index
        if idx_.bm25 is None:
            raise ValueError("Index has no BM25 component")
        terms = torch.as_tensor(idx_.pad_term_ids(query_token_lists, t_max),
                                device=idx_.device)
        mask = self._bm25_mask(filename_type_filter)
        k = min(similarity_k, idx_.n_docs)
        if idx_.bm25_dense is not None:
            vals, idx = _bm25_list_dense(idx_.bm25_dense, terms, mask, k)
        else:
            vals, idx = _bm25_list(idx_.bm25, terms, mask, k,
                                   budget or Config.bm25_postings_budget)
        return _host(vals), _host(idx)

    def bm25_search_preprocessed(
        self,
        query_tokens: Sequence[str],
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
    ) -> List[str]:
        """Single-query parity wrapper returning ranked section ids
        (reference src/search_engine.py:271-293)."""
        if not query_tokens:
            return []
        vals, idx = self.bm25_search_preprocessed_batch(
            [query_tokens], similarity_k, filename_type_filter
        )
        return [self.index.meta.ids[i] for i in idx[0] if i >= 0]

    def bm25_search(
        self,
        query_text: str,
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
        use_lemmatized: bool = True,
    ) -> List[str]:
        """BM25 with query preprocessing (reference
        src/search_engine.py:245-269)."""
        tokens = preprocess_text(query_text, use_lemmatization=use_lemmatized)
        return self.bm25_search_preprocessed(
            tokens, similarity_k, filename_type_filter
        )

    # ------------------------------------------------------------------
    # Fusion + rerank
    # ------------------------------------------------------------------

    def weighted_reciprocal_rank_fusion(
        self,
        ranked_lists: List[Tuple[List[str], str]],
        model_weights: Dict[str, float],
        k: int = 50,
    ) -> List[Tuple[str, float]]:
        """Host-side WRRF over section-id lists (API parity with
        src/search_engine.py:21-34; ``retrieve`` fuses with ops.fusion)."""
        scores: Dict[str, float] = {}
        for ranked_list, model_name in ranked_lists:
            weight = model_weights.get(model_name, 1.0)
            for rank, doc_id in enumerate(ranked_list, start=1):
                scores[doc_id] = scores.get(doc_id, 0.0) + weight / (k + rank)
        return sorted(scores.items(), key=lambda x: x[1], reverse=True)

    def rerank_documents(
        self,
        query_text: str,
        documents: List[Dict],
        reranker_model: str = "rerank-2",
        reranker_top_k: Optional[int] = None,
    ) -> List[Dict]:
        return apply_rerank(
            self.reranker, query_text, documents, reranker_model,
            reranker_top_k
        )

    # ------------------------------------------------------------------
    # Full pipeline (retrieve_documents semantics)
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
        """Batched equivalent of the reference's ``retrieve_documents``
        (src/query_rag_retrieval.py:149-407). Returns, per query, a
        ranked list of section ids (or doc dicts with ``return_docs``).

        ``min_similarity`` drops dense candidates whose cosine score
        falls below the threshold before fusion.
        """
        if model_weights is None:
            model_weights = Config.DEFAULT_MODEL_WEIGHTS.copy()
        if not query_embeddings:
            raise ValueError("Query embeddings dictionary cannot be empty")
        if similarity_k <= 0 or common_sections_n <= 0:
            raise ValueError(
                "similarity_k and common_sections_n must be positive integers"
            )

        batch = next(iter(query_embeddings.values()))
        shape = tuple(getattr(batch, "shape", np.shape(batch)))
        b = shape[0] if len(shape) > 1 else 1

        active = [
            m
            for m in MODEL_ORDER
            if m in self.index.dense_model_names
            and model_weights.get(m, 0) > 0
            and m in query_embeddings
        ]

        ranked: List[Tuple[np.ndarray, str, Optional[np.ndarray]]] = []
        for m in active:
            vals, idx = self.similarity_search_batch(
                query_embeddings[m], m, similarity_k, filename_type_filter
            )
            if min_similarity is not None:
                idx = np.where(vals >= min_similarity, idx, -1)
            ranked.append((idx, m, vals))

        use_bm25 = (
            use_hybrid_search
            and self.index.bm25 is not None
            and model_weights.get("BM25", 0) > 0
        )
        if use_bm25:
            if query_token_lists is None and query_texts is not None:
                query_token_lists = [
                    preprocess_text(t, use_lemmatization=True)
                    for t in query_texts
                ]
            if query_token_lists is not None:
                _, bidx = self.bm25_search_preprocessed_batch(
                    query_token_lists, similarity_k, filename_type_filter
                )
                ranked.append((bidx, "BM25", None))
            else:
                logger.warning(
                    "BM25 search requested but no query_text or "
                    "query_tokens provided - skipping BM25"
                )

        if not ranked:
            return [[] for _ in range(b)]

        if len(ranked) > 1:
            dev = self.index.device
            all_idx = torch.as_tensor(np.stack([r[0] for r in ranked]),
                                      device=dev)
            w = torch.tensor(
                [model_weights.get(r[1], 1.0) for r in ranked],
                dtype=torch.float32, device=dev,
            )
            fvals, fids = wrrf_top_n(
                all_idx, w, min(common_sections_n, self.index.n_docs),
                self.index.n_docs_padded, float(wrrf_k),
            )
            fused_ids = _host(_finite_ids(fvals, fids))
        else:
            fused_ids = ranked[0][0][:, :common_sections_n]

        # Host-side doc assembly: similarity comes from the first ranker
        # that surfaced the doc (reference first-stage-wins dedup,
        # src/query_rag_retrieval.py:242-248).
        out: List[List] = []
        for qi in range(b):
            sim_by_row: Dict[int, float] = {}
            for idx_arr, name, vals_arr in ranked:
                for j, row in enumerate(idx_arr[qi]):
                    row = int(row)
                    if row >= 0 and row not in sim_by_row:
                        sim_by_row[row] = (
                            float(vals_arr[qi][j]) if vals_arr is not None
                            else 0.0
                        )
            docs = []
            for row in fused_ids[qi]:
                row = int(row)
                if row < 0:
                    continue
                d = self.index.meta.doc(row)
                d["similarity"] = sim_by_row.get(row, 0.0)
                docs.append(d)
            docs = docs[:common_sections_n]

            if use_reranker and len(docs) > 1 and query_texts is not None:
                docs = self.rerank_documents(
                    query_texts[qi], docs, reranker_model, reranker_top_k
                )
            out.append(docs if return_docs else [d["id"] for d in docs])
        return out

    # ------------------------------------------------------------------

    def _rows_to_docs(self, rows: np.ndarray,
                      scores: np.ndarray) -> List[Dict]:
        docs = []
        for row, s in zip(rows, scores):
            if int(row) < 0:
                continue
            d = self.index.meta.doc(int(row))
            d["similarity"] = float(s)
            docs.append(d)
        return docs
