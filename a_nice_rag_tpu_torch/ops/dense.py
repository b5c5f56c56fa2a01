"""Dense (cosine) retrieval scoring.

Embeddings are unit-normalized at index build time, so the dot product
is the cosine similarity. Scores are always formed in float32: a
``torch.matmul`` of bf16 operands returns bf16 scores, whose rounding
reorders near-equal documents, so both operands are upcast first (the
JAX package's ``preferred_element_type=float32``). On CUDA this needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (the default) for
IEEE float32 products.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.topk import masked_top_k

# Above this document count the streaming kernel pays off on CUDA.
_KERNEL_THRESHOLD = 1 << 18


def dense_scores(
    emb: torch.Tensor,
    queries: torch.Tensor,
    score_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Similarity scores [B, N] = queries [B, D] @ emb [N, D]^T."""
    return queries.to(score_dtype) @ emb.to(score_dtype).T


def dense_top_k(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense scoring + masked top-k over the materialized [B, N] scores.

    mask: optional [N] bool (True = candidate). Returns (values [B, k],
    int32 indices [B, k]) under the tie rule of :mod:`.topk`.
    """
    scores = dense_scores(emb, queries, score_dtype)
    return masked_top_k(scores, k, None if mask is None else mask[None, :])


def dense_top_k_auto(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backend-routing wrapper: the streaming CUDA kernel
    (``ops.kernels.fused_dense_top_k``) on a CUDA device for large
    corpora, the materializing torch path otherwise.

    ``backend``: "auto" | "kernel" | "torch".
    """
    if backend not in ("auto", "kernel", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    use_kernel = backend == "kernel" or (
        backend == "auto"
        and emb.device.type == "cuda"
        and emb.shape[0] >= _KERNEL_THRESHOLD
        and k <= 128
    )
    if use_kernel:
        from a_nice_rag_tpu_torch.ops.kernels import fused_dense_top_k

        return fused_dense_top_k(emb, queries, k, mask=mask)
    return dense_top_k(emb, queries, k, mask=mask)
