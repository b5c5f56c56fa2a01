"""Weighted reciprocal-rank fusion (WRRF) on rank arrays.

For each ranked list m with weight w_m,

    fused[doc] += w_m * 1 / (k + rank)      (rank 1-based)

as a scatter-add over the padded document axis. Documents in no list
keep score -inf and never enter the fused top-n. Ties between equal
fused scores go to the lower document id.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.topk import masked_top_k, stable_top_k

_BIG_ID = 2**31 - 1


def _contributions(indices: torch.Tensor, weights: torch.Tensor,
                   k_rrf) -> torch.Tensor:
    """[L, B, K] per-slot contributions, 0 where the slot is padding."""
    l, b, k = indices.shape
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=indices.device)
    contrib = weights[:, None] / (k_rrf + ranks)[None, :]  # [L, K]
    contrib = contrib[:, None, :].expand(l, b, k)
    return torch.where(indices >= 0, contrib, 0.0)


def wrrf_scores(
    indices: torch.Tensor,
    weights: torch.Tensor,
    n_docs_padded: int,
    k_rrf=40.0,
) -> torch.Tensor:
    """Fused WRRF scores [B, N_pad].

    indices: [L, B, K] document ids per ranked list (-1 = padding).
    weights: [L] per-list weights. Documents absent from every list get
    0 (mask them out with :func:`wrrf_top_n`).
    """
    l, b, k = indices.shape
    contrib = _contributions(indices, weights, k_rrf)
    ids = torch.where(indices >= 0, indices, n_docs_padded).long()
    s = torch.zeros((b, n_docs_padded + 1), dtype=torch.float32,
                    device=indices.device)
    s.scatter_add_(
        1,
        ids.permute(1, 0, 2).reshape(b, l * k),
        contrib.permute(1, 0, 2).reshape(b, l * k),
    )
    return s[:, :n_docs_padded]


def wrrf_top_n_sparse(
    indices: torch.Tensor,
    weights: torch.Tensor,
    n: int,
    k_rrf=40.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WRRF fusion + top-n without an N-sized accumulator.

    Same math as :func:`wrrf_top_n` at O(L*K log L*K) per query: sort the
    (doc id, contribution) pairs by id, total equal ids and take the
    top-n totals. Returns (scores [B, n], ids [B, n]), -inf/-1 where
    absent.
    """
    l, b, k = indices.shape
    contrib = _contributions(indices, weights, k_rrf)
    ids = torch.where(indices >= 0, indices, _BIG_ID)
    flat_ids = ids.permute(1, 0, 2).reshape(b, l * k)
    flat_c = contrib.permute(1, 0, 2).reshape(b, l * k)
    s_ids, order = torch.sort(flat_ids, dim=-1, stable=True)
    s_c = torch.gather(flat_c, 1, order)
    first = torch.cat(
        [torch.ones_like(s_ids[:, :1], dtype=torch.bool),
         s_ids[:, 1:] != s_ids[:, :-1]], dim=1,
    )
    seg = torch.cumsum(first, dim=1) - 1
    totals = torch.zeros_like(s_c).scatter_add_(1, seg, s_c)
    score = torch.where(
        first & (s_ids != _BIG_ID), torch.gather(totals, 1, seg),
        float("-inf"),
    )
    top_s, pos = stable_top_k(score, n)
    top_ids = torch.where(
        torch.isfinite(top_s), torch.gather(s_ids, 1, pos), -1
    )
    return top_s, top_ids.to(torch.int32)


def wrrf_top_n(
    indices: torch.Tensor,
    weights: torch.Tensor,
    n: int,
    n_docs_padded: int,
    k_rrf=40.0,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WRRF fusion + top-n. Returns (scores [B, n], doc ids [B, n]);
    documents in no list score -inf and report id -1."""
    scores = wrrf_scores(indices, weights, n_docs_padded, k_rrf)
    live = scores > 0.0
    if mask is not None:
        live = live & mask[None, :]
    return masked_top_k(torch.where(live, scores, float("-inf")), n)
