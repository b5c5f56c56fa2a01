"""BM25 Okapi scoring over precomputed-impact postings.

Counterpart of ``a_nice_rag_tpu/ops/bm25.py``. Because (k1, b, dl, avgdl,
idf) are fixed at index-build time, the full per-(term, doc) impact
``idf*tf*(k1+1)/(tf+K_d)`` is precomputed into CSR postings; query
scoring is a gather of at most ``budget`` impacts plus one scatter-add
over the document axis, batched over queries with no per-term loop.
Repeated query terms count once per occurrence, as rank_bm25 does;
term id -1 (padding/OOV) contributes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.ops.topk import masked_top_k, stable_top_k

_SENTINEL_DOC = 2**31 - 1


@dataclasses.dataclass
class Bm25Arrays:
    """CSR postings with precomputed impact scores.

    indptr:  [V + 1] int32 — postings offsets per term id.
    doc_ids: [nnz + 1] int32 — document row per posting; the final
             sentinel slot points at the dump row ``n_docs_padded``.
    impact:  [nnz + 1] float32 — BM25 impact per posting; sentinel 0.
    n_docs_padded: padded document-axis length (scatter target).

    Every index constructor of the package writes each term's postings
    strictly ascending by document id (each document once a term). The
    card's sparse top-k kernel (``ops.kernels.bm25_sparse``) needs that;
    it checks it once per object (``postings_ascend``, cached in
    ``_postings_ascend``) and leaves arrays that break it to the torch
    route.
    """

    indptr: torch.Tensor
    doc_ids: torch.Tensor
    impact: torch.Tensor
    n_docs_padded: int
    _postings_ascend: Optional[bool] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def nnz(self) -> int:
        return self.doc_ids.shape[0] - 1

    @property
    def vocab_size(self) -> int:
        return self.indptr.shape[0] - 1


def _term_ranges(indptr: torch.Tensor, q_terms: torch.Tensor):
    """(starts, dfs) [B, T] of each query term's postings; 0-length for
    padding/OOV terms."""
    valid = q_terms >= 0
    t = torch.where(valid, q_terms, 0).long()
    starts = indptr[t].long()
    dfs = torch.where(valid, indptr[t + 1].long() - starts, 0)
    return starts, dfs


def _flat_postings_indices(
    indptr: torch.Tensor,
    q_terms: torch.Tensor,
    budget: int,
    sentinel: int,
) -> torch.Tensor:
    """[B, budget] indices into the flat postings arrays: each query's
    terms' postings ranges concatenated, padded with ``sentinel`` (the
    zero-impact dump slot)."""
    starts, dfs = _term_ranges(indptr, q_terms)
    cum = torch.cumsum(dfs, dim=-1)
    total = cum[:, -1:]
    p = torch.arange(budget, device=q_terms.device).expand(q_terms.shape[0], -1)
    seg = torch.searchsorted(cum, p.contiguous(), right=True)
    seg = torch.clamp(seg, 0, q_terms.shape[1] - 1)
    prev = torch.where(
        seg > 0, torch.gather(cum, 1, torch.clamp(seg - 1, min=0)), 0
    )
    g = torch.gather(starts, 1, seg) + (p - prev)
    return torch.where(p < total, g, sentinel)


def bm25_scores(
    bm25: Bm25Arrays,
    q_terms: torch.Tensor,
    budget: int = 16384,
) -> torch.Tensor:
    """BM25 scores [B, N_pad] for a batch of term-id queries [B, T].

    ``budget`` is the per-query flattened-postings budget; postings past
    it are dropped (see :func:`postings_required`).
    """
    g = _flat_postings_indices(bm25.indptr, q_terms, budget, bm25.nnz)
    ids = bm25.doc_ids[g].long()
    vals = bm25.impact[g]
    scores = torch.zeros(
        (q_terms.shape[0], bm25.n_docs_padded + 1),
        dtype=vals.dtype, device=vals.device,
    )
    scores.scatter_add_(1, ids, vals)
    return scores[:, : bm25.n_docs_padded]


def bm25_top_k(
    bm25: Bm25Arrays,
    q_terms: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    budget: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BM25 scoring + masked top-k. Returns ([B, k], [B, k])."""
    scores = bm25_scores(bm25, q_terms, budget)
    return masked_top_k(scores, k, None if mask is None else mask[None, :])


@dataclasses.dataclass
class Bm25DenseArrays:
    """Dense impact matrix: impact[v, d] = BM25 contribution of term v in
    document d (0 where absent)."""

    impact: torch.Tensor  # [V, N_pad]

    @property
    def vocab_size(self) -> int:
        return self.impact.shape[0]

    @property
    def n_docs_padded(self) -> int:
        return self.impact.shape[1]


def _term_counts(q_terms: torch.Tensor, cols: torch.Tensor, width: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """[B, width + 1] count matrix: +1 at (b, cols[b, t]); column
    ``width`` is the dump column for padding."""
    b, t = q_terms.shape
    rows = torch.arange(b, device=q_terms.device)[:, None].expand(b, t)
    q_tf = torch.zeros((b, width + 1), dtype=dtype, device=q_terms.device)
    q_tf.index_put_(
        (rows.reshape(-1), cols.reshape(-1).long()),
        torch.ones(b * t, dtype=dtype, device=q_terms.device),
        accumulate=True,
    )
    return q_tf


def bm25_scores_dense(
    bm25: Bm25DenseArrays, q_terms: torch.Tensor
) -> torch.Tensor:
    """BM25 scores [B, N_pad] as term counts [B, V] @ impact [V, N_pad]
    in float32. Duplicate terms accumulate counts."""
    v = bm25.vocab_size
    cols = torch.where(q_terms >= 0, q_terms, v)
    q_tf = _term_counts(q_terms, cols, v, bm25.impact.dtype)
    return q_tf[:, :v].to(torch.float32) @ bm25.impact.to(torch.float32)


def bm25_scores_dense_gather(
    bm25: Bm25DenseArrays, q_terms: torch.Tensor
) -> torch.Tensor:
    """BM25 scores [B, N_pad] from the B*T query-term impact rows only
    (small-batch path); equal to :func:`bm25_scores_dense` up to f32
    summation order."""
    b, t = q_terms.shape
    safe = torch.where(q_terms >= 0, q_terms, 0).long()
    rows = bm25.impact[safe.reshape(-1)].reshape(b, t, -1)
    w = (q_terms >= 0).to(bm25.impact.dtype)[:, :, None]
    return (rows * w).sum(dim=1).to(torch.float32)


def bm25_top_k_sparse(
    bm25: Bm25Arrays,
    q_terms: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    budget: int = 16384,
    df_cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BM25 top-k without an N-sized score vector or a scatter.

    Gathers each query's (doc id, impact) postings, sorts them by doc id,
    totals duplicates and takes top-k over the per-document totals:
    O(P log P) per query, independent of N. ``df_cap`` switches the
    fetch to per-term windows and MUST be >= every queried term's df
    (:func:`max_df`), or longer posting lists are truncated. Only docs
    with a matching posting can appear. Returns (scores [B, k], doc ids
    [B, k]), -inf/-1 padded.
    """
    if df_cap is not None:
        s_ids, score = _rare_candidates_sliced(bm25, q_terms, df_cap, mask)
    else:
        s_ids, score = _rare_candidates(bm25, q_terms, budget, mask)
    kk = min(k, score.shape[1])
    top_s, pos = stable_top_k(score, kk)
    top_ids = torch.where(
        torch.isfinite(top_s), torch.gather(s_ids, 1, pos), -1
    )
    b = q_terms.shape[0]
    if kk < k:
        top_s = torch.cat(
            [top_s, torch.full((b, k - kk), float("-inf"),
                               device=top_s.device)], dim=1)
        top_ids = torch.cat(
            [top_ids, torch.full((b, k - kk), -1, dtype=top_ids.dtype,
                                 device=top_ids.device)], dim=1)
    return top_s, top_ids.to(torch.int32)


def _rare_candidates(
    bm25: Bm25Arrays,
    q_terms: torch.Tensor,
    budget: int,
    mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-document score totals for each query's flat postings fetch:
    (s_ids [B, budget] ascending, sentinel-padded; score [B, budget] with
    each document's total at its LAST occurrence, -inf elsewhere)."""
    g = _flat_postings_indices(bm25.indptr, q_terms, budget, bm25.nnz)
    ids = bm25.doc_ids[g].long()
    vals = bm25.impact[g]
    ids = torch.where(ids >= bm25.n_docs_padded, _SENTINEL_DOC, ids)
    return _segment_totals(ids, vals, mask)


def max_df(bm25: Bm25Arrays) -> int:
    """Largest document frequency over the vocabulary: the df_cap that
    makes the window fetch lossless."""
    diffs = torch.diff(bm25.indptr)
    return int(diffs.max()) if diffs.numel() else 0


def _rare_candidates_sliced(
    bm25: Bm25Arrays,
    q_terms: torch.Tensor,
    df_cap: int,
    mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_rare_candidates` with per-term contiguous windows of width
    ``df_cap`` (>= every queried term's df)."""
    b, t = q_terms.shape
    starts, lens = _term_ranges(bm25.indptr, q_terms)
    dev = q_terms.device
    ids_pad = torch.cat([
        bm25.doc_ids,
        torch.full((df_cap,), bm25.n_docs_padded, dtype=bm25.doc_ids.dtype,
                   device=dev),
    ])
    imp_pad = torch.cat([
        bm25.impact,
        torch.zeros((df_cap,), dtype=bm25.impact.dtype, device=dev),
    ])
    pos = torch.arange(df_cap, device=dev)
    window = starts[:, :, None] + pos  # [B, T, df_cap]
    keep = pos < lens[:, :, None]
    ids = torch.where(keep, ids_pad[window].long(), _SENTINEL_DOC)
    ids = torch.where(ids >= bm25.n_docs_padded, _SENTINEL_DOC, ids)
    vals = torch.where(keep, imp_pad[window], 0.0)
    return _segment_totals(
        ids.reshape(b, t * df_cap), vals.reshape(b, t * df_cap), mask
    )


def _segment_totals(
    ids: torch.Tensor, vals: torch.Tensor, mask: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (id, value) pairs by id and total duplicate ids' values.

    Returns (s_ids [B, P] ascending, score [B, P]) with each id's total at
    its LAST occurrence, -inf elsewhere. Same arithmetic as the JAX
    package: impacts are positive, so the running cumsum is
    nondecreasing and a cummax broadcasts each group's starting prefix
    to its members; the total is the cumsum difference (which cancels
    ~P*eps absolute).
    """
    s_ids, order = torch.sort(ids, dim=-1, stable=True)
    s_vals = torch.gather(vals, 1, order)
    csum = torch.cumsum(s_vals, dim=-1)
    csum_before = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], 1)
    step = s_ids[:, 1:] != s_ids[:, :-1]
    ones = torch.ones_like(step[:, :1])
    first = torch.cat([ones, step], dim=1)
    last = torch.cat([step, ones], dim=1)
    start_prefix = torch.cummax(
        torch.where(first, csum_before, float("-inf")), dim=-1
    ).values
    score = torch.where(
        last & (s_ids != _SENTINEL_DOC), csum - start_prefix, float("-inf")
    )
    if mask is not None:
        keep = mask[torch.clamp(s_ids, 0, mask.shape[0] - 1)]
        score = torch.where(keep, score, float("-inf"))
    return s_ids, score


@dataclasses.dataclass
class Bm25TwoTier:
    """Two-tier postings: the highest-df ("common") terms as dense impact
    columns, the long tail as CSR. Every posting lives in exactly one
    tier and the tiers' scores add, so the split is exact.

    common_impact_t: [N_pad, V_common] dense impact, document-major — the
                     layout of a dense embedding matrix, so the common
                     tier runs through the fused top-k kernel unchanged.
    common_map:      [V + 1] int32 — term id -> common column, -1 for
                     rare/absent (slot V covers padded queries).
    rare:            CSR with the common terms' ranges emptied.
    """

    common_impact_t: torch.Tensor
    common_map: torch.Tensor
    rare: Bm25Arrays

    @property
    def v_common(self) -> int:
        return self.common_impact_t.shape[1]

    @property
    def n_docs_padded(self) -> int:
        return self.rare.n_docs_padded


def split_two_tier(
    bm25: Bm25Arrays, v_common: int = 256, dtype: str = "float32"
) -> Bm25TwoTier:
    """Split CSR postings into dense-common + rare-CSR tiers by df.

    The common terms are chosen on the host with the same numpy calls as
    the JAX package (so ties in df pick the same terms); the tiers are
    built on the postings' device.
    """
    dev = bm25.indptr.device
    indptr_np = bm25.indptr.cpu().numpy()
    v = indptr_np.shape[0] - 1
    n_pad = bm25.n_docs_padded
    df = np.diff(indptr_np)
    v_common = min(v_common, v)
    common_terms = np.sort(np.argsort(df)[::-1][:v_common])

    common_map = np.full(v + 1, -1, dtype=np.int32)
    common_map[common_terms] = np.arange(v_common, dtype=np.int32)
    lens = torch.as_tensor(df[common_terms], dtype=torch.long, device=dev)
    starts = torch.as_tensor(indptr_np[common_terms], dtype=torch.long,
                             device=dev)
    col = torch.repeat_interleave(torch.arange(v_common, device=dev), lens)
    first = torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    post = (torch.repeat_interleave(starts, lens)
            + torch.arange(col.shape[0], device=dev) - first)
    dense = torch.zeros((n_pad, v_common), dtype=torch.float32, device=dev)
    dense[bm25.doc_ids[post].long(), col] = bm25.impact[post]

    # Rare CSR: the common terms' ranges removed.
    nnz = int(indptr_np[-1])
    keep = torch.ones(nnz, dtype=torch.bool, device=dev)
    keep[post] = False
    new_df = df.copy()
    new_df[common_terms] = 0
    new_ptr = np.zeros(v + 1, dtype=np.int32)
    np.cumsum(new_df, out=new_ptr[1:])
    rare = Bm25Arrays(
        indptr=torch.as_tensor(new_ptr, device=dev),
        doc_ids=torch.cat([
            bm25.doc_ids[:nnz][keep],
            torch.tensor([n_pad], dtype=torch.int32, device=dev),
        ]),
        impact=torch.cat([
            bm25.impact[:nnz][keep],
            torch.zeros(1, dtype=torch.float32, device=dev),
        ]),
        n_docs_padded=n_pad,
    )
    return Bm25TwoTier(
        common_impact_t=dense.to(getattr(torch, dtype)),
        common_map=torch.as_tensor(common_map, device=dev),
        rare=rare,
    )


def _two_tier_q_tf(tt: Bm25TwoTier, q_terms: torch.Tensor) -> torch.Tensor:
    """Common-tier term-count matrix [B, V_common] for a term-id batch."""
    safe = torch.where(q_terms >= 0, q_terms, tt.common_map.shape[0] - 1)
    rows = tt.common_map[safe.long()]  # [B, T] common column or -1
    cols = torch.where(rows >= 0, rows, tt.v_common)
    q_tf = _term_counts(q_terms, cols, tt.v_common, tt.common_impact_t.dtype)
    return q_tf[:, : tt.v_common]


def bm25_scores_two_tier(
    tt: Bm25TwoTier, q_terms: torch.Tensor, budget: int = 2048
) -> torch.Tensor:
    """BM25 scores [B, N_pad]: dense-common matmul + rare CSR gather;
    ``budget`` bounds only the rare tier's postings."""
    q_tf = _two_tier_q_tf(tt, q_terms)
    s_common = q_tf.to(torch.float32) @ tt.common_impact_t.to(torch.float32).T
    return s_common + bm25_scores(tt.rare, q_terms, budget)


def bm25_top_k_two_tier(
    tt: Bm25TwoTier,
    q_terms: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    budget: int = 2048,
    df_cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact two-tier BM25 top-k without materializing [B, N] scores.

    The common tier streams through the fused top-k kernel (K1). The rare
    tier enumerates every document with a nonzero rare score, each
    scored with its full common + rare total. A document in the true
    top-k either is a rare candidate or scores its common score alone,
    and then the common top-k covers it. Candidates are deduplicated by
    id, keeping the full total. Returns (scores [B, k], doc ids [B, k]),
    -inf/-1 padded.
    """
    from a_nice_rag_tpu_torch.ops.kernels import fused_dense_top_k

    n_pad = tt.n_docs_padded
    q_tf = _two_tier_q_tf(tt, q_terms)
    c_vals, c_ids = fused_dense_top_k(tt.common_impact_t, q_tf, k, mask=mask)
    c_ids = c_ids.long()

    if df_cap is not None:
        r_ids, r_scores = _rare_candidates_sliced(tt.rare, q_terms, df_cap,
                                                  mask)
    else:
        r_ids, r_scores = _rare_candidates(tt.rare, q_terms, budget, mask)
    # Add the common contribution at the rare candidates' rows.
    safe = torch.clamp(r_ids, 0, n_pad - 1)
    rows = tt.common_impact_t[safe].to(torch.float32)  # [B, P, Vc]
    c_at = torch.einsum("brv,bv->br", rows, q_tf.to(torch.float32))
    r_totals = torch.where(
        torch.isfinite(r_scores), r_scores + c_at, float("-inf")
    )

    # Dedup: a common-top-k doc with rare postings is already a rare
    # candidate with its full total. r_ids is sorted, so membership is a
    # searchsorted probe at the LAST occurrence, where the live total is.
    live = torch.isfinite(r_totals)
    probe = torch.where(c_ids >= 0, c_ids, -1)
    pos = torch.searchsorted(r_ids, probe, right=True) - 1
    pos = torch.clamp(pos, 0, r_ids.shape[1] - 1)
    dup = (torch.gather(r_ids, 1, pos) == probe) & torch.gather(live, 1, pos)
    c_vals = torch.where(dup, float("-inf"), c_vals)

    ids = torch.cat([r_ids, torch.where(c_ids >= 0, c_ids, n_pad)], dim=1)
    vals = torch.cat([r_totals, c_vals], dim=1)
    top_v, top_pos = stable_top_k(vals, k)
    top_i = torch.gather(ids, 1, top_pos)
    return top_v, torch.where(torch.isfinite(top_v), top_i, -1).to(torch.int32)


def postings_required(bm25: Bm25Arrays, q_terms: torch.Tensor) -> torch.Tensor:
    """Total postings each query would touch — for budget validation [B]."""
    return _term_ranges(bm25.indptr, q_terms)[1].sum(dim=-1)
