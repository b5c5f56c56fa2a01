"""Top-k primitives, and the one tie rule of the port.

Tie rule: results are ordered by (score descending, doc id ascending),
and unfilled slots hold ``(-inf, -1)``. ``jax.lax.top_k`` returns the
lower index first among equal values; ``torch.topk`` does not specify
its tie order, so every selection here is a stable descending sort over
id-ordered positions, which gives the lower id first exactly as
``lax.top_k`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")


def stable_top_k(
    scores: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: values descending, the lower
    position first among equal values. Returns (values, int64 positions)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_top_k(
    scores: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, with invalid entries masked to -inf.

    Returns (values, int32 indices), values descending. ``mask``
    broadcasts against ``scores`` (True = keep). Slots whose value is
    -inf report index -1.
    """
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    vals, idx = stable_top_k(scores, k)
    return vals, torch.where(torch.isneginf(vals), -1, idx).to(torch.int32)


def hierarchical_top_k(
    scores: torch.Tensor,
    k: int,
    tile: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k along the last axis for large N: top-min(k, tile)
    per tile, then top-k over the candidates. N must be divisible by
    ``tile``. Same result as :func:`masked_top_k` under the tie rule:
    candidates stay tile-major, so position order is id order."""
    *lead, n = scores.shape
    if n <= tile:
        vals, idx = stable_top_k(scores, k)
        return vals, idx.to(torch.int32)
    if n % tile:
        raise ValueError(f"N={n} must be a multiple of tile={tile}")
    kt = min(k, tile)
    tiles = scores.reshape(*lead, n // tile, tile)
    tvals, tidx = stable_top_k(tiles, kt)
    base = (torch.arange(n // tile, device=scores.device) * tile)[:, None]
    gidx = (tidx + base).reshape(*lead, -1)
    cand = tvals.reshape(*lead, -1)
    vals, ci = stable_top_k(cand, k)
    idx = torch.take_along_dim(gidx, ci, dim=-1)
    return vals, torch.where(torch.isneginf(vals), -1, idx).to(torch.int32)


def merge_top_k(
    values: torch.Tensor,
    indices: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge S per-shard top-k lists ([..., S, k_local], global ids) into
    one global top-k ([..., k]); equal values keep list order."""
    *lead, s, kl = values.shape
    flat_v = values.reshape(*lead, s * kl)
    flat_i = indices.reshape(*lead, s * kl)
    vals, ci = stable_top_k(flat_v, k)
    idx = torch.take_along_dim(flat_i, ci, dim=-1)
    return vals, torch.where(torch.isneginf(vals), -1, idx).to(torch.int32)


def _sort_by(keys: torch.Tensor, *carried: torch.Tensor):
    order = torch.sort(keys, dim=-1, stable=True).indices
    return (torch.take_along_dim(keys, order, dim=-1),) + tuple(
        torch.take_along_dim(c, order, dim=-1) for c in carried
    )


def dedup_ranked(
    values: torch.Tensor, ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate a descending-ranked (values, ids) list per row.

    Keeps the best-scoring slot per id, demotes later duplicates to
    (-inf, -1) and re-compacts, so real entries stay a dense descending
    prefix. -1 ids are never merged with each other. Equal-score ties
    between distinct ids come out in id order.
    """
    big = 2**30
    key_id = torch.where(ids < 0, big, ids)
    # Pass 1: lexicographic (id asc, score desc) as two stable sorts,
    # the minor key first.
    neg, kid = _sort_by(-values, key_id)
    sid, sval = _sort_by(kid, neg)
    first = torch.cat(
        [torch.ones_like(sid[..., :1], dtype=torch.bool),
         sid[..., 1:] != sid[..., :-1]],
        dim=-1,
    ) & (sid < big)
    nval = torch.where(first, -sval, NEG_INF)
    nid = torch.where(first, sid, -1)
    # Pass 2: back to descending-score order, survivors first.
    fval, fid = _sort_by(-nval, nid)
    return -fval, fid
