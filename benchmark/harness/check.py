"""The comparison that decides ``correct``.

Once the window has closed, a sample of the replies served in it, drawn
from the seed, is judged with the batches that served them:

* ``missing``: requests of the window that got no reply (an error or
  none within the wait): any is a fault.
* ``route_err``: sampled replies that differ from their rows of the
  batch that served them (the scheduler's padding, bucketing and
  routing), or whose batch cannot be found: exact, limit 0.
* ``fusion_err``: sampled rows whose fused ids and scores differ from the
  reference's WRRF over the same batch's lists: exact, limit 0.
* ``dense_gap``: the widest gap by which a dense list's entry at rank j
  scores below the reference's j-th best (exact scores; a repeated,
  missing or foreign id reads +inf).
* ``bm25_gap``: the same for the BM25 list, as a share of the row's best
  BM25 score.
* ``bm25_gap_f32``: the same BM25 gap in float32 roundings of the row's
  fetched total, 2^-24 times the sum of every impact the row's terms
  fetch (a repeated term fetched again): the largest running total that
  a float32 sum over the row's postings holds.

``control`` computes the same gaps for the control's lists (the
reference one precision lower) on the same rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import reference as ref

# The unit roundoff of float32.
F32_UNIT = 2.0 ** -24

# Slack on the host clock when matching a reply to the batch that served
# it: the batch returned between the request's submit and its reply.
MATCH_SLACK_S = 1e-3


@dataclasses.dataclass
class Sampled:
    """The rows judged: inputs, and what the system gave for them."""

    queries: np.ndarray        # [R, D] f32
    terms: Optional[np.ndarray]  # [R, T] int32
    lists: np.ndarray          # [L, R, k] int32, the batch's lists
    fids: np.ndarray           # [R, n] int32, the batch's fused ids
    fvals: np.ndarray          # [R, n] f32


def sample_requests(requests, rows_per_request: int, check_rows: int,
                    seed: int) -> List[int]:
    """Positions in ``requests`` of the replies to judge, from the seed."""
    ok = [i for i, r in enumerate(requests)
          if not isinstance(r.reply, BaseException)]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    pick = rng.permutation(len(ok))[:max(1, check_rows // rows_per_request)]
    return sorted(ok[int(p)] for p in pick)


def _match(served, req, done: np.ndarray) -> Optional[tuple]:
    """(batch, first row) of the batch that served ``req``; ``done`` holds
    each recorded batch's return time."""
    rows = served.request_rows(req.index)
    q = served.queries[rows]
    near = np.flatnonzero((done >= req.start - MATCH_SLACK_S)
                          & (done <= req.end + MATCH_SLACK_S))
    for j in near:
        b = served.recorder.batches[j]
        hits = np.flatnonzero(b.queries[:, 0] == q[0, 0])
        for i0 in hits:
            block = b.queries[i0:i0 + q.shape[0]]
            if block.shape == q.shape and np.array_equal(block, q):
                return b, int(i0)
    return None


def judge(served, requests, picks: List[int]):
    """(numbers, Sampled) for the picked replies; ``route_err`` counted
    here, the other numbers by :func:`list_numbers`."""
    missing = sum(isinstance(r.reply, BaseException) for r in requests)
    route_err = 0
    parts = []
    done = np.array([b.done for b in served.recorder.batches])
    for p in picks:
        req = requests[p]
        hit = _match(served, req, done)
        if hit is None:
            route_err += 1
            continue
        b, i0 = hit
        m = served.rows
        fids = b.fids[i0:i0 + m].cpu().numpy()
        fvals = b.fvals[i0:i0 + m].cpu().numpy()
        ids, vals = req.reply
        ids = np.asarray(ids).reshape(m, -1)
        vals = np.asarray(vals).reshape(m, -1)
        if not (np.array_equal(ids, fids) and np.array_equal(
                vals.view(np.int32), fvals.view(np.int32))):
            route_err += 1
        parts.append((b.queries[i0:i0 + m],
                      None if b.terms is None else b.terms[i0:i0 + m],
                      b.lists[:, i0:i0 + m].cpu().numpy(), fids, fvals))
    if not parts:
        return {"missing": missing, "route_err": route_err}, None
    cat = [np.concatenate([pt[j] for pt in parts], axis=1 if j == 2 else 0)
           if parts[0][j] is not None else None for j in range(5)]
    return ({"missing": missing, "route_err": route_err},
            Sampled(queries=cat[0], terms=cat[1], lists=cat[2], fids=cat[3],
                    fvals=cat[4]))


def list_numbers(cfg: dict, s: Sampled, data: dict, control: bool = False
                 ) -> Dict[str, float]:
    """``fusion_err``, ``dense_gap`` and (with BM25) ``bm25_gap`` and
    ``bm25_gap_f32`` of the sampled rows; ``control``: the gaps of the
    control's lists instead."""
    k = cfg["retriever"]["similarity_k"]
    dev = data["device"]
    q = torch.as_tensor(s.queries, device=dev)
    if "int8_shards" in data:
        dense = ref.ShardedDenseReference(q, data["int8_shards"])
    else:
        dense = ref.DenseReference(q, bf16_rows=data.get("bf16"),
                                   int8_rows=data.get("int8"))
    out: Dict[str, float] = {}
    if not control:
        weights = [cfg["weights"][cfg["model"]]]
        if "bm25" in cfg:
            weights.append(cfg["weights"]["BM25"])
        f_ids, f_vals = ref.wrrf(s.lists, weights, cfg["wrrf_k"],
                                 cfg["retriever"]["common_sections_n"])
        bad = ~((f_ids == s.fids).all(1)
                & (f_vals.view(np.int32) == s.fvals.view(np.int32)).all(1))
        out["fusion_err"] = float(bad.sum())
        d_ids = torch.as_tensor(s.lists[0], device=dev)
    else:
        d_ids = dense.control_ids(q, k)
    best = dense.best(k)
    out["dense_gap"] = float(ref.list_gap(best, dense.scores_of(d_ids),
                                          d_ids).max())
    if "bm25" in cfg:
        bm = ref.Bm25Reference(data["terms"], cfg["bm25"])
        ctl = ref.Bm25Reference(data["terms"], cfg["bm25"],
                                impact_dtype=torch.bfloat16) if control \
            else None
        shares, roundings = [], []
        for r in range(s.queries.shape[0]):
            terms = [int(t) for t in s.terms[r] if t >= 0]
            ids = (ctl.top_ids(terms, k) if control
                   else torch.as_tensor(s.lists[1, r], device=dev))
            best_r, got = bm.best_and_of(terms, ids, k)
            gap = float(ref.list_gap(best_r[None], got[None], ids[None])[0])
            best0 = float(best_r[0])
            shares.append(_ratio(gap, best0 if math.isfinite(best0) else 1.0))
            roundings.append(_ratio(gap, F32_UNIT * bm.fetched_total(terms)))
        out["bm25_gap"] = max(shares)
        out["bm25_gap_f32"] = max(roundings)
    return out


def _ratio(gap: float, unit: float) -> float:
    """``gap`` in units of ``unit``; no gap reads 0 whatever the unit."""
    return 0.0 if gap == 0 else gap / max(unit, 1e-300)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(v) and v <= limits[name]
               for name, v in numbers.items())
