"""The plain reference: what every list and every fused reply should be.

Plain PyTorch and NumPy over the generated inputs only. It imports
nothing of the port and takes nothing the port made: the int8 query
quantization, the BM25 impacts (from the generated term counts) and the
fusion are worked out here again.

* Dense: exact scores in float64: ``q . row`` for bf16 rows (every
  product of a bf16 and an f32 number is exact in float64); for int8
  rows ``(q_int . row_int) * s_q * s_d``, the query quantized per row
  (scale max|q| / 127, round half to even), the integer dot exact in
  float32 (every partial sum stays below 2^24 at D <= 1040) with TF32
  off.
* BM25: rank_bm25's Okapi numerics in float64 from the postings' term
  counts and the passages' content lengths; a query's repeated term
  counts once per occurrence; only passages with a positive score are
  listed.
* Lists: the k best by score; ties between equal scores are left open
  (a list is judged by the scores of what it holds, so any order of
  equal scores passes).
* WRRF over given lists, as the configuration states it: each listed
  document gets ``w / (wrrf_k + rank)`` (rank from 1) from each list,
  summed in float32, and the top n go by (score desc, id asc); a single
  list is its own top n, with scores 0.
* The control: the same lists computed a precision lower than the
  configuration states (bf16 rows: int8 rows and queries; int8 rows:
  int4; f32 BM25 impacts: bf16).
* A corpus laid out by shard over several devices is scored shard by
  shard on the device that holds it, with global ids, and the shards' k
  best merged: the same lists as over the whole matrix.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# Rows of the corpus scored at a time.
DOC_CHUNK = 1 << 20


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize(x: torch.Tensor, levels: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Per-row symmetric quantization to +-levels: (values as float32
    integers, scales f32)."""
    x = x.to(torch.float32)
    s = x.abs().amax(dim=1) / float(levels)
    v = torch.clamp(torch.round(x / torch.clamp_min(s, 1e-12)[:, None]),
                    -levels, levels)
    return v, s


def _top_values(scores_fn, n: int, rows: int, k: int, device
                ) -> torch.Tensor:
    """[rows, k] float64 k best scores over the corpus, descending."""
    best = torch.full((rows, k), -math.inf, dtype=torch.float64,
                      device=device)
    for d0 in range(0, n, DOC_CHUNK):
        s = scores_fn(d0, min(n, d0 + DOC_CHUNK))
        both = torch.cat([best, s], dim=1)
        best = torch.topk(both, k, dim=1).values
    return best


def _top_ids(scores_fn, n: int, rows: int, k: int, device) -> torch.Tensor:
    """[rows, k] ids of the k best scores (score desc, id asc)."""
    best_v, best_i = _top_pairs(scores_fn, n, rows, k, device)
    return torch.where(torch.isfinite(best_v), best_i, -1)


def _top_pairs(scores_fn, n: int, rows: int, k: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([rows, k] float64 k best scores, their ids), score desc, id asc."""
    best_v = torch.full((rows, k), -math.inf, dtype=torch.float64,
                        device=device)
    best_i = torch.full((rows, k), -1, dtype=torch.int64, device=device)
    for d0 in range(0, n, DOC_CHUNK):
        d1 = min(n, d0 + DOC_CHUNK)
        s = scores_fn(d0, d1)
        ids = torch.arange(d0, d1, device=device).expand(rows, -1)
        best_v, best_i = _keep_best(torch.cat([best_v, s], dim=1),
                                    torch.cat([best_i, ids], dim=1), k)
    return best_v, best_i


def _keep_best(v: torch.Tensor, i: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of (scores, ids) whose positions run in id order."""
    # Stable over id-ordered positions: the lower id first among ties.
    order = torch.sort(v, dim=1, descending=True, stable=True).indices
    return torch.gather(v, 1, order[:, :k]), torch.gather(i, 1, order[:, :k])


class DenseReference:
    """Exact scores of a dense corpus for a block of query rows."""

    def __init__(self, q: torch.Tensor, bf16_rows=None, int8_rows=None):
        _no_tf32()
        self.bf16_rows = bf16_rows
        self.int8_rows = int8_rows
        if bf16_rows is not None:
            self.n = bf16_rows.shape[0]
            self.q = q.to(torch.float64)
        else:
            values, scales = int8_rows
            self.n = values.shape[0]
            qv, qs = quantize(q, 127)
            self.qv, self.qs = qv, qs.to(torch.float64)

    def scores(self, d0: int, d1: int) -> torch.Tensor:
        if self.bf16_rows is not None:
            return self.q @ self.bf16_rows[d0:d1].to(torch.float64).T
        values, scales = self.int8_rows
        acc = self.qv @ values[d0:d1].to(torch.float32).T
        return (acc.to(torch.float64) * scales[d0:d1].to(torch.float64)[None]
                * self.qs[:, None])

    def scores_of(self, ids: torch.Tensor) -> torch.Tensor:
        """[rows, k] exact scores of the given ids (-inf for -1 and ids
        past the corpus)."""
        valid = (ids >= 0) & (ids < self.n)
        safe = torch.where(valid, ids, 0).long()
        if self.bf16_rows is not None:
            rows = self.bf16_rows[safe].to(torch.float64)  # [R, k, D]
            s = torch.einsum("rkd,rd->rk", rows, self.q)
        else:
            values, scales = self.int8_rows
            rows = values[safe].to(torch.float32)
            acc = torch.einsum("rkd,rd->rk", rows, self.qv)
            s = (acc.to(torch.float64) * scales[safe].to(torch.float64)
                 * self.qs[:, None])
        return torch.where(valid, s, -math.inf)

    def best(self, k: int) -> torch.Tensor:
        """[rows, k] the reference's k best scores, descending."""
        q = self.q if self.bf16_rows is not None else self.qv
        return _top_values(self.scores, self.n, q.shape[0], k, q.device)

    def control_ids(self, q: torch.Tensor, k: int) -> torch.Tensor:
        """The control's lists: rows and queries one precision lower
        (bf16 rows: int8; int8 rows: int4), per-row scales."""
        v, i = self.control_pairs(q, k)
        return torch.where(torch.isfinite(v), i, -1)

    def control_pairs(self, q: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The control's k best (scores, ids), score desc, id asc."""
        levels = 127 if self.bf16_rows is not None else 7
        cq, cs = quantize(q, levels)
        cs64 = cs.to(torch.float64)

        def scores(d0, d1):
            if self.bf16_rows is not None:
                x = self.bf16_rows[d0:d1].to(torch.float32)
            else:
                values, scales = self.int8_rows
                x = values[d0:d1].to(torch.float32) * scales[d0:d1][:, None]
            v, s = quantize(x, levels)
            acc = (cq @ v.T).to(torch.float64)
            return acc * s.to(torch.float64)[None] * cs64[:, None]

        return _top_pairs(scores, self.n, q.shape[0], k, q.device)


class ShardedDenseReference:
    """:class:`DenseReference` over int8 rows laid out by shard: shard s
    (``gen.Int8Shard``) holds global rows [offset, offset + n_real) on its
    own device. Each shard's rows are scored on its device, a block at a
    time, and the shards' k best merged on the queries' device."""

    def __init__(self, q: torch.Tensor, shards):
        self.device = q.device
        self.parts = [
            (DenseReference(q.to(sh.device), int8_rows=(
                sh.values[:sh.n_real], sh.scales[:sh.n_real])), sh.offset)
            for sh in shards]

    def best(self, k: int) -> torch.Tensor:
        """[rows, k] the k best scores over every shard, descending."""
        got = [part.best(k).to(self.device) for part, _ in self.parts]
        return torch.topk(torch.cat(got, dim=1), k, dim=1).values

    def scores_of(self, ids: torch.Tensor) -> torch.Tensor:
        """[rows, k] exact scores of the given global ids, each scored on
        the shard that holds it (-inf for -1 and ids no shard holds)."""
        out = torch.full(ids.shape, -math.inf, dtype=torch.float64,
                         device=self.device)
        for part, offset in self.parts:
            local = ids.long() - offset
            mine = (ids >= 0) & (local >= 0) & (local < part.n)
            got = part.scores_of(torch.where(mine, local, -1).to(
                part.int8_rows[0].device)).to(self.device)
            out = torch.where(mine, got, out)
        return out

    def control_ids(self, q: torch.Tensor, k: int) -> torch.Tensor:
        """The control's lists (int4 rows and queries) over every shard,
        merged as the shards' own: score desc, id asc."""
        vals, ids = [], []
        for part, offset in self.parts:
            v, i = part.control_pairs(q.to(part.int8_rows[0].device), k)
            vals.append(v.to(self.device))
            ids.append(torch.where(i >= 0, i + offset, -1).to(self.device))
        # The shards in global order: equal scores stay id-ascending.
        best_v, best_i = _keep_best(torch.cat(vals, dim=1),
                                    torch.cat(ids, dim=1), k)
        return torch.where(torch.isfinite(best_v), best_i, -1)


class Bm25Reference:
    """BM25 scores from the generated term counts (``gen.TermCorpus``)."""

    def __init__(self, tc, bm: dict, impact_dtype=torch.float64):
        self.tc = tc
        self.n = tc.doc_len.shape[0]
        df = torch.diff(tc.indptr)
        n_live = int((tc.doc_len > 0).sum())
        avgdl = float(tc.doc_len.to(torch.float64).sum()) / n_live
        df64 = df.to(torch.float64)
        idf = torch.log(n_live - df64 + 0.5) - torch.log(df64 + 0.5)
        mean_idf = float(idf[df > 0].mean())
        self.idf = torch.where(idf < 0, bm["epsilon"] * mean_idf, idf)
        self.k1, self.b, self.avgdl = bm["k1"], bm["b"], avgdl
        self.impact_dtype = impact_dtype

    def _impacts(self, term: int) -> Tuple[torch.Tensor, torch.Tensor]:
        p0, p1 = int(self.tc.indptr[term]), int(self.tc.indptr[term + 1])
        docs = self.tc.post_doc[p0:p1].long()
        tf = self.tc.post_tf[p0:p1].to(torch.float64)
        dl = self.tc.doc_len[docs].to(torch.float64)
        imp = self.idf[term] * tf * (self.k1 + 1.0) / (
            tf + self.k1 * (1.0 - self.b + self.b * dl / self.avgdl))
        return docs, imp.to(self.impact_dtype).to(torch.float64)

    def scores(self, terms: Sequence[int]) -> torch.Tensor:
        """[n] float64 scores of one query's term ids (-1 ignored)."""
        dev = self.tc.post_doc.device
        s = torch.zeros((self.n,), dtype=torch.float64, device=dev)
        for t in terms:
            if t >= 0:
                docs, imp = self._impacts(int(t))
                s.index_add_(0, docs, imp)
        return s

    def best_and_of(self, terms: Sequence[int], ids: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(k best positive scores, -inf past the matches; the scores of
        ``ids``, -inf for -1) for one query."""
        s = self.scores(terms)
        best = torch.topk(s, k).values
        best = torch.where(best > 0, best, -math.inf)
        valid = (ids >= 0) & (ids < self.n)
        got = s[torch.where(valid, ids, 0).long()]
        got = torch.where(valid & (got > 0), got, -math.inf)
        return best, got

    def fetched_total(self, terms: Sequence[int]) -> float:
        """The sum of every impact one query's term ids fetch (-1 ignored,
        a repeated term fetched again), in float64."""
        return float(sum(float(self._impacts(int(t))[1].sum())
                         for t in terms if t >= 0))

    def top_ids(self, terms: Sequence[int], k: int) -> torch.Tensor:
        s = self.scores(terms)
        order = torch.sort(s, descending=True, stable=True).indices[:k]
        return torch.where(s[order] > 0, order, -1)


def list_gap(best: torch.Tensor, got: torch.Tensor, ids: torch.Tensor,
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[rows] the widest gap by which a list's entry at rank j scores (by
    the reference) below the reference's j-th best, over its ranks:
    ``best`` and ``got`` [rows, k] float64 (-inf where no document is due
    or none is given), ``ids`` [rows, k]. An entry that repeats an id,
    names no document where one is due, or names one where none is due
    reads +inf. ``scale`` [rows] divides the gaps (BM25: the row's best
    score)."""
    due = torch.isfinite(best)
    given = ids >= 0
    srt = torch.sort(ids, dim=1).values
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(dim=1)
    bad = (due != given) | (given & ~torch.isfinite(got))
    gap = torch.where(due & given, best - got, torch.zeros_like(best))
    gap = torch.where(bad, math.inf, gap)
    if scale is not None:
        gap = gap / scale[:, None].clamp_min(1e-300)
    out = gap.max(dim=1).values
    return torch.where(dup, math.inf, out)


def wrrf(lists: np.ndarray, weights: Sequence[float], wrrf_k: float,
         n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fused (ids [rows, n] int32, scores [rows, n] f32) of the lists
    [L, rows, k] (-1 padded)."""
    n_lists, rows, k = lists.shape
    if n_lists == 1:
        return (lists[0, :, :n].astype(np.int32),
                np.zeros((rows, n), np.float32))
    ranks = np.arange(1, k + 1, dtype=np.float32)
    contrib = (np.asarray(weights, np.float32)[:, None]
               / (np.float32(wrrf_k) + ranks)[None, :])
    ids_out = np.full((rows, n), -1, np.int32)
    vals_out = np.full((rows, n), -np.inf, np.float32)
    for r in range(rows):
        tot = {}
        for li in range(n_lists):
            for j in range(k):
                d = int(lists[li, r, j])
                if d >= 0:
                    tot[d] = np.float32(tot.get(d, np.float32(0))
                                        + contrib[li, j])
        top = sorted(tot.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
        for j, (d, v) in enumerate(top):
            ids_out[r, j] = d
            vals_out[r, j] = v
    return ids_out, vals_out
