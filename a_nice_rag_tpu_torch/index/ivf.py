"""IVF (inverted-file) ANN layer over the dense index.

Counterpart of ``a_nice_rag_tpu/index/ivf.py``. Spherical k-means
(ops/kmeans.py) clusters the corpus once at build time, the rows are
permuted cluster-major, and a query batch scores only the tiles covering
its top-``nprobe`` clusters through K3/K4 (``ops.kernels.ivf_topk``).

The tile table is built on the device with plain tensor ops (probe
matmul, top-p, sort-based dedup, -1 padding) and never syncs to the
host: its ``n_unique`` comes back as a device tensor. Layouts (the
cluster-major permutation, spill slots) are computed on the host with
NumPy, as in the JAX package, so both packages build identical layouts
from identical assignments. ``save_ivf``/``load_ivf`` use the JAX
package's npz keys, so each package reads the other's files.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device
from a_nice_rag_tpu_torch.index.io import _host, numpy_to_torch
from a_nice_rag_tpu_torch.ops.kernels import (
    ivf_dense_top_k,
    ivf_dense_top_k_int8,
)
from a_nice_rag_tpu_torch.ops.kmeans import assign_clusters, spherical_kmeans
from a_nice_rag_tpu_torch.ops.quantized import QuantizedDense, quantize_queries
from a_nice_rag_tpu_torch.ops.topk import dedup_ranked, stable_top_k

_BIG = 2**30


@dataclasses.dataclass
class IVFDense:
    """Cluster-major permuted dense matrix + probe metadata.

    ``perm[r]`` is the ORIGINAL document row stored at permuted row ``r``
    (-1 for the padded tail). ``cluster_start`` has C+1 entries; cluster
    c occupies rows [cluster_start[c], cluster_start[c+1]). Exactly one
    of ``emb`` (float) or ``values``+``scales`` (int8) is set.
    """

    centroids: torch.Tensor  # [C, D] f32, unit-norm
    perm: torch.Tensor  # [Np] int32 -> original rows (-1 pad)
    cluster_start: torch.Tensor  # [C+1] int32
    tile_n: int
    n_real: int  # valid permuted rows (corpus size + spilled copies)
    max_cluster_tiles: int  # bound on the tiles covering any cluster
    emb: Optional[torch.Tensor] = None  # [Np, D] (Np % tile_n == 0)
    values: Optional[torch.Tensor] = None  # [Np, D] int8
    scales: Optional[torch.Tensor] = None  # [Np] f32 (0.0 on pad rows)
    # Spilled layouts store some documents in their second-nearest
    # cluster too: searches fetch extra slots and dedup ids.
    spilled: bool = False

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def _rows(self) -> torch.Tensor:
        return self.emb if self.emb is not None else self.values

    @property
    def n_tiles(self) -> int:
        return self._rows.shape[0] // self.tile_n


def save_ivf(ivf: IVFDense, path: str) -> None:
    """Persist to one .npz with the JAX package's keys (bf16 rows as
    float32, which both packages read)."""
    arrs = {
        "centroids": _host(ivf.centroids),
        "perm": _host(ivf.perm),
        "cluster_start": _host(ivf.cluster_start),
        "layout": np.array(
            [ivf.tile_n, ivf.n_real, ivf.max_cluster_tiles,
             int(ivf.spilled)],
            np.int64,
        ),
    }
    if ivf.emb is not None:
        arrs["emb"] = _host(ivf.emb)
    else:
        arrs["values"] = _host(ivf.values)
        arrs["scales"] = _host(ivf.scales)
    np.savez(path, **arrs)


def load_ivf(path: str, device: DeviceLike = "cpu") -> IVFDense:
    dev = resolve_device(device)
    with np.load(path) as z:
        layout = [int(v) for v in z["layout"]]
        tile_n, n_real, mct = layout[:3]
        spilled = bool(layout[3]) if len(layout) > 3 else False

        def t(key):
            return numpy_to_torch(z[key], dev) if key in z else None

        return IVFDense(
            centroids=t("centroids"), perm=t("perm"),
            cluster_start=t("cluster_start"), tile_n=tile_n, n_real=n_real,
            max_cluster_tiles=mct, spilled=spilled, emb=t("emb"),
            values=t("values"), scales=t("scales"),
        )


def _ivf_layout(assign_np: np.ndarray, n: int, n_clusters: int,
                tile_n: int, rows: Optional[np.ndarray] = None):
    """Permutation, offsets and bounds of the cluster-major layout.

    ``assign_np`` is per slot: one slot per document without spill; a
    spilled layout passes one extra slot per spilled document, with
    ``rows`` carrying the original document of every slot. Returns
    (gather order over original rows, cluster_start, perm, Np, mct)."""
    s = len(assign_np)
    order = np.argsort(assign_np, kind="stable").astype(np.int32)
    src = order if rows is None else rows[order].astype(np.int32)
    counts = np.bincount(assign_np, minlength=n_clusters)
    cluster_start = np.zeros(n_clusters + 1, dtype=np.int32)
    np.cumsum(counts, out=cluster_start[1:])
    npad = -(-s // tile_n) * tile_n
    perm = np.full(npad, -1, dtype=np.int32)
    perm[:s] = src
    # A cluster spanning rows [s, e) touches floor(s/T)..floor((e-1)/T):
    # at most ceil(max_count/T) + 1 tiles.
    max_count = int(counts.max()) if n_clusters else 0
    mct = int(-(-max_count // tile_n)) + 1
    return src, cluster_start, perm, npad, mct


def _spill_slots(x: torch.Tensor, cent: torch.Tensor, assign_np: np.ndarray,
                 spill_margin: Optional[float]):
    """(rows, clusters) slot lists for a spilled layout: every document in
    its primary cluster, plus those whose second-nearest centroid is
    within ``spill_margin`` cosine of the primary (None: all) in that
    secondary cluster too."""
    n = len(assign_np)
    ids, scs = assign_clusters(x, cent, top=2)
    ids = ids.cpu().numpy()
    scs = scs.cpu().numpy()
    sec = np.where(ids[:, 0] == assign_np, ids[:, 1], ids[:, 0])
    sec_s = np.where(ids[:, 0] == assign_np, scs[:, 1], scs[:, 0])
    pri_s = np.where(ids[:, 0] == assign_np, scs[:, 0], scs[:, 1])
    if spill_margin is None:
        keep = np.ones(n, dtype=bool)
    else:
        keep = (pri_s - sec_s) <= float(spill_margin)
    keep &= sec != assign_np  # C == 1: nothing to spill to
    rows = np.concatenate(
        [np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32)[keep]]
    )
    clusters = np.concatenate([assign_np, sec[keep]])
    return rows, clusters


def _default_clusters(n: int, n_clusters: Optional[int]) -> int:
    """~sqrt(N) clamped to [16, 65536]."""
    if n_clusters is None:
        n_clusters = int(min(65536, max(16, round(np.sqrt(n)))))
    return min(n_clusters, n)


def _layout_for(x: torch.Tensor, n_clusters, tile_n, n_iters, seed, spill,
                spill_margin):
    n = x.shape[0]
    n_clusters = _default_clusters(n, n_clusters)
    cent, assign = spherical_kmeans(x, n_clusters, n_iters=n_iters,
                                    seed=seed)
    assign_np = assign.cpu().numpy()
    rows = None
    if spill and n_clusters > 1:
        rows, assign_np = _spill_slots(x, cent, assign_np, spill_margin)
    order, cluster_start, perm, npad, mct = _ivf_layout(
        assign_np, n, n_clusters, tile_n, rows=rows
    )
    return cent, rows is not None, order, cluster_start, perm, npad, mct


def _gather_pad(t: torch.Tensor, order: np.ndarray, npad: int):
    """Rows of ``t`` in ``order``, zero rows up to ``npad`` (one gather)."""
    out = torch.zeros((npad,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[: len(order)] = t.index_select(
        0, torch.as_tensor(order, dtype=torch.int64, device=t.device)
    )
    return out


def _ivf_from(cent, spilled, order, cluster_start, perm, npad, mct, tile_n,
              **rows) -> IVFDense:
    dev = cent.device
    return IVFDense(
        centroids=cent,
        perm=torch.as_tensor(perm, device=dev),
        cluster_start=torch.as_tensor(cluster_start, device=dev),
        tile_n=tile_n, n_real=len(order), max_cluster_tiles=mct,
        spilled=spilled, **rows,
    )


def build_ivf_dense(
    emb: torch.Tensor,
    n_clusters: Optional[int] = None,
    tile_n: int = 1024,
    n_iters: int = 10,
    seed: int = 0,
    spill: bool = False,
    spill_margin: Optional[float] = None,
) -> IVFDense:
    """Cluster + permute a [N, D] dense matrix (one-time build cost), on
    its device. ``spill`` also stores documents in their second-nearest
    cluster (all, or those within ``spill_margin`` cosine of the
    primary)."""
    cent, spilled, order, cs, perm, npad, mct = _layout_for(
        emb, n_clusters, tile_n, n_iters, seed, spill, spill_margin
    )
    return _ivf_from(cent, spilled, order, cs, perm, npad, mct, tile_n,
                     emb=_gather_pad(emb, order, npad))


def build_ivf_quantized(
    qd: QuantizedDense,
    n_clusters: Optional[int] = None,
    tile_n: int = 1024,
    n_iters: int = 10,
    seed: int = 0,
    spill: bool = False,
    spill_margin: Optional[float] = None,
) -> IVFDense:
    """IVF over an int8-quantized matrix: clustering runs on the int8
    values (per-row positive scales keep each row's direction); the
    permuted corpus stays int8, and pad rows carry scale 0.0."""
    cent, spilled, order, cs, perm, npad, mct = _layout_for(
        qd.values, n_clusters, tile_n, n_iters, seed, spill, spill_margin
    )
    return _ivf_from(cent, spilled, order, cs, perm, npad, mct, tile_n,
                     values=_gather_pad(qd.values, order, npad),
                     scales=_gather_pad(qd.scales, order, npad))


def build_tile_table(
    centroids: torch.Tensor,
    cluster_start: torch.Tensor,
    queries: torch.Tensor,
    nprobe: int,
    max_tiles: int,
    tile_n: int,
    mct: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe clusters and emit the deduped covering-tile table.

    Returns (tile_table [max_tiles] int32, real tiles ascending first,
    then -1; n_unique, a 0-d int32 device tensor: the number of distinct
    tiles the batch wanted; n_unique > max_tiles means the table was cut,
    keeping the lowest tile ids). Nothing syncs to the host.
    """
    q = queries.to(torch.float32)
    cent = centroids.to(queries.dtype).to(torch.float32)
    scores = q @ cent.T  # [B, C]
    _, cids = stable_top_k(scores, nprobe)  # [B, p], lower id on ties
    starts = cluster_start[cids].long()
    ends = cluster_start[cids + 1].long()
    t0 = starts // tile_n
    t1 = torch.div(ends - 1, tile_n, rounding_mode="floor")  # inclusive
    j = torch.arange(mct, device=q.device)
    tiles = t0[..., None] + j  # [B, p, mct]
    valid = (tiles <= t1[..., None]) & (ends > starts)[..., None]
    flat = torch.where(valid, tiles, _BIG).reshape(-1)
    srt = torch.sort(flat).values
    uniq = torch.cat([torch.ones_like(srt[:1], dtype=torch.bool),
                      srt[1:] != srt[:-1]])
    keyed = torch.where(uniq & (srt < _BIG), srt, _BIG)
    n_unique = (keyed < _BIG).sum().to(torch.int32)
    keyed = torch.sort(keyed).values
    if keyed.shape[0] < max_tiles:
        # Tiny batches can want fewer candidates (B*p*mct) than the
        # table's size: pad with sentinels.
        keyed = torch.cat([keyed, keyed.new_full(
            (max_tiles - keyed.shape[0],), _BIG)])
    table = keyed[:max_tiles]
    return torch.where(table >= _BIG, -1, table).to(torch.int32), n_unique


def attach_ivf(
    index,
    model_name: str,
    n_clusters: Optional[int] = None,
    tile_n: int = 1024,
    n_iters: int = 10,
    seed: int = 0,
    spill: bool = False,
    spill_margin: Optional[float] = None,
) -> IVFDense:
    """Build and attach an IVF structure for one of an ArrayIndex's dense
    models (float or int8). The original matrix is kept for the exact
    and filtered routes, so that model's memory doubles."""
    kw = dict(n_clusters=n_clusters, tile_n=tile_n, n_iters=n_iters,
              seed=seed, spill=spill, spill_margin=spill_margin)
    if model_name in index.dense:
        ivf = build_ivf_dense(index.dense[model_name], **kw)
    elif index.dense_q and model_name in index.dense_q:
        ivf = build_ivf_quantized(index.dense_q[model_name], **kw)
    else:
        raise KeyError(f"no dense matrix for model {model_name!r}")
    if index.ivf is None:
        index.ivf = {}
    index.ivf[model_name] = ivf
    return ivf


def default_max_tiles(ivf: IVFDense, batch: int, nprobe: int) -> int:
    """Table size with no truncation: every probed cluster on its own
    tile run, capped at the whole corpus."""
    return min(ivf.n_tiles, batch * nprobe * ivf.max_cluster_tiles)


def ivf_top_k(ivf: IVFDense, queries: torch.Tensor, table: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3/K4 over the table's tiles, ids mapped back to ORIGINAL rows;
    spilled layouts fetch min(2k, n_real), dedup and cut to k."""
    k_fetch = min(2 * k, ivf.n_real) if ivf.spilled else k
    if ivf.emb is not None:
        vals, pidx = ivf_dense_top_k(ivf.emb, queries, table, k_fetch,
                                     tile_n=ivf.tile_n, n_real=ivf.n_real)
    else:
        qv, qs = quantize_queries(queries)
        vals, pidx = ivf_dense_top_k_int8(
            ivf.values, ivf.scales, qv, qs, table, k_fetch,
            tile_n=ivf.tile_n, n_real=ivf.n_real,
        )
    ids = torch.where(
        pidx >= 0, ivf.perm[pidx.clamp(0, ivf.perm.shape[0] - 1).long()], -1
    )
    if ivf.spilled:
        vals, ids = dedup_ranked(vals, ids)
        vals, ids = vals[:, :k], ids[:, :k]
    return vals, ids


def ivf_search(
    ivf: IVFDense,
    queries: torch.Tensor,
    k: int,
    nprobe: int,
    max_tiles: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ANN top-k: probe ``nprobe`` clusters per query, scan the union.

    Returns (values [B, k] desc, ORIGINAL doc rows [B, k] with -1 for
    unfilled slots, n_unique tile count as a device tensor). With nprobe
    == n_clusters this equals the exact scan. For an int8 IVF the float
    queries are quantized on the fly (probe scores stay float).
    """
    if max_tiles is None:
        max_tiles = default_max_tiles(ivf, queries.shape[0], nprobe)
    table, n_unique = build_tile_table(
        ivf.centroids, ivf.cluster_start, queries, nprobe=nprobe,
        max_tiles=max_tiles, tile_n=ivf.tile_n, mct=ivf.max_cluster_tiles,
    )
    vals, ids = ivf_top_k(ivf, queries, table, k)
    return vals, ids, n_unique


def tune_nprobe(
    ivf: IVFDense,
    queries: torch.Tensor,
    k: int = 10,
    target_recall: float = 0.95,
    candidates: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256),
    exact_ids: Optional[np.ndarray] = None,
) -> Tuple[int, dict]:
    """The smallest ``nprobe`` whose recall@k against the exact scan meets
    ``target_recall`` on a validation batch (an offline tool: it reads
    results on the host). The exact baseline is the full probe, unless
    ``exact_ids`` from another exact route is given. Returns (best
    nprobe, {nprobe: recall}); the largest candidate when none reaches
    the target. Candidates are clamped to the cluster count."""
    cands = sorted({min(int(c), ivf.n_clusters) for c in candidates})
    if exact_ids is None:
        _, exact, _ = ivf_search(ivf, queries, k, nprobe=ivf.n_clusters)
        exact_ids = exact.cpu().numpy()
    exact_sets = [set(r[r >= 0].tolist()) for r in np.asarray(exact_ids)]
    denom = max(1, sum(len(s) for s in exact_sets))
    report: dict = {}
    best = cands[-1]
    for cand in cands:
        _, got, _ = ivf_search(ivf, queries, k, nprobe=cand)
        got = got.cpu().numpy()
        hits = sum(
            len(exact_sets[i] & set(got[i][got[i] >= 0].tolist()))
            for i in range(len(exact_sets))
        )
        recall = hits / denom
        report[cand] = recall
        if recall >= target_recall:
            best = cand
            break
    return best, report
