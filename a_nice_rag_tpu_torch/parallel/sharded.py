"""Corpus-sharded retrieval over a slot mesh.

Counterpart of ``a_nice_rag_tpu/parallel/sharded.py``. Layout:

* the dense matrices, the BM25 postings and the candidate masks are split
  along the document axis over the mesh's ``corpus`` axis (host-major
  over ``(host, corpus)`` when a host axis is given): shard s holds
  global rows [s * n_local, (s + 1) * n_local);
* a query batch is split over the ``dp`` axis; each dp group holds a
  replica of every shard, on its own slots' devices.

Each shard ranks its rows with the same routes as ``FusedRetriever``: at
scale on CUDA the fused top-k kernels K1/K2 per shard (and K1 on each
shard's two-tier BM25 common tier), K3/K4 for a per-shard IVF. Local ids
are rebased to global ids, moved to the group's lead device and merged
exactly: a global top-k document is in its own shard's top-k. WRRF then
fuses the merged lists. The JAX package runs the same steps as one
``shard_map`` program; here the host dispatches them shard by shard, and the
merge is plain torch (as the JAX package's is plain XLA).

Shards are built on the device: a shard of the base index's device that
needs no pad rows is a view of the base matrix (``narrow``); only pad
tails and shards on other devices copy. The shard geometry (``n_local``,
global ids, the per-shard IVF file) is the JAX package's, so both
packages agree on every global id.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from a_nice_rag_tpu_torch.index.array_index import ArrayIndex
from a_nice_rag_tpu_torch.index.ivf import (
    IVFDense,
    _default_clusters,
    _gather_pad,
    _spill_slots,
    build_tile_table,
)
from a_nice_rag_tpu_torch.ops.bm25 import (
    Bm25Arrays,
    Bm25TwoTier,
    bm25_scores_two_tier,
    bm25_top_k_sparse,
    bm25_top_k_two_tier,
    split_two_tier,
)
from a_nice_rag_tpu_torch.ops.dense import dense_scores
from a_nice_rag_tpu_torch.ops.fusion import wrrf_top_n_sparse
from a_nice_rag_tpu_torch.ops.kernels import (
    fused_dense_top_k,
    fused_dense_top_k_int8,
    ivf_dense_top_k,
    ivf_dense_top_k_int8,
)
from a_nice_rag_tpu_torch.ops.kmeans import spherical_kmeans_batched
from a_nice_rag_tpu_torch.ops.quantized import (
    QuantizedDense,
    quantize_queries,
    quantized_dense_scores,
)
from a_nice_rag_tpu_torch.ops.topk import dedup_ranked, masked_top_k, merge_top_k
from a_nice_rag_tpu_torch.parallel.mesh import DeviceMesh, as_slots
from a_nice_rag_tpu_torch.retrieval.engine import (
    DENSE_BACKENDS,
    IVF_ROUTES,
    FusedRetriever,
    _ivf_coverage,
    plan_for,
    rounded_fold,
)

BM25_BACKENDS = ("auto", "sparse", "two_tier", "two_tier_streaming")
Matrix = Union[torch.Tensor, QuantizedDense]


@dataclasses.dataclass
class IndexShard:
    """One corpus shard on one device: global rows [offset, offset +
    n_local) of the base index, zero rows past its end."""

    device: torch.device
    offset: int
    n_real: int  # rows below the base index's document count
    dense: Dict[str, Matrix]  # model -> [n_local, D] or QuantizedDense
    bm25: Optional[Bm25Arrays]  # local CSR (global idf / avgdl impacts)
    two_tier: Optional[Bm25TwoTier] = None
    ivf: Optional[IVFDense] = None  # per-shard IVF of ``ivf_model``
    # [1] int32: the IVF's real-row count, the trailing slot of K3/K4's
    # dynamic tile table.
    ivf_real_slot: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ShardedIndex:
    """A hybrid index laid out over a mesh's corpus axis.

    ``replicas[g][s]`` is shard s of dp group g; groups whose slots share
    a device share the shard objects (a virtual mesh holds one copy).
    """

    mesh: DeviceMesh
    replicas: List[List[IndexShard]]
    base_index: ArrayIndex
    n_local: int  # docs per shard (padded)
    n_shards: int
    corpus_axis: str = "corpus"
    data_axis: str = "dp"
    # Multi-host layout: the document axis runs host-major over (host,
    # corpus) and merges run within each host group first.
    host_axis: Optional[str] = None
    # Build settings kept so failure recovery rebuilds the same layout.
    two_tier_common: int = 0
    two_tier_dtype: str = "bfloat16"
    # Per-shard IVF of one model (shard_ivf): each shard clusters its own
    # rows; the arrays live on the shards (``IndexShard.ivf``).
    ivf_model: Optional[str] = None
    ivf_tile_n: int = 0
    ivf_mct: int = 0
    ivf_spilled: bool = False
    ivf_spill_margin: Optional[float] = None

    def __post_init__(self) -> None:
        self._mask_cache: Dict[tuple, List[List[Optional[torch.Tensor]]]] = {}

    @property
    def shards(self) -> List[IndexShard]:
        """The shards of dp group 0, in global order."""
        return self.replicas[0]

    @property
    def n_docs_padded(self) -> int:
        return self.n_local * self.n_shards

    @property
    def n_dp(self) -> int:
        return len(self.replicas)

    @property
    def lead(self) -> torch.device:
        """The device the merged results of the whole batch land on."""
        return self.replicas[0][0].device

    @property
    def dense_model_names(self) -> Tuple[str, ...]:
        return tuple(self.shards[0].dense)

    @property
    def has_two_tier(self) -> bool:
        return self.shards[0].two_tier is not None

    def _ivf_stack(self, get) -> torch.Tensor:
        return torch.stack([get(sh).cpu() for sh in self.shards])

    @property
    def ivf_centroids(self) -> torch.Tensor:
        """[S, C, D] host copy of the per-shard centroids."""
        return self._ivf_stack(lambda sh: sh.ivf.centroids)

    @property
    def ivf_perm(self) -> torch.Tensor:
        """[S, Npl] host copy: permuted slot -> LOCAL row (-1 pad)."""
        return self._ivf_stack(lambda sh: sh.ivf.perm)

    @property
    def ivf_cluster_start(self) -> torch.Tensor:
        return self._ivf_stack(lambda sh: sh.ivf.cluster_start)

    @property
    def ivf_n_real(self) -> torch.Tensor:
        """[S] int32: the filled slots of each shard's IVF."""
        return torch.tensor([sh.ivf.n_real for sh in self.shards],
                            dtype=torch.int32)

    @property
    def ivf_n_clusters(self) -> int:
        return self.shards[0].ivf.n_clusters

    def _evict_stale(self, version: int) -> None:
        # A snapshot of the keys: serving threads may insert meanwhile.
        for k in [k for k in list(self._mask_cache) if k[-1] != version]:
            self._mask_cache.pop(k, None)

    def _masks(self, key: tuple, host_mask) -> List[List[Optional[torch.Tensor]]]:
        """Per replica, per shard: the shard's slice of a [N_pad] host
        mask on the shard's device, or None where it is all True (no pad
        row, no filtered or tombstoned doc in the shard)."""
        version = getattr(self.base_index, "_version", 0)
        key = key + (version,)
        out = self._mask_cache.get(key)
        if out is None:
            self._evict_stale(version)
            m = host_mask()
            m = np.pad(m, (0, self.n_docs_padded - m.shape[0]))
            made: Dict[int, Optional[torch.Tensor]] = {}
            out = []
            for rep in self.replicas:
                row = []
                for s, sh in enumerate(rep):
                    if id(sh) not in made:
                        part = m[s * self.n_local:(s + 1) * self.n_local]
                        made[id(sh)] = None if part.all() else \
                            torch.as_tensor(part, device=sh.device)
                    row.append(made[id(sh)])
                out.append(row)
            self._mask_cache[key] = out
        return out

    def filter_mask(self, filename_type_filter: Optional[str]):
        """Candidate masks per replica and shard (tombstones excluded)."""
        meta = self.base_index.meta
        return self._masks(("dense", filename_type_filter or None),
                           lambda: meta.filter_mask(filename_type_filter))

    def bm25_mask(self, filename_type_filter: Optional[str]):
        """:meth:`filter_mask` and the docs with at least one token."""
        base = self.base_index

        def host():
            m = base.meta.filter_mask(filename_type_filter)
            if base.bm25_doc_mask is not None:
                m = m & base.bm25_doc_mask
            return m

        return self._masks(("bm25", filename_type_filter or None), host)


def _on(device: torch.device):
    """Launch work on ``device`` (the current CUDA device there)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _rows(t: torch.Tensor, lo: int, n_local: int,
          device: torch.device) -> torch.Tensor:
    """Rows [lo, lo + n_local) of ``t`` on ``device``, zero rows past its
    end: a view of ``t`` where it holds them all on that device."""
    hi = min(lo + n_local, t.shape[0])
    if hi - lo == n_local:
        part = t.narrow(0, lo, n_local)
        return part if t.device == device else part.to(device)
    out = torch.zeros((n_local,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=device)
    if hi > lo:
        out[:hi - lo] = t[lo:hi].to(device)
    return out


def _shard_csr(bm25: Bm25Arrays, n_shards: int,
               n_local: int) -> List[Bm25Arrays]:
    """Split global CSR postings into per-shard CSRs, on their device.

    A term's postings are sorted by doc id, so each shard's are a
    selection that keeps their order. Impacts are unchanged: idf and
    avgdl stay global, so sharded scores equal single-device scores.
    Each shard ends in the sentinel slot (doc ``n_local``, impact 0).
    """
    dev = bm25.indptr.device
    indptr = bm25.indptr.long()
    v = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    ids = bm25.doc_ids[:nnz].long()
    imp = bm25.impact[:nnz]
    term_of = torch.repeat_interleave(torch.arange(v, device=dev),
                                      torch.diff(indptr))
    shard_of = ids // n_local
    out = []
    for s in range(n_shards):
        sel = shard_of == s
        ptr = torch.zeros(v + 1, dtype=torch.int32, device=dev)
        ptr[1:] = torch.cumsum(torch.bincount(term_of[sel], minlength=v), 0)
        out.append(Bm25Arrays(
            indptr=ptr,
            doc_ids=torch.cat([
                (ids[sel] - s * n_local).to(torch.int32),
                torch.tensor([n_local], dtype=torch.int32, device=dev)]),
            impact=torch.cat([
                imp[sel].to(torch.float32),
                torch.zeros(1, dtype=torch.float32, device=dev)]),
            n_docs_padded=n_local,
        ))
    return out


def _move_csr(b: Bm25Arrays, device: torch.device) -> Bm25Arrays:
    return Bm25Arrays(indptr=b.indptr.to(device), doc_ids=b.doc_ids.to(device),
                      impact=b.impact.to(device), n_docs_padded=b.n_docs_padded)


def _move_two_tier(tt: Bm25TwoTier, device: torch.device) -> Bm25TwoTier:
    return Bm25TwoTier(common_impact_t=tt.common_impact_t.to(device),
                       common_map=tt.common_map.to(device),
                       rare=_move_csr(tt.rare, device))


def _dp_grid(mesh: DeviceMesh, data_axis: str, host_axis: Optional[str],
             corpus_axis: str) -> np.ndarray:
    """[dp, S] slots: each dp group's shards, host-major."""
    grid = mesh.slot_grid(data_axis, host_axis, corpus_axis)
    return grid.reshape(grid.shape[0], -1)


def shard_index(index: ArrayIndex, mesh: DeviceMesh,
                corpus_axis: str = "corpus", data_axis: str = "dp",
                two_tier_common: int = 0, two_tier_dtype: str = "bfloat16",
                host_axis: Optional[str] = None) -> ShardedIndex:
    """Lay an ArrayIndex out over the mesh's corpus axis.

    ``two_tier_common > 0`` also builds each shard's two-tier BM25 layout
    (that many dense common-term columns per shard + the rare CSR).
    ``host_axis`` shards the document axis over (host, corpus),
    host-major; retrieval then merges within each host group first.
    """
    n_shards = mesh.shape[corpus_axis]
    if host_axis is not None:
        n_shards *= mesh.shape[host_axis]
    n_local = -(-index.n_docs_padded // n_shards)
    # The JAX package's rounding: shard sizes stay multiples of 128.
    n_local = -(-n_local // 128) * 128
    grid = _dp_grid(mesh, data_axis, host_axis, corpus_axis)

    mats = {m: index.dense_matrix(m) for m in index.dense_model_names}
    csr = tiers = None
    if index.bm25 is not None:
        csr = _shard_csr(index.bm25, n_shards, n_local)
        if two_tier_common > 0:
            tiers = [split_two_tier(b, two_tier_common, two_tier_dtype)
                     for b in csr]

    built: Dict[tuple, IndexShard] = {}

    def shard(s: int, device: torch.device) -> IndexShard:
        lo = _shard_offset(n_local, s)
        dense = {}
        for m, mat in mats.items():
            if isinstance(mat, QuantizedDense):
                dense[m] = QuantizedDense(
                    values=_rows(mat.values, lo, n_local, device),
                    scales=_rows(mat.scales, lo, n_local, device))
            else:
                dense[m] = _rows(mat, lo, n_local, device)
        return IndexShard(
            device=device, offset=lo,
            n_real=int(np.clip(index.n_docs - lo, 0, n_local)), dense=dense,
            bm25=None if csr is None else _move_csr(csr[s], device),
            two_tier=None if tiers is None else _move_two_tier(tiers[s],
                                                               device),
        )

    replicas = []
    for row in grid:
        rep = []
        for s, slot in enumerate(row):
            key = (slot.device, s)
            if key not in built:
                built[key] = shard(s, slot.device)
            rep.append(built[key])
        replicas.append(rep)
    return ShardedIndex(
        mesh=mesh, replicas=replicas, base_index=index, n_local=n_local,
        n_shards=n_shards, corpus_axis=corpus_axis, data_axis=data_axis,
        host_axis=host_axis,
        two_tier_common=two_tier_common if index.bm25 is not None else 0,
        two_tier_dtype=two_tier_dtype,
    )


def shard_ivf(
    sidx: ShardedIndex,
    model_name: str,
    n_clusters: Optional[int] = None,
    tile_n: int = 1024,
    n_iters: int = 10,
    seed: int = 0,
    spill: bool = False,
    spill_margin: Optional[float] = None,
    init: Optional[torch.Tensor] = None,
) -> ShardedIndex:
    """Build the per-shard IVF layout of one model.

    Each shard clusters its OWN real rows (spherical k-means with one
    cluster count C for all shards) and stores them cluster-major, pad
    slots at the end; K3/K4 read the real-slot count from the tile
    table's trailing slot, so per-shard counts may differ. ``spill``
    also stores a shard's boundary docs in their second-nearest LOCAL
    cluster (all, or those within ``spill_margin`` cosine of the
    primary); duplicates stay within a shard, and the retriever dedups
    per shard before the merge. Shard s seeds its k-means with ``seed +
    s``; ``init`` ([S, C, D], unit rows) replaces the drawn initial rows.

    Returns a new ShardedIndex carrying the IVF; serve it with
    ``ShardedRetriever(..., nprobe=p)``.
    """
    base = sidx.base_index
    nl, s_cnt = sidx.n_local, sidx.n_shards
    c = _default_clusters(nl, n_clusters)
    reals = [sh.n_real for sh in sidx.shards]
    c = min(c, min(r for r in reals if r > 0) if any(reals) else 1)
    quantized = isinstance(base.dense_matrix(model_name), QuantizedDense)

    def rows_of(sh):
        mat = sh.dense[model_name]
        return mat.values if quantized else mat

    xs = [rows_of(sh) for sh in sidx.shards]
    cents, assigns = spherical_kmeans_batched(
        xs, reals, c, n_iters=n_iters, seed=seed, init=init)

    # Per-shard slot lists (LOCAL rows): every real row in its primary
    # cluster, and with spill the boundary rows in their secondary one.
    slot_rows, slot_clusters = [], []
    for s, x in enumerate(xs):
        a1 = assigns[s][:reals[s]].cpu().numpy().astype(np.int64)
        if spill and reals[s] > 0 and c > 1:
            rows_s, clusters_s = _spill_slots(x[:reals[s]], cents[s], a1,
                                              spill_margin)
        else:
            rows_s, clusters_s = np.arange(reals[s], dtype=np.int32), a1
        slot_rows.append(rows_s)
        slot_clusters.append(np.asarray(clusters_s, np.int64))

    # One slot width for all shards (the saved layout stacks them).
    max_slots = max((len(r) for r in slot_rows), default=0)
    npl = max(tile_n, -(-max(max_slots, 1) // tile_n) * tile_n)
    perms, cstarts, counts_all = [], [], []
    mct = 1
    for s in range(s_cnt):
        n_slots = len(slot_rows[s])
        key = np.full(npl, c, np.int64)  # pads sort after every cluster
        key[:n_slots] = slot_clusters[s]
        order = np.argsort(key, kind="stable").astype(np.int32)
        counts = np.bincount(slot_clusters[s], minlength=c).astype(np.int64)
        cstart = np.zeros(c + 1, np.int32)
        np.cumsum(counts, out=cstart[1:])
        perm = np.full(npl, -1, np.int32)
        if n_slots:
            perm[:n_slots] = slot_rows[s][order[:n_slots]]
        perms.append(perm)
        cstarts.append(cstart)
        counts_all.append(n_slots)
        mct = max(mct, int(-(-counts.max() // tile_n)) + 1)
    cents_np = np.stack([
        cents[s].cpu().numpy() if reals[s] > 0
        else np.zeros((c, xs[s].shape[1]), np.float32)
        for s in range(s_cnt)
    ]).astype(np.float32)
    return _materialize_shard_ivf(
        sidx, model_name, cents_np, np.stack(perms), np.stack(cstarts),
        np.asarray(counts_all, np.int32), tile_n, mct, spilled=spill,
        spill_margin=spill_margin,
    )


def _materialize_shard_ivf(sidx, model_name, cents, perms, cstarts, reals,
                           tile_n, mct, spilled=False, spill_margin=None):
    """Gather each shard's cluster-major rows from its own matrix (pad
    slots zero rows, zero scales) on its device, and attach the IVF."""
    quantized = isinstance(sidx.base_index.dense_matrix(model_name),
                           QuantizedDense)
    npl = perms.shape[1]
    made: Dict[int, IndexShard] = {}

    def with_ivf(s: int, sh: IndexShard) -> IndexShard:
        dev = sh.device
        n_slots = int(reals[s])
        order = perms[s][:n_slots]
        mat = sh.dense[model_name]
        if quantized:
            rows = dict(values=_gather_pad(mat.values, order, npl),
                        scales=_gather_pad(mat.scales, order, npl))
        else:
            rows = dict(emb=_gather_pad(mat, order, npl))
        ivf = IVFDense(
            centroids=torch.as_tensor(cents[s], dtype=torch.float32,
                                      device=dev),
            perm=torch.as_tensor(perms[s], dtype=torch.int32, device=dev),
            cluster_start=torch.as_tensor(cstarts[s], dtype=torch.int32,
                                          device=dev),
            tile_n=tile_n, n_real=n_slots, max_cluster_tiles=mct,
            spilled=bool(spilled), **rows)
        return dataclasses.replace(
            sh, ivf=ivf, ivf_real_slot=torch.tensor([n_slots],
                                                    dtype=torch.int32,
                                                    device=dev))

    replicas = []
    for rep in sidx.replicas:
        row = []
        for s, sh in enumerate(rep):
            if id(sh) not in made:
                made[id(sh)] = with_ivf(s, sh)
            row.append(made[id(sh)])
        replicas.append(row)
    return dataclasses.replace(
        sidx, replicas=replicas, ivf_model=model_name, ivf_tile_n=tile_n,
        ivf_mct=mct, ivf_spilled=bool(spilled), ivf_spill_margin=spill_margin,
    )


def save_shard_ivf(sidx: ShardedIndex, path: str) -> None:
    """Persist the per-shard IVF clustering (centroids, permutation,
    cluster offsets: ~4 bytes a doc), not the permuted rows, which are
    gathered again from the shards on load. The keys and layout are the
    JAX package's, so each package reads the other's file."""
    assert sidx.ivf_model is not None, "no IVF layout attached"
    np.savez(
        path,
        model=np.array(sidx.ivf_model),
        centroids=sidx.ivf_centroids.numpy(),
        perm=sidx.ivf_perm.numpy(),
        cluster_start=sidx.ivf_cluster_start.numpy(),
        n_real=sidx.ivf_n_real.numpy(),
        layout=np.asarray(
            [sidx.ivf_tile_n, sidx.ivf_mct, sidx.n_shards, sidx.n_local,
             int(sidx.ivf_spilled)], np.int64),
        spill_margin=np.asarray(
            np.nan if sidx.ivf_spill_margin is None
            else float(sidx.ivf_spill_margin)),
    )


def load_shard_ivf(sidx: ShardedIndex, path: str) -> ShardedIndex:
    """Attach a saved per-shard IVF to a freshly sharded index. The shard
    geometry must be the one the file was built for (another shard count
    needs a ``shard_ivf`` rebuild)."""
    with np.load(path) as z:
        layout = [int(v) for v in z["layout"]]
        tile_n, mct, s_cnt, nl = layout[:4]
        spilled = bool(layout[4]) if len(layout) > 4 else False
        margin = None
        if "spill_margin" in z:
            m = float(z["spill_margin"])
            margin = None if np.isnan(m) else m
        if (s_cnt, nl) != (sidx.n_shards, sidx.n_local):
            raise ValueError(
                f"IVF layout built for {s_cnt} shards x {nl} local rows; "
                f"index has {sidx.n_shards} x {sidx.n_local} — rebuild "
                "with shard_ivf")
        return _materialize_shard_ivf(
            sidx, str(z["model"]), z["centroids"], z["perm"],
            z["cluster_start"], z["n_real"], tile_n, mct, spilled=spilled,
            spill_margin=margin)


# -- the merge ---------------------------------------------------------------


def _gather_merge(vals: Sequence[torch.Tensor], gidx: Sequence[torch.Tensor],
                  k: int, lead: torch.device):
    """Move per-shard (values, global ids) [B, k_local] lists to ``lead``
    and merge them into the best min(k, S * k_local). The lists go in
    global shard order and each is (value desc, id asc), so equal values
    come out id-ascending as in the unsharded list."""
    all_v = torch.stack([v.to(lead, non_blocking=True) for v in vals], 1)
    all_i = torch.stack([i.to(lead, non_blocking=True) for i in gidx], 1)
    k_out = min(k, all_v.shape[1] * all_v.shape[2])
    mvals, midx = merge_top_k(all_v, all_i, k_out)
    return mvals, torch.where(torch.isfinite(mvals), midx, -1)


def _shard_offset(n_local: int, shard: int) -> int:
    """Global doc id of a shard's local row 0 (host-major shard order:
    shard = host * n_corpus + corpus)."""
    return shard * n_local


def _local_to_global(vals: torch.Tensor, lidx: torch.Tensor,
                     offset: int) -> torch.Tensor:
    return torch.where(torch.isfinite(vals) & (lidx >= 0),
                       lidx.to(torch.int32) + offset, -1).to(torch.int32)


def hierarchical_gather_merge(vals, gidx, k: int, n_intra: int,
                              lead: torch.device):
    """Two-level merge: each group of ``n_intra`` consecutive lists (one
    host's shards) to one k-list first, then the groups' winners. Exact,
    as a top-k merge is associative; across hosts it moves k entries a
    host instead of k a shard."""
    groups = [
        _gather_merge(vals[g:g + n_intra], gidx[g:g + n_intra], k, lead)
        for g in range(0, len(vals), n_intra)
    ]
    return _gather_merge([v for v, _ in groups], [i for _, i in groups], k,
                         lead)


def _merge_over(sidx: ShardedIndex, vals, gidx, k: int, lead: torch.device):
    """Exact global merge: one gather, or per host group first."""
    if sidx.host_axis is None:
        return _gather_merge(vals, gidx, k, lead)
    return hierarchical_gather_merge(vals, gidx, k,
                                     sidx.mesh.shape[sidx.corpus_axis], lead)


def _local_to_global_topk(scores: torch.Tensor, k: int, offset: int,
                          mask: Optional[torch.Tensor] = None):
    """Masked local top-min(k, n_local) with global ids."""
    vals, idx = masked_top_k(scores, min(k, scores.shape[-1]),
                             None if mask is None else mask[None, :])
    return vals, _local_to_global(vals, idx, offset)


def _dense_shard(sh: IndexShard, mat: Matrix, q: torch.Tensor,
                 mask: Optional[torch.Tensor], k_local: int,
                 use_kernel: bool, plan=None, rounded: bool = False):
    """One shard's dense list: K1 (float rows, ``plan`` its query block
    and splits) or K2 (int8) on the kernel route, K1r / K2r there with
    ``rounded``, materialized [B, n_local] scores otherwise."""
    if isinstance(mat, QuantizedDense):
        qv, qs = quantize_queries(q)
        if use_kernel:
            vals, lidx = fused_dense_top_k_int8(mat.values, mat.scales, qv,
                                                qs, k_local, mask=mask,
                                                rounded=rounded)
            return vals, _local_to_global(vals, lidx, sh.offset)
        scores = quantized_dense_scores(mat, qv, qs)
    elif use_kernel:
        vals, lidx = fused_dense_top_k(mat, q, k_local, mask=mask,
                                       plan=plan, rounded=rounded)
        return vals, _local_to_global(vals, lidx, sh.offset)
    else:
        scores = dense_scores(mat, q)
    return _local_to_global_topk(scores, k_local, sh.offset, mask)


def _as_f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _groups(sidx: ShardedIndex, b: int):
    """(group, its replica, its batch rows) per dp group; the batch must
    divide the dp axis."""
    dp = sidx.n_dp
    if b % dp:
        raise ValueError(f"batch {b} is not a multiple of the dp axis {dp}")
    bl = b // dp
    return [(g, rep, slice(g * bl, (g + 1) * bl))
            for g, rep in enumerate(sidx.replicas)]


class ShardedRetriever:
    """Sharded counterpart of ``FusedRetriever``: every ranker per shard,
    the exact merge, fusion and the final top-n."""

    def __init__(
        self,
        sidx: ShardedIndex,
        model_names: Sequence[str],
        use_bm25: bool,
        similarity_k: int = 25,
        common_sections_n: int = 15,
        budget: int = 16384,
        dense_backend: str = "auto",
        bm25_backend: str = "auto",
        nprobe: Optional[int] = None,
        ivf_max_tiles: Optional[int] = None,
        ivf_route: str = "auto",
        ivf_max_coverage: float = 0.25,
        kernel_config=None,
    ):
        """``dense_backend``: "auto" streams each shard through K1/K2 on
        CUDA when the shard holds at least
        ``FusedRetriever.KERNEL_THRESHOLD`` rows and k <= 128; "kernel"
        always takes the kernels (their plain versions on CPU tensors);
        "torch" materializes each shard's scores (FusedRetriever's
        names).

        ``bm25_backend``: "auto" takes the two-tier layout when the index
        carries one (``shard_index(two_tier_common=...)``), else the
        sort-based CSR top-k; "sparse" forces the CSR; "two_tier" needs
        the layout and materializes each shard's scores;
        "two_tier_streaming" streams each shard's common tier through K1
        (exact, no [B, n_local] scores).

        ``nprobe``: opt-in ANN for the model of ``shard_ivf``: each shard
        probes its own top-``nprobe`` clusters and K3/K4 scan only their
        tiles; the merge is unchanged. Filtered or tombstoned calls take
        the exact route. ``ivf_route``/``ivf_max_coverage``: as
        FusedRetriever's, with the coverage
        ``1 - (1 - p/C_shard)^(B/dp)`` of one dp group's batch.

        ``kernel_config``: K1's query block and splits on every shard, at
        the dp group's batch it was tuned at (FusedRetriever's); int8
        shards keep K2's plan. Its ``rounded`` puts every shard's dense
        list on the rounded fold at every batch (FusedRetriever's; a
        shard of n_local % 1024 != 0 rows keeps the exact fold). The merge
        keeps (value desc, id asc) over the shards' rounded values, so
        the lists are unsharded K1r's, but that it ranks a rounded -0.0
        with +0.0.
        """
        if dense_backend not in DENSE_BACKENDS:
            raise ValueError(f"dense_backend must be one of "
                             f"{DENSE_BACKENDS}, got {dense_backend!r}")
        if bm25_backend not in BM25_BACKENDS:
            raise ValueError(f"bm25_backend must be one of {BM25_BACKENDS},"
                             f" got {bm25_backend!r}")
        if ivf_route not in IVF_ROUTES:
            raise ValueError(f"ivf_route must be one of {IVF_ROUTES}, got "
                             f"{ivf_route!r}")
        self.sidx = sidx
        self.model_names = tuple(model_names)
        self.use_bm25 = use_bm25
        if not self.model_names and not use_bm25:
            raise ValueError("ShardedRetriever needs at least one ranker")
        self.similarity_k = min(similarity_k, sidx.n_docs_padded)
        self.common_sections_n = min(common_sections_n, sidx.n_docs_padded)
        self.budget = budget
        # Per-shard lists hold at most a shard; the merge still yields
        # min(k, S * k_local).
        self.k_local = min(self.similarity_k, sidx.n_local)
        self.use_kernel = FusedRetriever._route_kernel(
            dense_backend, sidx.n_local, self.k_local, sidx.lead.type)
        has_tt = sidx.has_two_tier
        if bm25_backend in ("two_tier", "two_tier_streaming") and not has_tt:
            raise ValueError(f"{bm25_backend} bm25_backend requires "
                             "shard_index(two_tier_common=...)")
        self.use_two_tier = use_bm25 and has_tt and bm25_backend != "sparse"
        self.tt_streaming = bm25_backend == "two_tier_streaming"
        # The largest df over every shard makes the per-term window fetch
        # lossless (used where T * df_cap stays affordable).
        self._df_cap = None
        if use_bm25:
            ptrs = [sh.two_tier.rare.indptr if self.use_two_tier
                    else sh.bm25.indptr for sh in sidx.shards
                    if sh.bm25 is not None]
            if ptrs:
                self._df_cap = max(1, max(
                    int(torch.diff(p).max()) if p.numel() > 1 else 0
                    for p in ptrs))
        self.nprobe = nprobe
        self.ivf_max_tiles = ivf_max_tiles
        self.ivf_route = ivf_route
        self.ivf_max_coverage = float(ivf_max_coverage)
        self.kernel_config = kernel_config
        self.use_ivf = bool(nprobe and sidx.ivf_model is not None
                            and sidx.ivf_model in self.model_names)
        self._weights: Dict[tuple, torch.Tensor] = {}

    def __call__(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms: Optional[np.ndarray],
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (fused scores, fused ids) as host arrays (the JAX
        package's order)."""
        fids, fvals, _ = self.retrieve_device(
            q_embs, q_terms, weights, filename_type_filter, wrrf_k)
        return fvals.cpu().numpy(), fids.cpu().numpy()

    def _route_ivf(self, b: int, filtered: bool, tombstoned: bool) -> bool:
        """The ANN route for this call: the layout is attached, no mask is
        needed, and (under "auto") one dp group's expected per-shard
        cluster coverage stays at or below ``ivf_max_coverage``."""
        if not self.use_ivf or filtered or tombstoned:
            return False
        if self.ivf_route == "always":
            return True
        cov = _ivf_coverage(max(1, b // self.sidx.n_dp), self.nprobe or 0,
                            self.sidx.ivf_n_clusters)
        return cov <= self.ivf_max_coverage

    def _weights_on(self, weights: Dict[str, float],
                    device: torch.device) -> torch.Tensor:
        key = tuple(
            [weights.get(m, 1.0) for m in self.model_names]
            + ([weights.get("BM25", 1.0)] if self.use_bm25 else [])
        ) + (device,)
        if key not in self._weights:
            self._weights[key] = torch.tensor(key[:-1], dtype=torch.float32,
                                              device=device)
        return self._weights[key]

    def retrieve_device(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms,
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ):
        """Returns (fused ids [B, n] int32, fused scores [B, n] f32, None)
        as tensors on the mesh's lead device. The batch must divide the
        dp axis; each dp group serves its slice of it."""
        return self.retrieve_lists(q_embs, q_terms, weights,
                                   filename_type_filter, wrrf_k)[:2] + (None,)

    def retrieve_lists(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms,
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ):
        """:meth:`retrieve_device` with the merged per-ranker id lists
        [L, B, k'] (k' = min(k, S * k_local)) as the third output, as
        ``FusedRetriever.retrieve_device`` returns its lists."""
        sidx = self.sidx
        qs = [_as_f32(q_embs[m]) for m in self.model_names]
        if qs:
            b = qs[0].shape[0]
        else:
            b = torch.as_tensor(q_terms).shape[0]
        terms = (torch.as_tensor(q_terms, dtype=torch.int32)
                 if self.use_bm25 else None)
        masks = sidx.filter_mask(filename_type_filter)
        bmasks = (sidx.bm25_mask(filename_type_filter) if self.use_bm25
                  else masks)
        ivf_on = self._route_ivf(
            b, filtered=filename_type_filter is not None,
            tombstoned=bool(sidx.base_index.meta.deleted.any()))
        outs = []
        for g, rep, rows in _groups(sidx, b):
            lead = rep[0].device
            out = self._run_group(
                rep, [q[rows] for q in qs],
                None if terms is None else terms[rows], masks[g], bmasks[g],
                self._weights_on(weights, lead), float(wrrf_k), ivf_on, lead)
            outs.append([t.to(sidx.lead) for t in out])
        if len(outs) == 1:
            return tuple(outs[0])
        return tuple(torch.cat([o[j] for o in outs], dim=1 if j == 2 else 0)
                     for j in range(3))

    def _run_group(self, rep, qs, terms, masks, bmasks, w, wrrf_k, ivf_on,
                   lead):
        """One dp group: every ranker on every shard of ``rep``, merged on
        ``lead``, fused. Returns (fused ids, fused scores, lists)."""
        k, n = self.similarity_k, self.common_sections_n
        lists = []
        for name, q in zip(self.model_names, qs):
            vals, gidx = [], []
            for s, sh in enumerate(rep):
                with _on(sh.device):
                    qd = q.to(sh.device, non_blocking=True)
                    if ivf_on and name == self.sidx.ivf_model:
                        v, i = self._ivf_shard(sh, qd)
                    else:
                        v, i = _dense_shard(sh, sh.dense[name], qd, masks[s],
                                            self.k_local, self.use_kernel,
                                            plan_for(self.kernel_config,
                                                     qd.shape[0]),
                                            rounded_fold(self.kernel_config))
                vals.append(v)
                gidx.append(i)
            lists.append(_merge_over(self.sidx, vals, gidx, k, lead)[1])
        if self.use_bm25:
            vals, gidx = [], []
            for s, sh in enumerate(rep):
                with _on(sh.device):
                    v, i = self._bm25_shard(
                        sh, terms.to(sh.device, non_blocking=True), bmasks[s])
                vals.append(v)
                gidx.append(i)
            lists.append(_merge_over(self.sidx, vals, gidx, k, lead)[1])
        all_idx = torch.stack(lists)  # [L, B, k']
        if len(lists) == 1:
            ids = lists[0][:, :n]
            return ids, torch.zeros(ids.shape, device=ids.device), all_idx
        fvals, fids = wrrf_top_n_sparse(all_idx, w, n, wrrf_k)
        return torch.where(torch.isfinite(fvals), fids, -1), fvals, all_idx

    def _ivf_shard(self, sh: IndexShard, q: torch.Tensor):
        """One shard's ANN list: its probed clusters' tiles through K3/K4
        (the dynamic form: the real-slot count rides in the table's
        trailing slot), permuted rows mapped to local then global ids.
        Spilled layouts fetch 2 * k_local and dedup per shard."""
        iv = sh.ivf
        npl = iv.perm.shape[0]
        mt = self.ivf_max_tiles or min(
            npl // iv.tile_n, q.shape[0] * self.nprobe * iv.max_cluster_tiles)
        table, _ = build_tile_table(
            iv.centroids, iv.cluster_start, q,
            nprobe=min(self.nprobe, iv.n_clusters), max_tiles=mt,
            tile_n=iv.tile_n, mct=iv.max_cluster_tiles)
        table = torch.cat([table, sh.ivf_real_slot])
        k_ivf = 2 * self.k_local if iv.spilled else self.k_local
        if iv.emb is not None:
            vals, pidx = ivf_dense_top_k(iv.emb, q, table, k_ivf,
                                         tile_n=iv.tile_n, n_real=0)
        else:
            qv, qs = quantize_queries(q)
            vals, pidx = ivf_dense_top_k_int8(iv.values, iv.scales, qv, qs,
                                              table, k_ivf, tile_n=iv.tile_n,
                                              n_real=0)
        lidx = torch.where(pidx >= 0,
                           iv.perm[pidx.clamp(0, npl - 1).long()], -1)
        if iv.spilled:
            vals, lidx = dedup_ranked(vals, lidx)
            vals, lidx = vals[:, :self.k_local], lidx[:, :self.k_local]
        gidx = _local_to_global(vals, lidx, sh.offset)
        return torch.where(gidx >= 0, vals, float("-inf")), gidx

    def _bm25_shard(self, sh: IndexShard, terms: torch.Tensor,
                    mask: Optional[torch.Tensor]):
        """One shard's BM25 list (global ids)."""
        kl, budget = self.k_local, self.budget
        t_slots = terms.shape[1]
        cap = self._df_cap
        df_cap = (cap if cap is not None and t_slots * cap <= 4 * budget
                  and t_slots * cap >= kl else None)
        if self.use_two_tier and self.tt_streaming:
            vals, lidx = bm25_top_k_two_tier(sh.two_tier, terms, kl,
                                             mask=mask, budget=budget,
                                             df_cap=df_cap)
        elif self.use_two_tier:
            return _local_to_global_topk(
                bm25_scores_two_tier(sh.two_tier, terms, budget), kl,
                sh.offset, mask)
        else:
            # Sort-based sparse top-k: no [n_local] accumulator, cost set
            # by the postings budget (window fetch where df allows).
            vals, lidx = bm25_top_k_sparse(sh.bm25, terms, kl, mask=mask,
                                           budget=budget, df_cap=df_cap)
        return vals, _local_to_global(vals, lidx, sh.offset)


def reshard_surviving(sidx: ShardedIndex, slots, dp: int = 1) -> ShardedIndex:
    """Failure recovery: lay the base index out again over the surviving
    slots (or devices).

    The base index stays whole on its device, so losing slots loses no
    data: recovery re-shards the document axis over fewer slots, with the
    same results. The new layout keeps the two-tier BM25 settings, the
    host axis where the survivors still factor over the hosts (else one
    flat corpus axis), and the per-shard IVF with its spill settings
    (clustered again over the new shard boundaries).
    """
    slots = as_slots(list(slots))
    host_axis = sidx.host_axis
    n_hosts = sidx.mesh.shape[host_axis] if host_axis is not None else 1
    if host_axis is not None and len(slots) % (dp * n_hosts) == 0:
        mesh = DeviceMesh(slots, (dp, n_hosts, len(slots) // (dp * n_hosts)),
                          (sidx.data_axis, host_axis, sidx.corpus_axis))
    else:
        host_axis = None
        mesh = DeviceMesh(slots, (dp, len(slots) // dp),
                          (sidx.data_axis, sidx.corpus_axis))
    out = shard_index(
        sidx.base_index, mesh, sidx.corpus_axis, sidx.data_axis,
        two_tier_common=sidx.two_tier_common,
        two_tier_dtype=sidx.two_tier_dtype, host_axis=host_axis,
    )
    if sidx.ivf_model is not None:
        out = shard_ivf(out, sidx.ivf_model, tile_n=sidx.ivf_tile_n,
                        spill=sidx.ivf_spilled,
                        spill_margin=sidx.ivf_spill_margin)
    return out


def sharded_dense_top_k(
    sidx: ShardedIndex,
    model_name: str,
    queries,
    k: int,
    filename_type_filter: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global dense top-k over the sharded corpus: (values [B, k'],
    global ids [B, k']) on the lead device, k' = min(k, S * n_local).
    Each shard takes ShardedRetriever's "auto" route (K1 / K2 on CUDA
    from KERNEL_THRESHOLD rows a shard)."""
    q = _as_f32(queries)
    q = q[None] if q.ndim == 1 else q
    k_local = min(k, sidx.n_local)
    use_kernel = FusedRetriever._route_kernel("auto", sidx.n_local,
                                              k_local, sidx.lead.type)
    masks = sidx.filter_mask(filename_type_filter)
    outs = []
    for g, rep, rows in _groups(sidx, q.shape[0]):
        vals, gidx = [], []
        for s, sh in enumerate(rep):
            with _on(sh.device):
                v, i = _dense_shard(sh, sh.dense[model_name],
                                    q[rows].to(sh.device), masks[g][s],
                                    k_local, use_kernel)
            vals.append(v)
            gidx.append(i)
        v, i = _merge_over(sidx, vals, gidx, k, rep[0].device)
        outs.append((v.to(sidx.lead), i.to(sidx.lead)))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def sharded_hybrid_retrieve(
    sidx: ShardedIndex,
    q_embs: Dict[str, np.ndarray],
    q_terms: Optional[np.ndarray],
    weights: Dict[str, float],
    similarity_k: int = 25,
    common_sections_n: int = 15,
    wrrf_k: float = 40.0,
    filename_type_filter: Optional[str] = None,
    budget: int = 16384,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot functional wrapper around :class:`ShardedRetriever`;
    returns (fused scores, fused ids) as host arrays."""
    retr = ShardedRetriever(
        sidx, [m for m in q_embs if m in sidx.dense_model_names],
        use_bm25=q_terms is not None and sidx.shards[0].bm25 is not None,
        similarity_k=similarity_k, common_sections_n=common_sections_n,
        budget=budget,
    )
    return retr(q_embs, q_terms, weights, filename_type_filter, wrrf_k)
