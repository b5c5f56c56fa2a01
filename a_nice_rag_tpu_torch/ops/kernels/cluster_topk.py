"""The cluster kernel for Hopper (``csrc/cluster_topk.cu``): K2r, K1r and
K1c on one kernel, its launch plan and its launchers.

K2r, the rounded int8 top-k (the JAX package's ``_kernel_packed_int8``,
fused_topk.py:377), K1r, the rounded float top-k on bf16 rows
(``_kernel_packed``, :359), and K1c, the bf16 compare fold on bf16 rows
(``_kernel_iterate(compare_dtype="bfloat16")``, :921), are called through
``fused_topk.fused_dense_top_k_int8_rounded``,
``fused_dense_top_k_rounded`` and ``fused_dense_top_k_bf16_compare``,
which route, count their launches and run the plain versions on the CPU;
this module launches the kernel on CUDA tensors and holds the plan that
both the launchers and the CPU tests read.

The rows are the kernel's compile-time ``kind``: "int8" (K2r: int8 rows
with per-row scales, one int8 query plane, wgmma s8), "rounded" (K1r:
bf16 rows against the f32 query's three bf16 planes, wgmma bf16) and
"compare" (K1c: bf16 rows against one plane, bf16(q)); "int8_exact" and
"exact" select on K2's and K1's unrounded scores, for the probes of this
design (``cluster_probe.py``, ``csrc/cluster_probe.cu``).

``cluster_plan`` gives a call's launch: the CTAs of a thread-block cluster
(query blocks of ``64 * qg`` queries that share one TMA-multicast doc
stream), the groups of clusters side by side (B past four blocks), the
clusters per group (persistent walkers over the doc tiles, as many as the
card holds), TMA or the producer warp's element loads, the query planes
resident or streamed through the ring (int8 only: bf16 rows run with
their planes resident), the ring slots and the shared memory, for the
main pass, the tau pass (every ``TAU_STRIDE``-th row) and the seed pass
that seeds it (every ``SEED_STRIDE``-th). ``cluster_smem_bytes`` is the
source's ``smem_bytes`` (``counted``: with the counted probe's
counters).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build

# csrc/cluster_topk.cu's constants: queries and docs a warpgroup
# multiplies, bytes of depth per ring chunk, rows per TMA box, CTAs per
# cluster, ring slots, k, the alignment slack, a CTA's shared memory on an
# H100; TAU_STRIDE is topk_common.cuh's.
QUERY_GROUP = 64
WARPGROUP_DOCS = 128
CHUNK_BYTES = 128
BOX_ROWS = 64
MAX_CLUSTER = 4
MAX_STAGES = 6
K_MAX = 128
_ALIGN = 1024
SMEM_LIMIT = 232_448
TAU_STRIDE = 64
SEED_STRIDE = TAU_STRIDE * TAU_STRIDE
H100_SMS = 132
QUERY_GROUPS = (1, 2)
# The rows (the source's RowKind), their element bytes and query planes;
# the kinds the folds launch (cluster_topk.cu), the others the probes'.
KINDS = {"int8": 0, "rounded": 1, "compare": 2, "int8_exact": 3, "exact": 4}
FOLD_KINDS = ("int8", "rounded", "compare")
ELEMENT_BYTES = {"int8": 1, "rounded": 2, "compare": 2, "int8_exact": 1,
                 "exact": 2}
PLANES = {"int8": 1, "rounded": 3, "compare": 1, "int8_exact": 1,
          "exact": 3}
# The counted probe's counters a row (the source's CLUSTER_COUNTERS).
CLUSTER_COUNTERS = 5

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _library() -> ctypes.CDLL:
    lib = _build.load("cluster_topk")
    if not hasattr(lib, "_anr_bound"):
        # q, q scales, e, scales; B N D k qg cl groups stages resident smem
        # tma walkers tau_tma tau_walkers seed_tma seed_walkers; workspace,
        # out_v, out_i, stream.
        lib.anr_cluster_topk.argtypes = [_P] * 4 + [_I] * 16 + [_P] * 4
        # kind; q, e, mask; B N D k qg cl groups stages resident smem tma
        # walkers tau_tma tau_walkers seed_tma seed_walkers; workspace,
        # out_v, out_i, stream.
        lib.anr_cluster_topk_bf16.argtypes = [_I] + [_P] * 3 + [_I] * 16 \
            + [_P] * 4
        lib.anr_cluster_active_clusters.argtypes = [_I] * 4
        for fn in (lib.anr_cluster_topk, lib.anr_cluster_topk_bf16,
                   lib.anr_cluster_active_clusters):
            fn.restype = _I
        lib.anr_cluster_smem_bytes.argtypes = [_I] * 7
        lib.anr_cluster_workspace_bytes.argtypes = [_I] * 7
        for fn in (lib.anr_cluster_smem_bytes,
                   lib.anr_cluster_workspace_bytes):
            fn.restype = _LL
        lib._anr_bound = True
    return lib


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {tuple(KINDS)}, got {kind!r}")


def cta_queries(qg: int) -> int:
    return QUERY_GROUP * qg


def tile_docs(qg: int) -> int:
    """Docs a tile: 256 with one query group (the two warpgroups split
    them), 128 with two (each warpgroup its own 64 queries)."""
    return 2 * WARPGROUP_DOCS // qg


def row_bytes(d: int, kind: str = "int8") -> int:
    return d * ELEMENT_BYTES[kind]


def list_stride(k: int) -> int:
    """Entries from one row's running list to the next: k rounded up to
    an odd count (the source's ``list_stride``: the rows a warp offers to
    at once in distinct shared-memory banks)."""
    return k | 1


def cluster_smem_bytes(qg: int, d: int, k: int, stages: int,
                       resident: bool, kind: str = "int8",
                       counted: bool = False) -> int:
    """Dynamic shared memory of a CTA over rows ``kind``: alignment slack,
    ring slots (a doc chunk, plus the query planes' chunk when they are
    streamed), the resident query planes, two barriers a slot, two tiles'
    doc multipliers (4 bytes a doc), each row's published worst score and
    lock (8 bytes), each row's running list (8 bytes an entry,
    ``list_stride(k)`` entries) and, ``counted``, its ``CLUSTER_COUNTERS``
    counters (4 bytes each)."""
    _check_kind(kind)
    q, t, planes = cta_queries(qg), tile_docs(qg), PLANES[kind]
    nck = -(-row_bytes(d, kind) // CHUNK_BYTES)
    slot = t * CHUNK_BYTES + (0 if resident else planes * q * CHUNK_BYTES)
    qbytes = nck * planes * q * CHUNK_BYTES if resident else 0
    return (_ALIGN + stages * (slot + 16) + qbytes + 8 * t
            + q * (8 + 8 * list_stride(k))
            + (4 * CLUSTER_COUNTERS * q if counted else 0))


def _fits_resident(qg: int, d: int, k: int, kind: str,
                   counted: bool = False) -> bool:
    """The query planes stay resident where two ring slots fit beside
    them."""
    return cluster_smem_bytes(qg, d, k, 2, True, kind, counted) <= SMEM_LIMIT


def default_query_groups(b: int, d: int = 1, k: int = 1,
                         kind: str = "int8") -> int:
    """The CTA shape the card's measurements chose (PERF.md, K2r, K1r,
    K1c): one query block of 64 (qg = 1, both warpgroups on it) up to B =
    64, else 128 queries (qg = 2, a warpgroup each: no row shared between
    warps); bf16 rows take 128 only where their planes stay resident
    beside two ring slots (K1r's three planes at D = 256 do not: 64)."""
    if b <= QUERY_GROUP:
        return 1
    if ELEMENT_BYTES[kind] == 1 or _fits_resident(2, d, k, kind):
        return 2
    return 1


@functools.lru_cache(maxsize=256)
def _shape(b: int, d: int, k: int, qg: int, kind: str, counted: bool):
    """(cluster, groups, resident, stages, smem bytes): the part of the
    plan that depends neither on N nor on the card."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")
    if qg not in QUERY_GROUPS:
        raise ValueError(f"qg must be one of {QUERY_GROUPS}, got {qg}")
    blocks = -(-b // cta_queries(qg))
    groups = -(-blocks // MAX_CLUSTER)
    cl = -(-blocks // groups)
    resident = _fits_resident(qg, d, k, kind, counted)
    fixed = cluster_smem_bytes(qg, d, k, 0, resident, kind, counted)
    slot = cluster_smem_bytes(qg, d, k, 1, resident, kind, counted) - fixed
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // slot)
    if stages < 1:
        raise ValueError(f"D = {d}, k = {k} leave no room for a ring slot")
    return cl, groups, resident, stages, cluster_smem_bytes(
        qg, d, k, stages, resident, kind, counted)


class ClusterPlan(NamedTuple):
    """The launch of csrc/cluster_topk.cu for one call."""
    qg: int  # query groups of 64 a CTA (1: 64 queries, 2: 128)
    cluster: int  # CTAs (query blocks) a cluster; with tma, one doc stream
    groups: int  # clusters side by side over the query blocks
    walkers: int  # clusters a group, each walking every walkers-th tile
    tma: bool  # doc chunks through TMA multicast; else element loads
    resident: bool  # query planes resident; else streamed with each chunk
    stages: int  # ring slots
    smem_bytes: int
    tiles: int  # doc tiles of tile_docs(qg) rows
    tau_walkers: int  # the tau pass's (every TAU_STRIDE-th row)
    tau_tma: bool
    tau_tiles: int
    seed_walkers: int  # the seed pass's (every SEED_STRIDE-th row)
    seed_tma: bool
    seed_tiles: int

    @property
    def grid(self) -> Tuple[int, int]:
        return self.walkers * self.cluster, self.groups


def _tma(rows: int, rowb: int, aligned: bool, resident: bool) -> bool:
    return (aligned and resident and rowb % 16 == 0 and rowb >= CHUNK_BYTES
            and rows >= BOX_ROWS)


def cluster_plan(n: int, b: int, d: int, k: int, sms: int = H100_SMS,
                 aligned: bool = True, active_clusters: Optional[int] = None,
                 qg: Optional[int] = None, kind: str = "int8",
                 counted: bool = False) -> ClusterPlan:
    """The launch for N rows ``kind`` (one of ``KINDS``), B queries of
    depth D, top k (``counted``: the counted probe's, with its counters in
    shared memory). ``aligned``: the rows' base is 16-byte
    aligned; with rows of a multiple of 16 bytes, at least one 128-byte
    chunk deep, the query planes resident and a box of rows, the doc
    chunks go through TMA, else through the producer's element loads.
    ``active_clusters``: clusters of this shape the card holds at once
    (cudaOccupancyMaxActiveClusters); None, or without TMA: one CTA a SM,
    sms // cluster. ``qg``: query groups a CTA (default
    ``default_query_groups``). bf16 rows whose planes do not stay
    resident give a plan the launcher refuses (``resident`` False)."""
    _check_kind(kind)
    if n < 1 or b < 1 or d < 1:
        raise ValueError(f"need N, B, D >= 1, got {n}, {b}, {d}")
    qg = default_query_groups(b, d, k, kind) if qg is None else qg
    cl, groups, resident, stages, smem = _shape(b, d, k, qg, kind, counted)
    t, rowb = tile_docs(qg), row_bytes(d, kind)

    def walk(every: int) -> Tuple[int, bool, int]:
        rows = -(-n // every)
        tiles = -(-rows // t)
        tma = _tma(rows, rowb, aligned, resident)
        active = (active_clusters if tma and active_clusters is not None
                  else sms // cl)
        return max(1, min(tiles, active // groups)), tma, tiles

    w, tma, tiles = walk(1)
    return ClusterPlan(qg, cl, groups, w, tma, resident, stages, smem, tiles,
                       *walk(TAU_STRIDE), *walk(SEED_STRIDE))


def workspace_bytes(b: int, k: int, walkers: int, tau_walkers: int,
                    seed_walkers: int, d: int = 0,
                    kind: str = "int8") -> int:
    """A call's scratch as the source carves it: the main, tau and seed
    passes' lists [B][walkers][k] (values and ids), tau and the seed
    pass's tau [B], (three-plane kinds, K1r's and K1's) the query's three
    bf16 planes [3][B][D] and (bf16 rows) the tau and seed passes' top k
    [B][k] (values and ids), each piece rounded up to 256 bytes."""
    def up(nbytes: int) -> int:
        return -(-nbytes // 256) * 256
    pieces = 6 * b * d if PLANES[kind] == 3 else 0
    top = 0 if ELEMENT_BYTES[kind] == 1 else 4 * up(4 * b * k)
    return sum(2 * up(4 * b * w * k)
               for w in (walkers, tau_walkers, seed_walkers)) \
        + 2 * up(4 * b) + up(pieces) + top


def source_smem_bytes(qg: int, d: int, k: int, stages: int,
                      resident: bool, kind: str = "int8",
                      counted: bool = False) -> int:
    """``cluster_smem_bytes`` as csrc/cluster_topk.cuh computes it (builds
    the library)."""
    _check_kind(kind)
    return int(_library().anr_cluster_smem_bytes(
        KINDS[kind], qg, d, k, stages, int(resident), int(counted)))


def source_workspace_bytes(b: int, k: int, walkers: int, tau_walkers: int,
                           seed_walkers: int, d: int = 0,
                           kind: str = "int8") -> int:
    _check_kind(kind)
    return int(_library().anr_cluster_workspace_bytes(
        KINDS[kind], b, d, k, walkers, tau_walkers, seed_walkers))


@functools.lru_cache(maxsize=64)
def active_clusters(index: int, qg: int, cl: int, smem: int,
                    kind: str = "int8") -> int:
    """Clusters of ``cl`` CTAs of a fold over rows ``kind`` (one of
    ``FOLD_KINDS``) with ``smem`` bytes each that CUDA device ``index``
    holds at once (cudaOccupancyMaxActiveClusters)."""
    if kind not in FOLD_KINDS:
        raise ValueError(f"kind must be one of {FOLD_KINDS}, got {kind!r}")
    with torch.cuda.device(index):
        n = _library().anr_cluster_active_clusters(KINDS[kind], qg, cl, smem)
    if n < 1:
        raise RuntimeError(f"anr_cluster_active_clusters({kind!r}, {qg}, "
                           f"{cl}, {smem}) returned {n}")
    return n


def device_plan(values: torch.Tensor, b: int, k: int, sms: int,
                qg: Optional[int] = None, kind: str = "int8") -> ClusterPlan:
    """``cluster_plan`` for rows ``values`` [N, D] on their CUDA device,
    with the card's active clusters."""
    (n, d), dev = values.shape, values.device
    aligned = values.data_ptr() % 16 == 0
    plan = cluster_plan(n, b, d, k, sms, aligned, qg=qg, kind=kind)
    if plan.tma or plan.tau_tma or plan.seed_tma:
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        plan = cluster_plan(n, b, d, k, sms, aligned, active_clusters(
            index, plan.qg, plan.cluster, plan.smem_bytes, kind),
            qg=plan.qg, kind=kind)
    return plan


def _launch(fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with cudaError_t {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def rounded_top_k_int8(values: torch.Tensor, scales: torch.Tensor,
                       q_values: torch.Tensor, q_scales: torch.Tensor,
                       k: int, sms: int, qg: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2r on CUDA tensors the caller has checked (values [N, D] int8 rows
    of any base alignment, scales [N] f32, q_values [B, D] int8
    contiguous, q_scales [B] f32): the seed pass and the tau pass, each
    with the merge in its tau mode, the main pass and the merge. Raises if
    a launch fails."""
    (n, d), b, dev = values.shape, q_values.shape[0], values.device
    plan = device_plan(values, b, k, sms, qg)
    ws = torch.empty(workspace_bytes(b, k, plan.walkers, plan.tau_walkers,
                                     plan.seed_walkers),
                     dtype=torch.uint8, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    _launch(_library().anr_cluster_topk, q_values.data_ptr(),
            q_scales.data_ptr(), values.data_ptr(), scales.data_ptr(), b, n,
            d, k, plan.qg, plan.cluster, plan.groups, plan.stages,
            int(plan.resident), plan.smem_bytes, int(plan.tma), plan.walkers,
            int(plan.tau_tma), plan.tau_walkers, int(plan.seed_tma),
            plan.seed_walkers, ws.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), device=dev)
    return out_v, out_i


def _bf16_query(queries: torch.Tensor, kind: str) -> torch.Tensor:
    """What the kernel takes for ``kind``'s query: K1r the f32 query
    (split into its three bf16 planes on the card), K1c bf16(q) (a bf16
    query as it is, an f32 one rounded to nearest even)."""
    dtype = torch.float32 if kind == "rounded" else torch.bfloat16
    return queries.to(dtype).contiguous()


def bf16_top_k(emb: torch.Tensor, queries: torch.Tensor, k: int, sms: int,
               kind: str, mask: Optional[torch.Tensor] = None,
               qg: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1r (``kind`` "rounded") or K1c ("compare") on CUDA tensors the
    caller has checked (emb [N, D] bf16 rows of any base alignment,
    queries [B, D] f32 or bf16, mask an optional [N] bool): the seed pass
    and the tau pass, each with the merge in its tau mode, the main pass
    and the merge. ValueError where the query planes do not stay resident
    (K1's kernel takes those calls); raises if a launch fails."""
    if kind not in ("rounded", "compare"):
        raise ValueError(f"kind must be 'rounded' or 'compare', got {kind!r}")
    (n, d), b, dev = emb.shape, queries.shape[0], emb.device
    plan = device_plan(emb, b, k, sms, qg, kind)
    if not plan.resident:
        raise ValueError(f"the {kind} fold's query planes at B = {b}, D = "
                         f"{d}, k = {k} do not stay resident in a CTA")
    q = _bf16_query(queries, kind)
    ws = torch.empty(workspace_bytes(b, k, plan.walkers, plan.tau_walkers,
                                     plan.seed_walkers, d, kind),
                     dtype=torch.uint8, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    _launch(_library().anr_cluster_topk_bf16, KINDS[kind], q.data_ptr(),
            emb.data_ptr(), _ptr(mask), b, n, d, k, plan.qg, plan.cluster,
            plan.groups, plan.stages, int(plan.resident), plan.smem_bytes,
            int(plan.tma), plan.walkers, int(plan.tau_tma), plan.tau_walkers,
            int(plan.seed_tma), plan.seed_walkers, ws.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), device=dev)
    return out_v, out_i
