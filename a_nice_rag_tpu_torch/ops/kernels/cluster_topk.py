"""K2r's kernel for Hopper (``csrc/cluster_topk.cu``): its launch plan and
its launcher.

K2r, the rounded int8 top-k (the JAX package's ``_kernel_packed_int8``,
fused_topk.py:377), is called through ``fused_topk.
fused_dense_top_k_int8_rounded``, which counts its launches and runs the
plain version on the CPU; this module launches the kernel on CUDA tensors
and holds the plan that both the launcher and the CPU tests read.

``cluster_plan`` gives a call's launch: the CTAs of a thread-block cluster
(query blocks of ``64 * qg`` queries that share one TMA-multicast doc
stream), the groups of clusters side by side (B past four blocks), the
clusters per group (persistent walkers over the doc tiles, as many as the
card holds), TMA or the producer warp's element loads, the query block
resident or streamed through the ring, the ring slots and the shared
memory, for the main pass, the tau pass (every ``TAU_STRIDE``-th row)
and the seed pass that seeds it (every ``SEED_STRIDE``-th).
``cluster_smem_bytes`` is the source's ``smem_bytes``.
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
# The anatomy's modes (the source's Mode): the whole pass, the ring alone,
# + the multiply, + the epilogue's threshold test.
MODES = {"full": 0, "stream": 1, "mma": 2, "epilogue": 3}

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
        # mode, q, e, scales, seed; B N D k qg cl groups stages resident
        # smem tma walkers tau; part_v, part_i, probe, stream.
        lib.anr_cluster_pass.argtypes = [_I] + [_P] * 4 + [_I] * 13 \
            + [_P] * 4
        lib.anr_cluster_active_clusters.argtypes = [_I] * 3
        for fn in (lib.anr_cluster_topk, lib.anr_cluster_pass,
                   lib.anr_cluster_active_clusters):
            fn.restype = _I
        lib.anr_cluster_smem_bytes.argtypes = [_I] * 5
        lib.anr_cluster_workspace_bytes.argtypes = [_I] * 5
        for fn in (lib.anr_cluster_smem_bytes,
                   lib.anr_cluster_workspace_bytes):
            fn.restype = _LL
        lib._anr_bound = True
    return lib


def cta_queries(qg: int) -> int:
    return QUERY_GROUP * qg


def tile_docs(qg: int) -> int:
    """Docs a tile: 256 with one query group (the two warpgroups split
    them), 128 with two (each warpgroup its own 64 queries)."""
    return 2 * WARPGROUP_DOCS // qg


def cluster_smem_bytes(qg: int, d: int, k: int, stages: int,
                       resident: bool) -> int:
    """Dynamic shared memory of a K2r CTA: alignment slack, ring slots
    (a doc chunk, plus the query chunk when the query block is streamed),
    the resident query block, two barriers a slot, two tiles' doc scales
    (4 bytes a doc), each row's published worst score and lock (8 bytes),
    each row's running list (8 bytes an entry)."""
    q, t = cta_queries(qg), tile_docs(qg)
    nck = -(-d // CHUNK_BYTES)
    slot = t * CHUNK_BYTES + (0 if resident else q * CHUNK_BYTES)
    qbytes = nck * q * CHUNK_BYTES if resident else 0
    return (_ALIGN + stages * (slot + 16) + qbytes + 8 * t
            + q * (8 + 8 * k))


def default_query_groups(b: int) -> int:
    """The CTA shape the card's measurements chose (PERF.md, K2r): one
    query block of 64 (qg = 1, both warpgroups on it) up to B = 64, else
    128 queries (qg = 2, a warpgroup each: no row shared between warps)."""
    return 1 if b <= QUERY_GROUP else 2


@functools.lru_cache(maxsize=256)
def _shape(b: int, d: int, k: int, qg: int):
    """(cluster, groups, resident, stages, smem bytes): the part of the
    plan that depends neither on N nor on the card."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")
    if qg not in QUERY_GROUPS:
        raise ValueError(f"qg must be one of {QUERY_GROUPS}, got {qg}")
    blocks = -(-b // cta_queries(qg))
    groups = -(-blocks // MAX_CLUSTER)
    cl = -(-blocks // groups)
    resident = cluster_smem_bytes(qg, d, k, 2, True) <= SMEM_LIMIT
    fixed = cluster_smem_bytes(qg, d, k, 0, resident)
    slot = cluster_smem_bytes(qg, d, k, 1, resident) - fixed
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // slot)
    if stages < 1:
        raise ValueError(f"D = {d}, k = {k} leave no room for a ring slot")
    return cl, groups, resident, stages, cluster_smem_bytes(
        qg, d, k, stages, resident)


class ClusterPlan(NamedTuple):
    """The launch of csrc/cluster_topk.cu for one call."""
    qg: int  # query groups of 64 a CTA (1: 64 queries, 2: 128)
    cluster: int  # CTAs (query blocks) a cluster; with tma, one doc stream
    groups: int  # clusters side by side over the query blocks
    walkers: int  # clusters a group, each walking every walkers-th tile
    tma: bool  # doc chunks through TMA multicast; else element loads
    resident: bool  # query block resident; else streamed with each chunk
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


def _tma(rows: int, d: int, aligned: bool, resident: bool) -> bool:
    return (aligned and resident and d % 16 == 0 and d >= CHUNK_BYTES
            and rows >= BOX_ROWS)


def cluster_plan(n: int, b: int, d: int, k: int, sms: int = H100_SMS,
                 aligned: bool = True, active_clusters: Optional[int] = None,
                 qg: Optional[int] = None) -> ClusterPlan:
    """K2r's launch for N rows, B queries of depth D, top k. ``aligned``:
    the rows' base is 16-byte aligned; with D a multiple of 16, at least
    one chunk deep, the query block resident and a box of rows, the doc
    chunks go through TMA, else through the producer's element loads.
    ``active_clusters``: clusters of this shape the card holds at once
    (cudaOccupancyMaxActiveClusters); None, or without TMA: one CTA a SM,
    sms // cluster. ``qg``: query groups a CTA (default
    ``default_query_groups(b)``)."""
    if n < 1 or b < 1 or d < 1:
        raise ValueError(f"need N, B, D >= 1, got {n}, {b}, {d}")
    qg = default_query_groups(b) if qg is None else qg
    cl, groups, resident, stages, smem = _shape(b, d, k, qg)
    t = tile_docs(qg)

    def walk(every: int) -> Tuple[int, bool, int]:
        rows = -(-n // every)
        tiles = -(-rows // t)
        tma = _tma(rows, d, aligned, resident)
        active = (active_clusters if tma and active_clusters is not None
                  else sms // cl)
        return max(1, min(tiles, active // groups)), tma, tiles

    w, tma, tiles = walk(1)
    return ClusterPlan(qg, cl, groups, w, tma, resident, stages, smem, tiles,
                       *walk(TAU_STRIDE), *walk(SEED_STRIDE))


def workspace_bytes(b: int, k: int, walkers: int, tau_walkers: int,
                    seed_walkers: int) -> int:
    """A call's scratch as the source carves it: the main, tau and seed
    passes' lists [B][walkers][k] (values and ids), tau and the seed
    pass's tau [B], each piece rounded up to 256 bytes."""
    def up(nbytes: int) -> int:
        return -(-nbytes // 256) * 256
    return sum(2 * up(4 * b * w * k)
               for w in (walkers, tau_walkers, seed_walkers)) + 2 * up(4 * b)


def source_smem_bytes(qg: int, d: int, k: int, stages: int,
                      resident: bool) -> int:
    """``cluster_smem_bytes`` as csrc/cluster_topk.cu computes it (builds
    the library)."""
    return int(_library().anr_cluster_smem_bytes(qg, d, k, stages,
                                                 int(resident)))


def source_workspace_bytes(b: int, k: int, walkers: int, tau_walkers: int,
                           seed_walkers: int) -> int:
    return int(_library().anr_cluster_workspace_bytes(
        b, k, walkers, tau_walkers, seed_walkers))


@functools.lru_cache(maxsize=64)
def active_clusters(index: int, qg: int, cl: int, smem: int) -> int:
    """Clusters of ``cl`` K2r CTAs with ``smem`` bytes each that CUDA
    device ``index`` holds at once (cudaOccupancyMaxActiveClusters)."""
    with torch.cuda.device(index):
        n = _library().anr_cluster_active_clusters(qg, cl, smem)
    if n < 1:
        raise RuntimeError(f"anr_cluster_active_clusters({qg}, {cl}, "
                           f"{smem}) returned {n}")
    return n


def device_plan(values: torch.Tensor, b: int, k: int, sms: int,
                qg: Optional[int] = None) -> ClusterPlan:
    """``cluster_plan`` for rows ``values`` [N, D] on their CUDA device,
    with the card's active clusters."""
    (n, d), dev = values.shape, values.device
    aligned = values.data_ptr() % 16 == 0
    plan = cluster_plan(n, b, d, k, sms, aligned, qg=qg)
    if plan.tma or plan.tau_tma or plan.seed_tma:
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        plan = cluster_plan(n, b, d, k, sms, aligned, active_clusters(
            index, plan.qg, plan.cluster, plan.smem_bytes), qg=plan.qg)
    return plan


def _launch(fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with cudaError_t {err}")


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


def cluster_pass(mode: str, values: torch.Tensor, scales: torch.Tensor,
                 q_values: torch.Tensor, k: int, sms: int,
                 seed: Optional[torch.Tensor] = None,
                 qg: Optional[int] = None, tau: bool = False):
    """One pass of K2r's kernel alone, for the probe's anatomy (CUDA
    tensors, the TMA route; no merge): the main pass, or (``tau``) the tau
    pass over every TAU_STRIDE-th row. ``mode``: "stream" (the ring
    alone), "mma" (+ the multiply), "epilogue" (+ the threshold test of
    every score against its row's bound from ``seed`` [B], nothing
    offered: returns the int32 count of a thread's tiles where a score
    passed it) or "full" (the pass, lists seeded with ``seed`` or -inf:
    returns the walkers' lists [B, walkers, k])."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    (n, d), b, dev = values.shape, q_values.shape[0], values.device
    plan = device_plan(values, b, k, sms, qg)
    if not (plan.tau_tma if tau else plan.tma):
        raise ValueError("the anatomy runs on the TMA route")
    walkers = plan.tau_walkers if tau else plan.walkers
    part_v = part_i = probe = None
    if mode == "full":
        part_v = torch.empty((b, walkers, k), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((b, walkers, k), dtype=torch.int32,
                             device=dev)
    if mode == "epilogue":
        probe = torch.zeros(1, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _launch(_library().anr_cluster_pass, MODES[mode], q_values.data_ptr(),
            values.data_ptr(), scales.data_ptr(), ptr(seed), b, n, d, k,
            plan.qg, plan.cluster, plan.groups, plan.stages,
            int(plan.resident), plan.smem_bytes, 1, walkers, int(tau),
            ptr(part_v), ptr(part_i), ptr(probe), device=dev)
    if mode == "full":
        return part_v, part_i
    return probe
