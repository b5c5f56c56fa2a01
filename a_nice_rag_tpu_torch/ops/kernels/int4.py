"""int4-packed dense scoring: CUDA kernels and plain versions.

Replaces the TPU kernels of ``scripts/probe_int4.py`` (:83, :167, :188,
:243, :261), all in ``csrc/int4.cu``:

- ``int4_scores(q8, packed)``: the exact int32 product [B, N] of int8
  queries [B, D] and int4 rows packed two to a byte [N, D/2] (stage 1's
  ``_score_kernel`` with either unpack, and stage 3's two kernels, which
  compute the same product). ``unpack`` picks the kernel's per-byte sign
  extension: "mask" ((n ^ 8) - 8, probe :53) or "shift" (arithmetic
  shifts, probe :47); both are exact.
- ``int8_fold_max(q8, e8)`` and ``int4_fold_max(q8, packed)``: stage 2's
  stripped kernels, the stream + (unpack) + dot + a running max per row:
  int32 [B], the row's best exact product.

Layout (``pack_int4``, probe :36): byte j of a packed row holds column j
in its low nibble and column j + D/2 in its high nibble. D % 8 == 0 for
packed rows, D % 4 == 0 for int8 rows. On CUDA tensors each wrapper
launches its kernel or raises; it takes its plain PyTorch version only for
tensors on the CPU. ``.launches`` counts kernel launches.

All three launch one kernel template (``anr_fold``): a CTA per block of 64
queries, the blocks of a call in one thread-block cluster that reads each
doc tile from HBM once (TMA multicast) and multiplies on the int8 tensor
cores; ``fold_plan`` gives its launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    H100_SMS,
    _I,
    _P,
    _check,
    _launch,
    _sm_count,
)
from a_nice_rag_tpu_torch.ops.quantized import int8_dot

UNPACKS = ("mask", "shift")
# csrc/int4.cu's constants: documents per tile (FT), queries per CTA (FQ),
# bytes of depth per ring chunk (CH), ring slots, CTAs per cluster, rows
# per TMA box, the alignment slack, a CTA's shared memory on an H100.
TILE_DOCS = 256
BLOCK_Q = 64
CHUNK_BYTES = 128
MAX_STAGES = 6
MAX_CLUSTER = 4
_BOX_ROWS = 64
_ALIGN = 1024
SMEM_LIMIT = 232_448
_KIND_INT8 = 0
_KIND_FOLD = {"mask": 1, "shift": 2}
_KIND_SCORES = {"mask": 3, "shift": 4}
_INT32_MIN = -(2**31)
# Plain versions unpack and multiply at most this many documents at once.
_PLAIN_CHUNK_ROWS = 1 << 18


def _library() -> ctypes.CDLL:
    lib = _build.load("int4")
    if not hasattr(lib, "_anr_bound"):
        # kind, q, e, B N D stages resident tma cl groups per_group smem
        # mode, out, stream.
        lib.anr_fold.argtypes = [_I, _P, _P] + [_I] * 11 + [_P, _P]
        lib.anr_fold_active_clusters.argtypes = [_I, _I]
        lib.anr_fold_smem_bytes.argtypes = [_I] * 4
        for fn in (lib.anr_fold, lib.anr_fold_active_clusters,
                   lib.anr_fold_smem_bytes):
            fn.restype = _I
        lib._anr_bound = True
    return lib


def pack_int4(e4: torch.Tensor) -> torch.Tensor:
    """[N, D] int8 holding values in [-8, 7] -> [N, D/2] packed bytes."""
    if e4.dtype != torch.int8 or e4.ndim != 2 or e4.shape[1] % 2:
        raise ValueError(f"need int8 [N, D] with D even, got {e4.dtype} "
                         f"{tuple(e4.shape)}")
    half = e4.shape[1] // 2
    lo = e4[:, :half].to(torch.int32) & 0xF
    hi = e4[:, half:].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, D/2] packed bytes -> [N, D] int8 in [-8, 7]: each nibble
    sign-extended within its byte."""
    p = packed.to(torch.int32)  # sign-extends the byte
    lo = ((p & 15) ^ 8) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def _check_q(q8: torch.Tensor, d: int, dev: torch.device) -> None:
    if q8.shape[0] < 1:
        raise ValueError(f"need q8 [B, D] with B >= 1, got {tuple(q8.shape)}")
    _check(q8, "q8", (torch.int8,), (q8.shape[0], d), dev)


def _check_packed(q8: torch.Tensor, packed: torch.Tensor):
    if packed.ndim != 2 or q8.ndim != 2 \
            or q8.shape[1] != 2 * packed.shape[1]:
        raise ValueError(f"need q8 [B, D] and packed [N, D/2], got "
                         f"{tuple(q8.shape)} and {tuple(packed.shape)}")
    (n, half), d, dev = packed.shape, q8.shape[1], packed.device
    if d % 8 or n < 1:
        raise ValueError(f"need D % 8 == 0 and N >= 1, got D = {d}, N = {n}")
    _check(packed, "packed", (torch.int8,), (n, half), dev)
    _check_q(q8, d, dev)
    return n, d, q8.shape[0], dev


def _check_int8(q8: torch.Tensor, e8: torch.Tensor):
    if e8.ndim != 2 or q8.ndim != 2 or q8.shape[1] != e8.shape[1]:
        raise ValueError(f"need q8 [B, D] and e8 [N, D], got "
                         f"{tuple(q8.shape)} and {tuple(e8.shape)}")
    (n, d), dev = e8.shape, e8.device
    if d % 4 or n < 1:
        raise ValueError(f"need D % 4 == 0 and N >= 1, got D = {d}, N = {n}")
    _check(e8, "e8", (torch.int8,), (n, d), dev)
    _check_q(q8, d, dev)
    return n, d, q8.shape[0], dev


def _check_unpack(unpack: str) -> None:
    if unpack not in UNPACKS:
        raise ValueError(f"unpack must be one of {UNPACKS}, got {unpack!r}")


def _aligned(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 4:
            raise ValueError("rows must start 4-byte aligned")


def int4_scores_torch(q8: torch.Tensor, packed: torch.Tensor,
                      unpack: str = "mask") -> torch.Tensor:
    """Plain version of ``int4_scores`` (one unpack serves both)."""
    _check_unpack(unpack)
    n = _check_packed(q8, packed)[0]
    return torch.cat([int8_dot(q8, unpack_int4(packed[s0:s0 +
                                                      _PLAIN_CHUNK_ROWS]))
                      for s0 in range(0, n, _PLAIN_CHUNK_ROWS)], dim=1)


def _fold_max_torch(q8: torch.Tensor, rows, n: int) -> torch.Tensor:
    best = None
    for s0 in range(0, n, _PLAIN_CHUNK_ROWS):
        m = int8_dot(q8, rows(s0, s0 + _PLAIN_CHUNK_ROWS)).amax(dim=1)
        best = m if best is None else torch.maximum(best, m)
    return best


def int4_fold_max_torch(q8: torch.Tensor, packed: torch.Tensor,
                        unpack: str = "mask") -> torch.Tensor:
    """Plain version of ``int4_fold_max``."""
    _check_unpack(unpack)
    n = _check_packed(q8, packed)[0]
    return _fold_max_torch(q8, lambda s0, s1: unpack_int4(packed[s0:s1]), n)


def int8_fold_max_torch(q8: torch.Tensor, e8: torch.Tensor) -> torch.Tensor:
    """Plain version of ``int8_fold_max``."""
    n = _check_int8(q8, e8)[0]
    return _fold_max_torch(q8, lambda s0, s1: e8[s0:s1], n)


@functools.lru_cache(maxsize=256)
def _fold_shape(b: int, d: int, packed: bool):
    """(query blocks per cluster, groups, resident, stages, smem bytes)
    for B queries of depth D: fold_plan's part that does not depend on N
    or the card."""
    blocks = -(-b // BLOCK_Q)
    groups = -(-blocks // MAX_CLUSTER)
    cl = -(-blocks // groups)
    resident = fold_smem_bytes(d, packed, 2, True) <= SMEM_LIMIT
    fixed = fold_smem_bytes(d, packed, 0, resident)
    slot = fold_smem_bytes(d, packed, 1, resident) - fixed
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // slot)
    if stages < 1:
        raise ValueError(f"D = {d} leaves no room for a ring slot")
    return cl, groups, resident, stages, fold_smem_bytes(d, packed, stages,
                                                         resident)


def fold_smem_bytes(d: int, packed: bool, stages: int,
                    resident: bool) -> int:
    """Dynamic shared memory of csrc/int4.cu's fold_kernel: alignment
    slack, ring slots (docs, plus the query chunks when the query block is
    not resident), the resident query block, packed rows' unpacked tiles
    (lo and hi of each warpgroup's 128 docs), two barriers per slot."""
    erow = d // 2 if packed else d
    halves = 2 if packed else 1
    nck = -(-erow // CHUNK_BYTES)
    slot = TILE_DOCS * CHUNK_BYTES + (0 if resident else
                                      halves * BLOCK_Q * CHUNK_BYTES)
    qbytes = halves * nck * BLOCK_Q * CHUNK_BYTES if resident else 0
    unpacked = 2 * TILE_DOCS * CHUNK_BYTES if packed else 0
    return _ALIGN + stages * (slot + 16) + qbytes + unpacked


class FoldPlan(NamedTuple):
    """The launch of csrc/int4.cu's fold_kernel for one call."""
    # Query blocks (CTAs) per group; with tma, one thread-block cluster
    # that shares one doc stream.
    cluster: int
    groups: int  # clusters side by side over the query blocks (B > 256)
    per_group: int  # clusters per group, each walking every per_group-th tile
    tma: bool  # doc chunks through TMA multicast; else the producer's loads
    resident: bool  # query block resident; else streamed with each chunk
    stages: int  # ring slots
    smem_bytes: int
    tiles: int  # doc tiles of TILE_DOCS rows

    @property
    def grid(self) -> Tuple[int, int]:
        return self.per_group * self.cluster, self.groups


def fold_plan(n: int, b: int, d: int, packed: bool, sms: int = H100_SMS,
              aligned: bool = True,
              active_clusters: Optional[int] = None) -> FoldPlan:
    """The fold kernels' launch for N rows, B queries of depth D (packed:
    int4 rows of D / 2 bytes). ``aligned``: the rows' base is 16-byte
    aligned; with row bytes a multiple of 16 (and at least one chunk) the
    doc chunks go through TMA, else through the producer's loads.
    ``active_clusters``: clusters of this shape the card holds at once
    (cudaOccupancyMaxActiveClusters); None, or without TMA: one CTA per
    SM, sms // cluster."""
    cl, groups, resident, stages, smem = _fold_shape(b, d, packed)
    erow = d // 2 if packed else d
    tma = (aligned and resident and erow % 16 == 0 and erow >= CHUNK_BYTES
           and n >= _BOX_ROWS)
    if not tma or active_clusters is None:
        active_clusters = sms // cl
    tiles = -(-n // TILE_DOCS)
    per_group = max(1, min(tiles, active_clusters // groups))
    return FoldPlan(cl, groups, per_group, tma, resident, stages, smem,
                    tiles)


def source_smem_bytes(d: int, packed: bool, stages: int,
                      resident: bool) -> int:
    """``fold_smem_bytes`` as csrc/int4.cu computes it (builds the
    library)."""
    return _library().anr_fold_smem_bytes(d, int(packed), stages,
                                          int(resident))


@functools.lru_cache(maxsize=64)
def active_clusters(index: int, cl: int, smem: int) -> int:
    """Clusters of ``cl`` fold CTAs with ``smem`` bytes each that CUDA
    device ``index`` holds at once (cudaOccupancyMaxActiveClusters)."""
    with torch.cuda.device(index):
        n = _library().anr_fold_active_clusters(cl, smem)
    if n < 1:
        raise RuntimeError(f"anr_fold_active_clusters({cl}, {smem}) "
                           f"returned {n}")
    return n


def _fold(kind: int, q8: torch.Tensor, e: torch.Tensor, n: int, d: int,
          b: int, dev: torch.device, packed: bool, out: torch.Tensor,
          mode: int = 0) -> torch.Tensor:
    _aligned(q8, e)
    sms, aligned = _sm_count(dev), e.data_ptr() % 16 == 0
    plan = fold_plan(n, b, d, packed, sms, aligned)
    if plan.tma:
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        plan = fold_plan(n, b, d, packed, sms, aligned, active_clusters(
            index, plan.cluster, plan.smem_bytes))
    with torch.cuda.device(dev):
        _launch(_library().anr_fold, kind, q8.data_ptr(), e.data_ptr(), b, n,
                d, plan.stages, int(plan.resident), int(plan.tma),
                plan.cluster, plan.groups, plan.per_group, plan.smem_bytes,
                mode, out.data_ptr(), device=dev)
    return out


def fold_stream(q8: torch.Tensor, rows: torch.Tensor, packed: bool) -> None:
    """The fold kernel's stream alone (MODE_STAGE: the same launch and
    ring, each chunk handed back unread): the probe's anatomy. CUDA
    only; computes nothing."""
    if packed:
        n, d, b, dev = _check_packed(q8, rows)
    else:
        n, d, b, dev = _check_int8(q8, rows)
    if dev.type != "cuda":
        raise ValueError(f"fold_stream runs on a CUDA device, not {dev}")
    out = torch.full((b,), _INT32_MIN, dtype=torch.int32, device=dev)
    _fold(_KIND_FOLD["mask"] if packed else _KIND_INT8, q8, rows, n, d, b,
          dev, packed, out, mode=1)


def int4_scores(q8: torch.Tensor, packed: torch.Tensor,
                unpack: str = "mask") -> torch.Tensor:
    """The exact int32 [B, N] product of q8 [B, D] and packed [N, D/2]."""
    _check_unpack(unpack)
    n, d, b, dev = _check_packed(q8, packed)
    if dev.type == "cpu":
        return int4_scores_torch(q8, packed, unpack)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    _fold(_KIND_SCORES[unpack], q8, packed, n, d, b, dev, True, out)
    int4_scores.launches += 1
    return out


int4_scores.launches = 0


def int4_fold_max(q8: torch.Tensor, packed: torch.Tensor,
                  unpack: str = "mask") -> torch.Tensor:
    """int32 [B]: each row's best exact product over the packed rows."""
    _check_unpack(unpack)
    n, d, b, dev = _check_packed(q8, packed)
    if dev.type == "cpu":
        return int4_fold_max_torch(q8, packed, unpack)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.full((b,), _INT32_MIN, dtype=torch.int32, device=dev)
    _fold(_KIND_FOLD[unpack], q8, packed, n, d, b, dev, True, out)
    int4_fold_max.launches += 1
    return out


int4_fold_max.launches = 0


def int8_fold_max(q8: torch.Tensor, e8: torch.Tensor) -> torch.Tensor:
    """int32 [B]: each row's best exact product over the int8 rows."""
    n, d, b, dev = _check_int8(q8, e8)
    if dev.type == "cpu":
        return int8_fold_max_torch(q8, e8)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.full((b,), _INT32_MIN, dtype=torch.int32, device=dev)
    _fold(_KIND_INT8, q8, e8, n, d, b, dev, False, out)
    int8_fold_max.launches += 1
    return out


int8_fold_max.launches = 0
