"""Fused dense scoring + streaming top-k: CUDA kernels and plain versions.

``fused_dense_top_k`` (K1, f32/bf16 rows) and ``fused_dense_top_k_int8``
(K2, int8 rows with per-row scales) replace the TPU kernels of the same
names in the JAX package (``a_nice_rag_tpu.ops``, fused_topk.py:1440 and
:1218). On CUDA tensors each wrapper
launches its kernels from ``csrc/fused_topk.cu`` or raises; it takes its
plain PyTorch version only for tensors on the CPU. ``.launches`` on each
wrapper counts calls that launched the kernels (one per call), so a run
can show which path it took.

Both stream the doc tiles through a ring of 16-byte asynchronous copies
into shared memory, per CTA a block of 16 queries (B <= 16) or 64;
``topk_plan.fused_plan`` picks the block and the doc splits. K1 scores
bf16 rows on the bf16 tensor cores against the exact three-piece bf16
split of the f32 query (``split_query``; ``csrc/float_mma.cuh``) and f32
rows on FFMA in IEEE f32; K2 on the int8 tensor cores
(``csrc/int8_mma.cuh``). Each call first takes an exact warm start tau
(``subsample_tau``): the same kernel over every 64th candidate row gives
each query the k-th best score there, lowered a little, which seeds every
running list; then the main pass, and a merge with one CTA per query.

Contract: values [B, k] f32 descending and ids [B, k] int32 under the tie
rule (score desc, doc id asc); masked documents are never candidates and
unfilled slots hold (-inf, -1). k <= 128; B, N and D take any size (K2: D
up to the depth whose 16-query block fits in a CTA's shared memory, about
9,800), and rows of any alignment.

``rounded=True`` selects the rounded fold, K1r / K2r
(``fused_dense_top_k_rounded``, ``fused_dense_top_k_int8_rounded``): the
TPU kernels' ``algo="packed"`` (bodies ``_kernel_packed``,
fused_topk.py:359, and ``_kernel_packed_int8``, :377). Both run on the
cluster kernel, ``csrc/cluster_topk.cu`` (``cluster_topk.py``: a cluster
of query blocks on one TMA-multicast doc stream, wgmma, a threshold
epilogue), K1r on bf16 rows, K2r on int8 rows; calls it does not suit
take K1's / K2's kernel with its rounding flag, counted by the wrapper's
``.split_launches``: K2r's batches of one 16-query block (B <=
``K2R_SPLIT_MAX_B``); K1r's f32 rows, batches up to
``BF16_SPLIT_MAX_B`` and depths whose three query planes do not stay
resident in a CTA (``bf16_cluster_route``). The top k is taken
on every score rounded to bf16 (to nearest, ties to even), under the same
tie rule, and the values are those rounded scores (K2r: times the query
scale); bf16 -0.0 ranks below +0.0, as the TPU kernel's packed key ranks
it. As in the JAX package, the rounded fold applies to maskless calls
whose N is a multiple of ``ROUNDED_ALIGN``: a masked or misaligned call
gives K1 / K2's exact result. (The TPU kernel's own boundary ties follow
its eviction order, not the lower id; its test compares the selected
scores.)

``compare_dtype="bfloat16"`` selects the bf16 compare fold, K1c
(``fused_dense_top_k_bf16_compare``): the TPU body ``_kernel_iterate``
with ``compare_dtype="bfloat16"`` (fused_topk.py:921, product at
:945-951), whose ``dot_general`` emits bf16. The product is accumulated
in f32 and rounded to bf16 once (to nearest, ties to even); where either
operand is bf16, the other is rounded to bf16 first. The top k is taken
on those scores under (score desc, id asc), compared as floats (-0.0 and
+0.0 tie), and the values are the rounded scores. ``fold_route`` copies
the JAX launcher's routing: a maskless call over N % ROUNDED_ALIGN == 0
rows takes K1r when ``rounded`` is set and K1 otherwise, whatever
``compare_dtype`` says (the TPU default algo ignores it there); any other
call takes K1c when ``compare_dtype == "bfloat16"``, else K1. On the card
K1c on bf16 rows runs the cluster kernel with one bf16 query plane, the
mask read a tile at a time, any N; f32 rows (FFMA), small batches and
wide depths take K1's kernel in its compare mode (``.split_launches``),
as ``bf16_cluster_route`` decides. ``compare_dtype`` takes "float32"
or "bfloat16" only (the JAX function takes any dtype name).

K1's ``plan=`` (query block, splits) is read only by K1's kernel: on the
cluster route it is checked as K1's route checks it, and not applied.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build, cluster_topk, topk_plan
from a_nice_rag_tpu_torch.ops.kernels._launches import count_launch
from a_nice_rag_tpu_torch.ops.quantized import int8_dot

K_MAX = 128
H100_SMS = 132
TAU_STRIDE = topk_plan.TAU_STRIDE
# tau from a subsample is lowered by this much relative to |tau| (and
# 1e-30): room for a second summation order where the subsample is scored
# apart from the full matrix (the plain versions, the probes' callers).
TAU_SLACK = 1e-5
# Plain versions score at most this many [B, chunk] scores, and upcast at
# most this many [chunk, D] elements, at a time: a 10.7 GB int8 matrix is
# never upcast whole.
_PLAIN_CHUNK_ELEMS = 1 << 27
_ROWS = {torch.float32: "float32", torch.bfloat16: "bfloat16",
         torch.int8: "int8"}
# The rounded fold's calls: maskless, N a multiple of this (the TPU
# launchers' _N_ALIGN).
ROUNDED_ALIGN = 1024
# K2r's batches up to this many queries (one 16-query block) take K2's
# kernel with its rounding flag, larger ones csrc/cluster_topk.cu: on an
# H100 at 10.5M x 1024 int8 the cluster kernel is 5-10% slower at B = 8
# and 16 and 1.5x faster from B = 32 on (PERF.md, K2r).
K2R_SPLIT_MAX_B = 16
# The int32 bits of -0.0, and of the negative f32 nearest zero (no bf16
# value) that carries a rounded -0.0 below +0.0 (csrc/topk_common.cuh).
_NEG_ZERO_BITS = -0x80000000
_CARRIED_NEG_ZERO_BITS = -0x7FFFFFFF
# The float kernels' score modes (csrc/topk_common.cuh's ScoreMode): K1,
# K1r, K1c.
SCORE_EXACT, SCORE_ROUNDED, SCORE_COMPARE = 0, 1, 2
COMPARE_DTYPES = ("float32", "bfloat16")
# K1r's and K1c's batches on bf16 rows up to this many queries (K1's
# 16-query block) take K1's kernel in the fold's score mode, larger ones
# csrc/cluster_topk.cu: on an H100 at 2^21 x 256 the cluster kernel is
# slower at B = 8 and 16 and faster from B = 24 on (PERF.md, K1r, K1c).
BF16_SPLIT_MAX_B = 16
# The cluster kernel's row kind for each float fold.
CLUSTER_KINDS = {SCORE_ROUNDED: "rounded", SCORE_COMPARE: "compare"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_topk")
    if not hasattr(lib, "_anr_bound"):
        # q, e, mask; B N D k bq qres splits per tau_splits tau_per
        # score round_rows; workspace, out_v, out_i, tau_out, stream.
        floats = [_P] * 3 + [_I] * 12 + [_P] * 5
        lib.anr_fused_topk_f32.argtypes = floats
        lib.anr_fused_topk_bf16.argtypes = floats
        # q, q scales, values, scales, mask; B N D k bq splits per
        # tau_splits tau_per rounded; workspace, out_v, out_i, tau_out,
        # stream.
        lib.anr_fused_topk_int8.argtypes = [_P] * 5 + [_I] * 10 + [_P] * 5
        for fn in (lib.anr_fused_topk_f32, lib.anr_fused_topk_bf16,
                   lib.anr_fused_topk_int8):
            fn.restype = _I
        lib.anr_topk_tile_docs.argtypes = []
        lib.anr_topk_tile_docs.restype = _I
        lib.anr_int8_smem_bytes.argtypes = [_I, _I, _I]
        lib.anr_float_smem_bytes.argtypes = [_I] * 6
        lib.anr_topk_workspace_bytes.argtypes = [_I] * 6
        for fn in (lib.anr_int8_smem_bytes, lib.anr_float_smem_bytes,
                   lib.anr_topk_workspace_bytes):
            fn.restype = _LL
        lib._anr_bound = True
    return lib


def int8_smem_bytes(bq: int, d: int, k: int) -> int:
    """The dynamic shared memory of a K2 or K4 CTA, as the source
    computes it (``topk_plan.smem_bytes`` must agree)."""
    return int(_library().anr_int8_smem_bytes(bq, d, k))


def float_smem_bytes(bq: int, d: int, k: int, rows: str,
                     qres: bool, planes: Optional[int] = None) -> int:
    """The same for a K1 or K3 CTA over ``rows`` ("bfloat16" or
    "float32"), its query block (``planes`` planes, default the rows')
    resident or streamed."""
    if planes is None:
        planes = topk_plan.QUERY_PLANES[rows]
    return int(_library().anr_float_smem_bytes(
        bq, d, int(rows == "bfloat16"), planes, int(qres), k))


def workspace_bytes_of_source(b: int, k: int, walkers: int,
                              tau_walkers: int, d: int, pieces: bool) -> int:
    """The workspace of one call as the source lays it out
    (``topk_plan.workspace_bytes`` must agree)."""
    return int(_library().anr_topk_workspace_bytes(
        b, k, walkers, tau_walkers, d, int(pieces)))


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device; for the CPU, an H100's, so plain versions
    that follow the kernels' split plan reproduce the card's."""
    if device.type == "cuda":
        index = device.index
        return _device_sms(torch.cuda.current_device() if index is None
                           else index)
    return H100_SMS


@functools.lru_cache(maxsize=1024)
def _fused_plans(n: int, b: int, d: int, k: int, sms: int, rows: str,
                 override: Optional[Tuple[Optional[int], Optional[int]]]
                 = None, planes: Optional[int] = None):
    """(plan, resident query block, (tau splits, tau rows per split));
    ``override`` (bq, splits), either None for the plan's own, is checked
    by ``topk_plan.override_plan``; ``planes``: the query planes, if not
    the rows' own (K1c's one)."""
    if override is None:
        plan = topk_plan.fused_plan(n, b, d, k, sms, rows, planes)
    else:
        plan = topk_plan.override_plan(n, b, d, k, sms, rows, *override,
                                       planes=planes)
    return (plan, topk_plan.resident(plan.bq, d, k, rows, planes),
            topk_plan.tau_fused_plan(n, b, d, k, sms, rows, plan.bq, planes))


def _override(plan) -> Optional[Tuple[Optional[int], Optional[int]]]:
    """A caller's ``plan=`` as a hashable (bq, splits), None for none."""
    if plan is None:
        return None
    bq, splits = plan[0], plan[1]
    return None if bq is None and splits is None else (bq, splits)


def _check_k(k: int) -> None:
    if not isinstance(k, int) or not 1 <= k <= K_MAX:
        raise ValueError(f"k must be an int in [1, {K_MAX}], got {k!r}")


def _check(t: torch.Tensor, name: str, dtypes, shape, device,
           contiguous: bool = True) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn, *args, device: torch.device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with cudaError_t {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _outputs(b: int, k: int, device: torch.device):
    return (torch.empty((b, k), dtype=torch.float32, device=device),
            torch.empty((b, k), dtype=torch.int32, device=device))


def _workspace(b: int, k: int, walkers: int, tau_walkers: int, d: int,
               pieces: bool, device: torch.device) -> torch.Tensor:
    return torch.empty(topk_plan.workspace_bytes(b, k, walkers, tau_walkers,
                                                 d, pieces),
                       dtype=torch.uint8, device=device)


def _chunk_rows(b: int, d: int) -> int:
    """Documents per block of a plain version (see _PLAIN_CHUNK_ELEMS)."""
    return max(1, _PLAIN_CHUNK_ELEMS // max(b, d, 1))


def _plain_top_k(
    score_chunk: Callable[[int, int], torch.Tensor],
    n: int, b: int, d: int, k: int, device: torch.device,
    tau: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over [B, chunk] f32 score blocks in doc order.

    The running list (earlier, lower ids) sits before each new block and
    the sort is stable, so equal scores keep the lower id first. With
    ``tau`` [B], a document is a candidate only if it scores at least
    tau[b]: the kernels' warm start, which must leave the result as it is.
    """
    run_v = torch.full((b, k), float("-inf"), device=device)
    run_i = torch.full((b, k), -1, dtype=torch.int64, device=device)
    chunk = _chunk_rows(b, d)
    for s0 in range(0, n, chunk):
        s1 = min(n, s0 + chunk)
        s = score_chunk(s0, s1)
        if tau is not None:
            s = torch.where(s >= tau[:, None], s, float("-inf"))
        cat_v = torch.cat([run_v, s], dim=1)
        ids = torch.arange(s0, s1, device=device).expand(b, -1)
        cat_i = torch.cat([run_i, ids], dim=1)
        v, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
        run_v = v[:, :k]
        run_i = torch.take_along_dim(cat_i, pos[:, :k], dim=1)
    run_i = torch.where(torch.isneginf(run_v), -1, run_i)
    return run_v, run_i.to(torch.int32)


def rounded_route(n: int, mask: Optional[torch.Tensor]) -> bool:
    """Whether a call asking for the rounded fold over ``n`` rows takes it
    (maskless, n a multiple of ROUNDED_ALIGN), else K1 / K2's exact fold."""
    return mask is None and n % ROUNDED_ALIGN == 0


def fold_route(n: int, mask: Optional[torch.Tensor], rounded: bool,
               compare_dtype: str = "float32") -> int:
    """The fold a float call over ``n`` rows takes, as the JAX launcher
    routes it: where ``rounded_route`` holds (maskless, aligned), K1r if
    ``rounded`` else K1, ``compare_dtype`` ignored; otherwise K1c if
    ``compare_dtype`` is "bfloat16", else K1. One of SCORE_EXACT (K1),
    SCORE_ROUNDED (K1r), SCORE_COMPARE (K1c); ValueError for a
    ``compare_dtype`` outside COMPARE_DTYPES."""
    if compare_dtype not in COMPARE_DTYPES:
        raise ValueError(f"compare_dtype must be one of {COMPARE_DTYPES}, "
                         f"got {compare_dtype!r}")
    if rounded_route(n, mask):
        return SCORE_ROUNDED if rounded else SCORE_EXACT
    return SCORE_COMPARE if compare_dtype == "bfloat16" else SCORE_EXACT


def bf16_cluster_route(n: int, b: int, d: int, k: int, rows: str,
                       score: int, aligned: bool = True) -> bool:
    """Whether a K1r (``score`` SCORE_ROUNDED) or K1c (SCORE_COMPARE) call
    over ``n`` rows ``rows`` of depth ``d`` takes ``csrc/cluster_topk.cu``:
    bf16 rows, B past ``BF16_SPLIT_MAX_B``, and a plan whose query planes
    stay resident in a CTA with the doc chunks on TMA (``aligned``: the
    rows' base is 16-byte aligned). Otherwise K1's kernel in the fold's
    score mode: f32 rows (FFMA), small batches, depths whose planes do
    not stay resident (K1r at D = 1024), rows the TMA cannot take."""
    if rows != "bfloat16" or b <= BF16_SPLIT_MAX_B:
        return False
    plan = cluster_topk.cluster_plan(n, b, d, k, aligned=aligned,
                                     kind=CLUSTER_KINDS[score])
    return plan.resident and plan.tma


def round_scores(s: torch.Tensor) -> torch.Tensor:
    """The rounded fold's selection scores: f32 ``s`` rounded to bf16 (to
    nearest, ties to even) and back, -0.0 carried as the negative f32
    nearest zero so that it ranks below +0.0 and above every negative
    bf16 (csrc/topk_common.cuh's selection_score)."""
    bits = s.to(torch.bfloat16).to(torch.float32).view(torch.int32)
    return torch.where(bits == _NEG_ZERO_BITS, _CARRIED_NEG_ZERO_BITS,
                       bits).view(torch.float32)


def unround_values(v: torch.Tensor) -> torch.Tensor:
    """Selected rounded scores as the rounded fold returns them: the
    carried -0.0 back to -0.0."""
    bits = v.contiguous().view(torch.int32)
    return torch.where(bits == _CARRIED_NEG_ZERO_BITS, _NEG_ZERO_BITS,
                       bits).view(torch.float32)


def _float_scores(emb: torch.Tensor, queries: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  rounded: bool = False):
    """K1's scores of documents [s0, s1): f32 (both operands upcast),
    masked documents at -inf; ``rounded``: K1r's (``round_scores``)."""
    q = queries.to(torch.float32)

    def scores(s0: int, s1: int) -> torch.Tensor:
        s = q @ emb[s0:s1].to(torch.float32).T
        if rounded:
            s = round_scores(s)
        if mask is not None:
            s = torch.where(mask[s0:s1][None, :], s, float("-inf"))
        return s

    return scores


def _compare_scores(emb: torch.Tensor, queries: torch.Tensor,
                    mask: Optional[torch.Tensor] = None):
    """K1c's scores of documents [s0, s1): the f32 product of f32 rows and
    an f32 query, else of both operands in bf16 (an f32 one rounded to
    nearest even), accumulated in f32; then rounded to bf16 and back,
    masked documents at -inf."""
    bf16 = torch.bfloat16 in (emb.dtype, queries.dtype)
    op = torch.bfloat16 if bf16 else torch.float32
    q = queries.to(op).to(torch.float32)

    def scores(s0: int, s1: int) -> torch.Tensor:
        s = q @ emb[s0:s1].to(op).to(torch.float32).T
        s = s.to(torch.bfloat16).to(torch.float32)
        if mask is not None:
            s = torch.where(mask[s0:s1][None, :], s, float("-inf"))
        return s

    return scores


def _int8_scores(values: torch.Tensor, scales: torch.Tensor,
                 q_values: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 rounded: bool = False):
    """K2's selection scores float(acc) * doc_scale, masked at -inf;
    ``rounded``: K2r's (``round_scores`` of them)."""

    def scores(s0: int, s1: int) -> torch.Tensor:
        acc = int8_dot(q_values, values[s0:s1])
        s = acc.to(torch.float32) * scales[s0:s1][None, :]
        if rounded:
            s = round_scores(s)
        if mask is not None:
            s = torch.where(mask[s0:s1][None, :], s, float("-inf"))
        return s

    return scores


def fused_dense_top_k_torch(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    rounded: bool = False,
    compare_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (and of K1r or K1c where ``fold_route``
    takes them): f32 scores (both operands upcast; K1r: rounded to bf16),
    masked docs at -inf, stable selection."""
    score = fold_route(emb.shape[0], mask, rounded, compare_dtype)
    if score == SCORE_COMPARE:
        return fused_dense_top_k_bf16_compare_torch(emb, queries, k, mask)
    rounded = score == SCORE_ROUNDED
    vals, ids = _plain_top_k(_float_scores(emb, queries, mask, rounded),
                             emb.shape[0], queries.shape[0], emb.shape[1],
                             k, emb.device)
    return (unround_values(vals) if rounded else vals), ids


def fused_dense_top_k_bf16_compare_torch(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1c: the stable top k of
    ``_compare_scores`` (any N, masked or not), their values."""
    return _plain_top_k(_compare_scores(emb, queries, mask), emb.shape[0],
                        queries.shape[0], emb.shape[1], k, emb.device)


def split_query(queries: torch.Tensor) -> torch.Tensor:
    """The three bf16 planes [3, B, D] (hi, mid, lo) of an f32 query that
    K1 and K3 multiply bf16 rows with: hi keeps the top 16 bits of q's f32
    word, mid the top 16 bits of what remains, lo the rest rounded to
    bf16. hi + mid + lo == q exactly for q = 0 and |q| >= 2^-110 (the rest
    fits in 8 significant bits); below, bf16's smallest step 2^-133 bounds
    the error. Non-finite q: hi carries it, mid and lo are 0.
    ``split_query_kernel`` of ``csrc/topk_common.cuh`` computes the same
    bits on the card."""
    q = queries.to(torch.float32)
    top = -65536  # 0xffff0000 as an int32
    hi = (q.view(torch.int32) & top).view(torch.float32)
    rest = torch.where(torch.isfinite(q), q - hi, 0.0)
    mid = (rest.contiguous().view(torch.int32) & top).view(torch.float32)
    return torch.stack([hi, mid, rest - mid]).to(torch.bfloat16)


def _lowered(kth: torch.Tensor) -> torch.Tensor:
    return kth - kth.abs() * TAU_SLACK - 1e-30


def _tau_of(scores: torch.Tensor, k: int) -> torch.Tensor:
    """tau from the subsample's scores [B, R] (-inf: not a candidate):
    each row's k-th best, lowered by TAU_SLACK; -inf with fewer than k
    candidates."""
    b = scores.shape[0]
    if scores.shape[1] < k:
        return torch.full((b,), float("-inf"), device=scores.device)
    kth = torch.topk(scores, k, dim=1).values[:, -1]
    return torch.where(torch.isfinite(kth), _lowered(kth), kth)


def subsample_tau_torch(emb: torch.Tensor, queries: torch.Tensor, k: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``subsample_tau``: the k-th best f32 score over
    rows 0, 64, 128, ... that the mask keeps, lowered."""
    rows = torch.arange(0, emb.shape[0], TAU_STRIDE, device=emb.device)
    s = queries.to(torch.float32) @ emb[rows].to(torch.float32).T
    if mask is not None:
        s = torch.where(mask[rows][None, :], s, float("-inf"))
    return _tau_of(s, k)


def subsample_tau_int8_torch(values: torch.Tensor, scales: torch.Tensor,
                             q_values: torch.Tensor, k: int,
                             mask: Optional[torch.Tensor] = None,
                             rounded: bool = False) -> torch.Tensor:
    """Plain version of ``subsample_tau_int8``, on the selection scores
    float(acc) * doc scale (``rounded``: K2r's, rounded to bf16, the tau
    its kernel seeds its lists with)."""
    rows = torch.arange(0, values.shape[0], TAU_STRIDE, device=values.device)
    s = (int8_dot(q_values, values[rows]).to(torch.float32)
         * scales[rows][None, :])
    if rounded:
        s = round_scores(s)
    if mask is not None:
        s = torch.where(mask[rows][None, :], s, float("-inf"))
    return _tau_of(s, k)


def _check_float_call(emb, queries, k, mask):
    _check_k(k)
    if emb.ndim != 2 or queries.ndim != 2 or queries.shape[1] != emb.shape[1]:
        raise ValueError(
            f"need emb [N, D] and queries [B, D], got {tuple(emb.shape)} "
            f"and {tuple(queries.shape)}"
        )
    n, d = emb.shape
    b = queries.shape[0]
    dev = emb.device
    _check(emb, "emb", (torch.float32, torch.bfloat16), (n, d), dev)
    # The queries are copied to a contiguous f32 block (K1c on bf16 rows:
    # bf16) before the launch.
    _check(queries, "queries", (torch.float32, torch.bfloat16), (b, d), dev,
           contiguous=False)
    if mask is not None:
        _check(mask, "mask", (torch.bool,), (n,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, d, b, dev


def _float_call(emb, queries, k, mask, tau_only: bool, override=None,
                score: int = SCORE_EXACT):
    """Launch K1 (``score``: K1r or K1c; or, ``tau_only``, its tau pass
    alone) on CUDA tensors. K1 and K1r take the f32 query (upcast); K1c on
    bf16 rows its one bf16 plane (a bf16 query as it is, an f32 one
    rounded to nearest even), on f32 rows the f32 query, with the rows
    rounded to bf16 in the kernel where the query is bf16."""
    n, d = emb.shape
    b, dev = queries.shape[0], emb.device
    rows = _ROWS[emb.dtype]
    lib = _library()
    compare = score == SCORE_COMPARE
    one_plane = compare and rows == "bfloat16"
    q = queries.to(torch.bfloat16 if one_plane else torch.float32)
    q = q.contiguous()
    round_rows = compare and rows == "float32" \
        and queries.dtype == torch.bfloat16
    plan, qres, (tau_splits, tau_per) = _fused_plans(
        n, b, d, k, _sm_count(dev), rows, override,
        topk_plan.COMPARE_PLANES if compare else None)
    splits = 1 if tau_only else plan.splits
    ws = _workspace(b, k, splits, tau_splits, d,
                    rows == "bfloat16" and not compare, dev)
    if tau_only:
        out_v, out_i = torch.empty((b,), device=dev), None
    else:
        out_v, out_i = _outputs(b, k, dev)
    fn = (lib.anr_fused_topk_f32 if rows == "float32"
          else lib.anr_fused_topk_bf16)
    with torch.cuda.device(dev):
        _launch(fn, q.data_ptr(), emb.data_ptr(), _ptr(mask), b, n, d, k,
                plan.bq, int(qres), splits, plan.per if not tau_only else
                topk_plan.TN, tau_splits, tau_per, score, int(round_rows),
                ws.data_ptr(),
                None if tau_only else out_v.data_ptr(), _ptr(out_i),
                out_v.data_ptr() if tau_only else None, device=dev)
    return out_v if tau_only else (out_v, out_i)


def _fold_call(wrapper, emb, queries, k, mask, override, score: int):
    """K1r or K1c (``score``) on CUDA tensors, on the route
    ``bf16_cluster_route`` picks; counted on ``wrapper``. ``override``, K1's
    plan, is checked on either route and applied on K1's."""
    n, d = emb.shape
    b, dev, rows = queries.shape[0], emb.device, _ROWS[emb.dtype]
    if bf16_cluster_route(n, b, d, k, rows, score, emb.data_ptr() % 16 == 0):
        if override is not None:
            _fused_plans(n, b, d, k, _sm_count(dev), rows, override,
                         topk_plan.COMPARE_PLANES
                         if score == SCORE_COMPARE else None)
        out = cluster_topk.bf16_top_k(emb, queries, k, _sm_count(dev),
                                      CLUSTER_KINDS[score], mask)
    else:
        out = _float_call(emb, queries, k, mask, tau_only=False,
                          override=override, score=score)
        count_launch(wrapper, "split_launches")
    count_launch(wrapper)
    return out


def split_route_top_k(emb: torch.Tensor, queries: torch.Tensor, k: int,
                      score: int, mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's kernel in score mode ``score`` (K1, K1r or K1c) on CUDA
    tensors, whatever ``bf16_cluster_route`` says: the split route, timed
    beside the cluster kernel in one call. Counts no launch."""
    n, _, _, dev = _check_float_call(emb, queries, k, mask)
    if dev.type != "cuda":
        raise ValueError(f"split_route_top_k runs K1's kernel: {dev} is not "
                         f"a CUDA device")
    if score == SCORE_ROUNDED:
        _check_rounded(n)
    return _float_call(emb, queries, k, mask, tau_only=False, score=score)


def fused_dense_top_k(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    plan: Optional[Tuple[Optional[int], Optional[int]]] = None,
    rounded: bool = False,
    compare_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: streaming scoring + top-k over emb [N, D] (f32 or bf16) for
    queries [B, D] (f32, or bf16 as the two-tier BM25 tier passes;
    upcast to f32). mask: optional [N] bool, True = candidate.

    ``plan``: (bq, splits, ...) in place of ``topk_plan.fused_plan``'s
    (the tuner's ``KernelConfig``; None in either keeps the plan's own). A
    query block that does not fit raises. It spreads the work only: the
    values and ids are the default plan's. On CPU tensors the override is
    checked against an H100's plan and the plain version runs.

    ``rounded``: the rounded fold (``fused_dense_top_k_rounded``) and
    ``compare_dtype="bfloat16"``: the bf16 compare fold
    (``fused_dense_top_k_bf16_compare``), each where ``fold_route``
    takes it; else K1."""
    n, d, b, dev = _check_float_call(emb, queries, k, mask)
    score = fold_route(n, mask, rounded, compare_dtype)
    if score == SCORE_ROUNDED:
        return fused_dense_top_k_rounded(emb, queries, k, plan=plan)
    if score == SCORE_COMPARE:
        return fused_dense_top_k_bf16_compare(emb, queries, k, mask=mask,
                                              plan=plan)
    override = _override(plan)
    if dev.type == "cpu":
        if override is not None:
            _fused_plans(n, b, d, k, H100_SMS, _ROWS[emb.dtype], override)
        return fused_dense_top_k_torch(emb, queries, k, mask)
    out = _float_call(emb, queries, k, mask, tau_only=False,
                      override=override)
    count_launch(fused_dense_top_k)
    return out


fused_dense_top_k.launches = 0


def _check_rounded(n: int) -> None:
    if n % ROUNDED_ALIGN:
        raise ValueError(f"the rounded fold takes N a multiple of "
                         f"{ROUNDED_ALIGN}, got {n}")


def fused_dense_top_k_rounded(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    plan: Optional[Tuple[Optional[int], Optional[int]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1r, K1's rounded fold (no mask; N a multiple of ROUNDED_ALIGN, else
    ValueError): the top k of bf16-rounded scores under (score desc, id
    asc), their rounded values; ``plan`` as K1's (read only by K1's
    kernel). On CUDA tensors, as ``bf16_cluster_route`` decides,
    ``csrc/cluster_topk.cu`` on bf16 rows (the f32 query's three bf16
    planes on wgmma, a threshold epilogue) or K1's kernel with its
    rounding flag (``.split_launches`` counts these calls); ``.launches``
    counts both. A failed build or launch raises. On the CPU the plain
    version."""
    n, d, b, dev = _check_float_call(emb, queries, k, None)
    _check_rounded(n)
    override = _override(plan)
    if dev.type == "cpu":
        if override is not None:
            _fused_plans(n, b, d, k, H100_SMS, _ROWS[emb.dtype], override)
        return fused_dense_top_k_torch(emb, queries, k, rounded=True)
    return _fold_call(fused_dense_top_k_rounded, emb, queries, k, None,
                      override, SCORE_ROUNDED)


fused_dense_top_k_rounded.launches = 0
fused_dense_top_k_rounded.split_launches = 0


def fused_dense_top_k_bf16_compare(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    plan: Optional[Tuple[Optional[int], Optional[int]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1c, K1's bf16 compare fold (the JAX call ``algo="iterate",
    compare_dtype="bfloat16"``; any N, with or without a mask): the top k
    under (score desc, id asc) of the f32-accumulated product rounded to
    bf16, both operands in bf16 where either is; their rounded values.
    ``plan`` as K1's (read only by K1's kernel). On CUDA tensors, as
    ``bf16_cluster_route`` decides, ``csrc/cluster_topk.cu`` on bf16 rows
    (one bf16 query plane on wgmma, the mask read a tile at a time) or
    K1's kernel in its compare mode (``.split_launches`` counts these
    calls); ``.launches`` counts both. A failed build or launch raises. On
    the CPU the plain version."""
    n, d, b, dev = _check_float_call(emb, queries, k, mask)
    override = _override(plan)
    if dev.type == "cpu":
        if override is not None:
            _fused_plans(n, b, d, k, H100_SMS, _ROWS[emb.dtype], override,
                         topk_plan.COMPARE_PLANES)
        return fused_dense_top_k_bf16_compare_torch(emb, queries, k, mask)
    return _fold_call(fused_dense_top_k_bf16_compare, emb, queries, k, mask,
                      override, SCORE_COMPARE)


fused_dense_top_k_bf16_compare.launches = 0
fused_dense_top_k_bf16_compare.split_launches = 0


def subsample_tau(emb: torch.Tensor, queries: torch.Tensor, k: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1's exact warm start [B] f32: the k-th best score over rows 0, 64,
    128, ... that the mask keeps, lowered by TAU_SLACK (-inf with fewer
    than k of them): at most the k-th best candidate, so a running list
    seeded with it keeps the same top-k. (K1r's and K1c's tau passes take
    the k-th best of their rounded scores, which their main passes round
    the same way, so a tie at tau is never dropped.) On CUDA tensors K1's
    own tau pass (the same kernel over the strided rows, no copy of
    them); on the CPU its plain version."""
    _, _, _, dev = _check_float_call(emb, queries, k, mask)
    if dev.type == "cpu":
        return subsample_tau_torch(emb, queries, k, mask)
    return _float_call(emb, queries, k, mask, tau_only=True)


def fused_dense_top_k_int8_torch(
    values: torch.Tensor,
    scales: torch.Tensor,
    q_values: torch.Tensor,
    q_scales: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    rounded: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (and, ``rounded`` where ``rounded_route``
    takes it, of K2r): exact int32 dot, selection on float(acc) *
    doc_scale (K2r: rounded to bf16), then * q_scale on the k outputs
    only."""
    rounded = rounded and rounded_route(values.shape[0], mask)
    vals, ids = _plain_top_k(
        _int8_scores(values, scales, q_values, mask, rounded),
        values.shape[0], q_values.shape[0], values.shape[1], k,
        values.device)
    if rounded:
        vals = unround_values(vals)
    vals = torch.where(ids < 0, float("-inf"), vals * q_scales[:, None])
    return vals, ids


def _check_int8_call(values, scales, q_values, q_scales, k, mask):
    _check_k(k)
    if values.ndim != 2 or q_values.ndim != 2 \
            or q_values.shape[1] != values.shape[1]:
        raise ValueError(
            f"need values [N, D] and q_values [B, D], got "
            f"{tuple(values.shape)} and {tuple(q_values.shape)}"
        )
    n, d = values.shape
    b = q_values.shape[0]
    dev = values.device
    _check(values, "values", (torch.int8,), (n, d), dev)
    _check(scales, "scales", (torch.float32,), (n,), dev)
    _check(q_values, "q_values", (torch.int8,), (b, d), dev)
    if q_scales is not None:
        _check(q_scales, "q_scales", (torch.float32,), (b,), dev)
    if mask is not None:
        _check(mask, "mask", (torch.bool,), (n,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, d, b, dev


def _int8_call(values, scales, q_values, q_scales, k, mask, tau_only: bool,
               rounded: bool = False):
    """Launch K2 (``rounded``: with its rounding flag, K2r's small-batch
    route; or, ``tau_only``, its tau pass alone) on CUDA tensors."""
    n, d = values.shape
    b, dev = q_values.shape[0], values.device
    lib = _library()
    plan, _, (tau_splits, tau_per) = _fused_plans(n, b, d, k, _sm_count(dev),
                                                  "int8")
    splits = 1 if tau_only else plan.splits
    ws = _workspace(b, k, splits, tau_splits, d, False, dev)
    if tau_only:
        out_v, out_i = torch.empty((b,), device=dev), None
    else:
        out_v, out_i = _outputs(b, k, dev)
    with torch.cuda.device(dev):
        _launch(lib.anr_fused_topk_int8, q_values.data_ptr(),
                _ptr(q_scales), values.data_ptr(), scales.data_ptr(),
                _ptr(mask), b, n, d, k, plan.bq, splits,
                topk_plan.TN if tau_only else plan.per, tau_splits, tau_per,
                int(rounded), ws.data_ptr(),
                None if tau_only else out_v.data_ptr(),
                _ptr(out_i), out_v.data_ptr() if tau_only else None,
                device=dev)
    return out_v if tau_only else (out_v, out_i)


def fused_dense_top_k_int8(
    values: torch.Tensor,
    scales: torch.Tensor,
    q_values: torch.Tensor,
    q_scales: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    rounded: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: streaming int8 scoring + top-k. values [N, D] int8 + scales
    [N] f32 (ops.quantized layout); q_values [B, D] int8 + q_scales [B]
    f32; mask: optional [N] bool. Row-major views of any base alignment
    (``values[1:]``) are taken as they are. ``rounded``: the rounded fold
    (``fused_dense_top_k_int8_rounded``) where ``rounded_route`` takes
    it; a masked or misaligned call stays K2."""
    n, _, _, dev = _check_int8_call(values, scales, q_values, q_scales, k,
                                    mask)
    if rounded and rounded_route(n, mask):
        return fused_dense_top_k_int8_rounded(values, scales, q_values,
                                              q_scales, k)
    if dev.type == "cpu":
        return fused_dense_top_k_int8_torch(
            values, scales, q_values, q_scales, k, mask
        )
    out = _int8_call(values, scales, q_values, q_scales, k, mask,
                     tau_only=False)
    count_launch(fused_dense_top_k_int8)
    return out


fused_dense_top_k_int8.launches = 0


def fused_dense_top_k_int8_rounded(
    values: torch.Tensor,
    scales: torch.Tensor,
    q_values: torch.Tensor,
    q_scales: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2r, K2's rounded fold (no mask; N a multiple of ROUNDED_ALIGN, else
    ValueError): the top k of bf16(float(acc) * doc_scale) under (score
    desc, id asc), their rounded values times q_scale. On CUDA tensors,
    by B: up to ``K2R_SPLIT_MAX_B`` queries (one 16-query block), K2's
    kernel with its rounding flag, which streams the rows faster there
    (``.split_launches`` counts these calls); past it ``csrc/
    cluster_topk.cu`` (a cluster of query blocks on one TMA-multicast doc
    stream, wgmma s8, a threshold epilogue; ``cluster_topk.cluster_plan``
    gives its launch). ``.launches`` counts both. A failed build or
    launch raises. On the CPU the plain version."""
    n, _, b, dev = _check_int8_call(values, scales, q_values, q_scales, k,
                                    None)
    _check_rounded(n)
    if q_scales is None:
        raise ValueError("K2r needs q_scales [B]")
    if dev.type == "cpu":
        return fused_dense_top_k_int8_torch(values, scales, q_values,
                                            q_scales, k, rounded=True)
    if b <= K2R_SPLIT_MAX_B:
        out = _int8_call(values, scales, q_values, q_scales, k, None,
                         tau_only=False, rounded=True)
        count_launch(fused_dense_top_k_int8_rounded, "split_launches")
    else:
        out = cluster_topk.rounded_top_k_int8(values, scales, q_values,
                                              q_scales, k, _sm_count(dev))
    count_launch(fused_dense_top_k_int8_rounded)
    return out


fused_dense_top_k_int8_rounded.launches = 0
fused_dense_top_k_int8_rounded.split_launches = 0


def subsample_tau_int8(values: torch.Tensor, scales: torch.Tensor,
                       q_values: torch.Tensor, k: int,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``subsample_tau`` for K2, on its selection scores float(acc) * doc
    scale (before the query scale)."""
    dev = _check_int8_call(values, scales, q_values, None, k, mask)[3]
    if dev.type == "cpu":
        return subsample_tau_int8_torch(values, scales, q_values, k, mask)
    return _int8_call(values, scales, q_values, None, k, mask, tau_only=True)
