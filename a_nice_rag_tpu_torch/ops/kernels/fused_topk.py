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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build, topk_plan
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

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_topk")
    if not hasattr(lib, "_anr_bound"):
        # q, e, mask; B N D k bq qres splits per tau_splits tau_per;
        # workspace, out_v, out_i, tau_out, stream.
        floats = [_P] * 3 + [_I] * 10 + [_P] * 5
        lib.anr_fused_topk_f32.argtypes = floats
        lib.anr_fused_topk_bf16.argtypes = floats
        # q, q scales, values, scales, mask; B N D k bq splits per
        # tau_splits tau_per; workspace, out_v, out_i, tau_out, stream.
        lib.anr_fused_topk_int8.argtypes = [_P] * 5 + [_I] * 9 + [_P] * 5
        for fn in (lib.anr_fused_topk_f32, lib.anr_fused_topk_bf16,
                   lib.anr_fused_topk_int8):
            fn.restype = _I
        lib.anr_topk_tile_docs.argtypes = []
        lib.anr_topk_tile_docs.restype = _I
        lib.anr_int8_smem_bytes.argtypes = [_I, _I, _I]
        lib.anr_float_smem_bytes.argtypes = [_I] * 5
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
                     qres: bool) -> int:
    """The same for a K1 or K3 CTA over ``rows`` ("bfloat16" or
    "float32"), its query block resident or streamed."""
    return int(_library().anr_float_smem_bytes(
        bq, d, int(rows == "bfloat16"), int(qres), k))


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
def _fused_plans(n: int, b: int, d: int, k: int, sms: int, rows: str):
    """(plan, resident query block, (tau splits, tau rows per split))."""
    plan = topk_plan.fused_plan(n, b, d, k, sms, rows)
    return (plan, topk_plan.resident(plan.bq, d, k, rows),
            topk_plan.tau_fused_plan(n, b, d, k, sms, rows))


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


def _float_scores(emb: torch.Tensor, queries: torch.Tensor,
                  mask: Optional[torch.Tensor] = None):
    """K1's scores of documents [s0, s1): f32 (both operands upcast),
    masked documents at -inf."""
    q = queries.to(torch.float32)

    def scores(s0: int, s1: int) -> torch.Tensor:
        s = q @ emb[s0:s1].to(torch.float32).T
        if mask is not None:
            s = torch.where(mask[s0:s1][None, :], s, float("-inf"))
        return s

    return scores


def _int8_scores(values: torch.Tensor, scales: torch.Tensor,
                 q_values: torch.Tensor,
                 mask: Optional[torch.Tensor] = None):
    """K2's selection scores float(acc) * doc_scale, masked at -inf."""

    def scores(s0: int, s1: int) -> torch.Tensor:
        acc = int8_dot(q_values, values[s0:s1])
        s = acc.to(torch.float32) * scales[s0:s1][None, :]
        if mask is not None:
            s = torch.where(mask[s0:s1][None, :], s, float("-inf"))
        return s

    return scores


def fused_dense_top_k_torch(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: f32 scores (both operands upcast),
    masked docs at -inf, stable selection."""
    return _plain_top_k(_float_scores(emb, queries, mask), emb.shape[0],
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
                             mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of ``subsample_tau_int8``, on the selection scores
    float(acc) * doc scale."""
    rows = torch.arange(0, values.shape[0], TAU_STRIDE, device=values.device)
    s = (int8_dot(q_values, values[rows]).to(torch.float32)
         * scales[rows][None, :])
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
    # The queries are copied to a contiguous f32 block before the launch.
    _check(queries, "queries", (torch.float32, torch.bfloat16), (b, d), dev,
           contiguous=False)
    if mask is not None:
        _check(mask, "mask", (torch.bool,), (n,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, d, b, dev


def _float_call(emb, queries, k, mask, tau_only: bool):
    """Launch K1 (or, ``tau_only``, its tau pass alone) on CUDA tensors."""
    n, d = emb.shape
    b, dev = queries.shape[0], emb.device
    rows = _ROWS[emb.dtype]
    lib = _library()
    q = queries.to(torch.float32).contiguous()
    plan, qres, (tau_splits, tau_per) = _fused_plans(
        n, b, d, k, _sm_count(dev), rows)
    splits = 1 if tau_only else plan.splits
    ws = _workspace(b, k, splits, tau_splits, d, rows == "bfloat16", dev)
    if tau_only:
        out_v, out_i = torch.empty((b,), device=dev), None
    else:
        out_v, out_i = _outputs(b, k, dev)
    fn = (lib.anr_fused_topk_f32 if rows == "float32"
          else lib.anr_fused_topk_bf16)
    with torch.cuda.device(dev):
        _launch(fn, q.data_ptr(), emb.data_ptr(), _ptr(mask), b, n, d, k,
                plan.bq, int(qres), splits, plan.per if not tau_only else
                topk_plan.TN, tau_splits, tau_per, ws.data_ptr(),
                None if tau_only else out_v.data_ptr(), _ptr(out_i),
                out_v.data_ptr() if tau_only else None, device=dev)
    return out_v if tau_only else (out_v, out_i)


def fused_dense_top_k(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: streaming scoring + top-k over emb [N, D] (f32 or bf16) for
    queries [B, D] (f32, or bf16 as the two-tier BM25 tier passes;
    upcast to f32). mask: optional [N] bool, True = candidate."""
    _, _, _, dev = _check_float_call(emb, queries, k, mask)
    if dev.type == "cpu":
        return fused_dense_top_k_torch(emb, queries, k, mask)
    out = _float_call(emb, queries, k, mask, tau_only=False)
    fused_dense_top_k.launches += 1
    return out


fused_dense_top_k.launches = 0


def subsample_tau(emb: torch.Tensor, queries: torch.Tensor, k: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1's exact warm start [B] f32: the k-th best score over rows 0, 64,
    128, ... that the mask keeps, lowered by TAU_SLACK (-inf with fewer
    than k of them): at most the k-th best candidate, so a running list
    seeded with it keeps the same top-k. On CUDA tensors K1's own tau pass
    (the same kernel over the strided rows, no copy of them); on the CPU
    its plain version."""
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: exact int32 dot, selection on
    float(acc) * doc_scale, then * q_scale on the k outputs only."""
    vals, ids = _plain_top_k(_int8_scores(values, scales, q_values, mask),
                             values.shape[0], q_values.shape[0],
                             values.shape[1], k, values.device)
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


def _int8_call(values, scales, q_values, q_scales, k, mask, tau_only: bool):
    """Launch K2 (or, ``tau_only``, its tau pass alone) on CUDA tensors."""
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
                ws.data_ptr(), None if tau_only else out_v.data_ptr(),
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: streaming int8 scoring + top-k. values [N, D] int8 + scales
    [N] f32 (ops.quantized layout); q_values [B, D] int8 + q_scales [B]
    f32; mask: optional [N] bool. Row-major views of any base alignment
    (``values[1:]``) are taken as they are."""
    dev = _check_int8_call(values, scales, q_values, q_scales, k, mask)[3]
    if dev.type == "cpu":
        return fused_dense_top_k_int8_torch(
            values, scales, q_values, q_scales, k, mask
        )
    out = _int8_call(values, scales, q_values, q_scales, k, mask,
                     tau_only=False)
    fused_dense_top_k_int8.launches += 1
    return out


fused_dense_top_k_int8.launches = 0


def subsample_tau_int8(values: torch.Tensor, scales: torch.Tensor,
                       q_values: torch.Tensor, k: int,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``subsample_tau`` for K2, on its selection scores float(acc) * doc
    scale (before the query scale)."""
    dev = _check_int8_call(values, scales, q_values, None, k, mask)[3]
    if dev.type == "cpu":
        return subsample_tau_int8_torch(values, scales, q_values, k, mask)
    return _int8_call(values, scales, q_values, None, k, mask, tau_only=True)
