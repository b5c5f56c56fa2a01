"""Fused dense scoring + streaming top-k: CUDA kernels and plain versions.

``fused_dense_top_k`` (K1, f32/bf16 rows) and ``fused_dense_top_k_int8``
(K2, int8 rows with per-row scales) replace the TPU kernels of the same
names in the JAX package (``a_nice_rag_tpu.ops``, fused_topk.py:1440 and
:1218). On CUDA tensors each wrapper
launches its kernel from ``csrc/fused_topk.cu`` or raises; it takes its
plain PyTorch version only for tensors on the CPU. ``.launches`` on each
wrapper counts kernel launches, so a run can show which path it took.

K1 scores in f32 on the CUDA cores, 64 queries per CTA. K2 scores on the
int8 tensor cores (``csrc/int8_mma.cuh``): each CTA holds its query block
(16 queries for B <= 16, else 64) in shared memory for its whole doc
range, and streams the doc tiles through a ring of 16-byte asynchronous
copies; ``int8_plan.fused_plan`` picks the block and the doc splits.

Contract: values [B, k] f32 descending and ids [B, k] int32 under the tie
rule (score desc, doc id asc); masked documents are never candidates and
unfilled slots hold (-inf, -1). k <= 128; B, N and D take any size (K2: D
up to the depth whose 16-query block fits in a CTA's shared memory, about
9,800), and rows of any alignment.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build, int8_plan
from a_nice_rag_tpu_torch.ops.quantized import int8_dot

K_MAX = 128
_BLOCK_Q = 64  # queries per CTA of the float kernels (K1, K3)
_CTAS_PER_SM = 3
H100_SMS = 132
# Plain versions score at most this many [B, chunk] scores, and upcast at
# most this many [chunk, D] elements, at a time: a 10.7 GB int8 matrix is
# never upcast whole.
_PLAIN_CHUNK_ELEMS = 1 << 27

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_topk")
    if not hasattr(lib, "_anr_bound"):
        common = [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.anr_fused_topk_f32.argtypes = [_P, _P, _P] + common
        lib.anr_fused_topk_bf16.argtypes = [_P, _P, _P] + common
        # q, q scales, values, scales, mask; B N D k bq splits per;
        # outputs, stream.
        lib.anr_fused_topk_int8.argtypes = [_P] * 5 + [_I] * 7 + [_P] * 5
        for fn in (lib.anr_fused_topk_f32, lib.anr_fused_topk_bf16,
                   lib.anr_fused_topk_int8):
            fn.restype = _I
        lib.anr_topk_tile_docs.argtypes = []
        lib.anr_topk_tile_docs.restype = _I
        lib.anr_int8_smem_bytes.argtypes = [_I, _I, _I]
        lib.anr_int8_smem_bytes.restype = ctypes.c_longlong
        lib._anr_bound = True
    return lib


def int8_smem_bytes(bq: int, d: int, k: int) -> int:
    """The dynamic shared memory of a K2 or K4 CTA, as the source
    computes it (``int8_plan.smem_bytes`` must agree)."""
    return int(_library().anr_int8_smem_bytes(bq, d, k))


def _sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device; for the CPU, an H100's, so plain versions
    that follow the kernels' split plan reproduce the card's."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def _split_plan(n: int, b: int, device: torch.device,
                tile: int) -> Tuple[int, int]:
    """(splits, docs per split) of the float kernels: enough doc splits
    that the grid puts more than two CTAs on each SM; each split a whole
    number of tiles."""
    sms = _sm_count(device)
    q_blocks = -(-b // _BLOCK_Q)
    tiles = -(-n // tile)
    splits = min(max(1, -(-_CTAS_PER_SM * sms // q_blocks)), tiles)
    per_split = -(-tiles // splits) * tile
    return -(-n // per_split), per_split


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


def _outputs(b: int, k: int, splits: int, device: torch.device):
    return (
        torch.empty((b, splits, k), dtype=torch.float32, device=device),
        torch.empty((b, splits, k), dtype=torch.int32, device=device),
        torch.empty((b, k), dtype=torch.float32, device=device),
        torch.empty((b, k), dtype=torch.int32, device=device),
    )


def _chunk_rows(b: int, d: int) -> int:
    """Documents per block of a plain version (see _PLAIN_CHUNK_ELEMS)."""
    return max(1, _PLAIN_CHUNK_ELEMS // max(b, d, 1))


def _plain_top_k(
    score_chunk: Callable[[int, int], torch.Tensor],
    n: int, b: int, d: int, k: int, device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over [B, chunk] f32 score blocks in doc order.

    The running list (earlier, lower ids) sits before each new block and
    the sort is stable, so equal scores keep the lower id first.
    """
    run_v = torch.full((b, k), float("-inf"), device=device)
    run_i = torch.full((b, k), -1, dtype=torch.int64, device=device)
    chunk = _chunk_rows(b, d)
    for s0 in range(0, n, chunk):
        s1 = min(n, s0 + chunk)
        cat_v = torch.cat([run_v, score_chunk(s0, s1)], dim=1)
        ids = torch.arange(s0, s1, device=device).expand(b, -1)
        cat_i = torch.cat([run_i, ids], dim=1)
        v, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
        run_v = v[:, :k]
        run_i = torch.take_along_dim(cat_i, pos[:, :k], dim=1)
    run_i = torch.where(torch.isneginf(run_v), -1, run_i)
    return run_v, run_i.to(torch.int32)


def fused_dense_top_k_torch(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: f32 scores (both operands upcast),
    masked docs at -inf, stable selection."""
    n = emb.shape[0]
    q = queries.to(torch.float32)

    def scores(s0: int, s1: int) -> torch.Tensor:
        s = q @ emb[s0:s1].to(torch.float32).T
        if mask is not None:
            s = torch.where(mask[s0:s1][None, :], s, float("-inf"))
        return s

    return _plain_top_k(scores, n, q.shape[0], emb.shape[1], k, emb.device)


def fused_dense_top_k(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: streaming f32 scoring + top-k over emb [N, D] (f32 or bf16)
    for queries [B, D] (f32, or bf16 as the two-tier BM25 tier passes;
    upcast to f32). mask: optional [N] bool, True = candidate."""
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
    if dev.type == "cpu":
        return fused_dense_top_k_torch(emb, queries, k, mask)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    q = queries.to(torch.float32).contiguous()
    splits, per_split = _split_plan(n, b, dev, lib.anr_topk_tile_docs())
    part_v, part_i, out_v, out_i = _outputs(b, k, splits, dev)
    fn = (lib.anr_fused_topk_f32 if emb.dtype == torch.float32
          else lib.anr_fused_topk_bf16)
    with torch.cuda.device(dev):
        _launch(fn, q.data_ptr(), emb.data_ptr(), _ptr(mask), b, n, d, k,
                splits, per_split, part_v.data_ptr(), part_i.data_ptr(),
                out_v.data_ptr(), out_i.data_ptr(), device=dev)
    fused_dense_top_k.launches += 1
    return out_v, out_i


fused_dense_top_k.launches = 0


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
    n = values.shape[0]

    def scores(s0: int, s1: int) -> torch.Tensor:
        acc = int8_dot(q_values, values[s0:s1])
        s = acc.to(torch.float32) * scales[s0:s1][None, :]
        if mask is not None:
            s = torch.where(mask[s0:s1][None, :], s, float("-inf"))
        return s

    vals, ids = _plain_top_k(scores, n, q_values.shape[0], values.shape[1],
                             k, values.device)
    vals = torch.where(ids < 0, float("-inf"), vals * q_scales[:, None])
    return vals, ids


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
    _check(q_scales, "q_scales", (torch.float32,), (b,), dev)
    if mask is not None:
        _check(mask, "mask", (torch.bool,), (n,), dev)
    if dev.type == "cpu":
        return fused_dense_top_k_int8_torch(
            values, scales, q_values, q_scales, k, mask
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    plan = int8_plan.fused_plan(n, b, d, k, _sm_count(dev))
    part_v, part_i, out_v, out_i = _outputs(b, k, plan.splits, dev)
    with torch.cuda.device(dev):
        _launch(lib.anr_fused_topk_int8, q_values.data_ptr(),
                q_scales.data_ptr(), values.data_ptr(), scales.data_ptr(),
                _ptr(mask), b, n, d, k, *plan,
                part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
                out_i.data_ptr(), device=dev)
    fused_dense_top_k_int8.launches += 1
    return out_v, out_i


fused_dense_top_k_int8.launches = 0
