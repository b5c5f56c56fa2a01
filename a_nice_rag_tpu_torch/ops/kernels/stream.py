"""Stream sums: CUDA kernels and plain versions.

``stream_sum`` replaces the stream-floor TPU kernels of the repository:
``_sum_kernel`` of ``bench.py`` (:219, launched at :226) and the four
sums of ``scripts/probe_hbm_stream.py`` (:57, :108, :154 and :206: one,
two or m matrices, the last seeded by a scalar operand).
``stream_sum_busy`` replaces ``scripts/probe_dma_overlap.py``'s kernel
(:45): the same stream plus independent ALU work per tile. Both kernels
are in ``csrc/stream_sum.cu``; ``stream_sum`` is one launch a call, its
partials and ticket in a buffer kept per (device, grid, stream). On CUDA
tensors each wrapper launches its kernel or raises; it takes its plain
PyTorch version only for tensors on the CPU. ``.launches`` on each
wrapper counts kernel launches.

Contracts:

- ``stream_sum(parts, bias=None)``: the float32 sum of every element of
  1 to 8 contiguous tensors of one dtype (float32, bfloat16 or int8),
  plus an optional float32 scalar ``bias``; a 0-d float32 tensor. Each
  element is read once. The kernel sums in float32 in its own order, so
  it agrees with the plain version within about 1e-5 of the sum of
  absolute values (exactly for int8 data whose partial sums all stay
  below 2^24).
- ``stream_sum_busy(emb, seed, x_iters, grid, tile_rows)``: ``seed`` +
  the sum of ``emb`` [N, D], walked in tiles of ``tile_rows`` rows, tile
  t on CTA t mod ``grid``; and ``work`` [grid] float32: CTA c's chain
  w = 1.000001, stepped w <- w * 1.000001 + 1e-9 in float32 (product and
  sum each rounded) ``x_iters`` times for every tile it visits. The
  plain version recomputes every chain bit for bit on the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import _I, _P, _launch, _ptr

MAX_PARTS = 8
UNROLLS = (1, 2, 4, 8)  # 16-byte loads in flight per thread
CTAS_PER_SM = 4
UNROLL = 8
BUSY_TILE_ROWS = 16
# A 16-row bf16 tile of 256 columns is 512 vectors: two per thread.
_BUSY_UNROLL = 2
_CHAIN_START = np.float32(1.000001)
_CHAIN_MUL = np.float32(1.000001)
_CHAIN_ADD = np.float32(1e-9)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# The plain version upcasts at most this many elements at a time, so the
# 10.7 GB int8 matrix is never upcast whole.
_PLAIN_CHUNK_ELEMS = 1 << 25
_LL = ctypes.c_longlong

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]


def _library() -> ctypes.CDLL:
    lib = _build.load("stream_sum")
    if not hasattr(lib, "_anr_bound"):
        lib.anr_stream_sum.argtypes = [
            _I, _I, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(_LL),
            _P, _P, _P, _I, _I, _P]
        lib.anr_stream_sum1.argtypes = [
            _I, _P, _LL, _P, _P, _P, _I, _I, _P]
        lib.anr_stream_sum_busy.argtypes = [
            _I, _P, _LL, _LL, _I, _P, _P, _P, _P, _I, _I, _P]
        lib.anr_stream_sum.restype = _I
        lib.anr_stream_sum1.restype = _I
        lib.anr_stream_sum_busy.restype = _I
        lib._anr_bound = True
    return lib


@functools.lru_cache(maxsize=16)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def sm_grid(device: torch.device, ctas_per_sm: int = CTAS_PER_SM) -> int:
    """A grid of ``ctas_per_sm`` CTAs on every SM of a CUDA device."""
    return ctas_per_sm * _sms(device)


# (device index, grid, stream) -> [grid] float32 partials and the ticket
# (one int32, zero between calls: the kernel's last CTA sets it back),
# kept across calls; calls on one stream run one after another.
_scratch: Dict[Tuple[int, int, int], torch.Tensor] = {}
# Device index -> the 0-d outputs still to hand out, views of one buffer
# allocated OUT_BATCH at a time (each handed out once, so a result stays
# valid while it is referenced); the wrapper's host time counts in a call.
OUT_BATCH = 256
_outs: Dict[int, Iterator[torch.Tensor]] = {}


def _scratch_ptr(index: int, grid: int, stream: int) -> int:
    key = (index, grid, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros((grid + 1,), dtype=torch.float32,
                                          device=torch.device("cuda", index))
    return buf.data_ptr()


def _next_out(index: int) -> torch.Tensor:
    out = next(_outs.get(index, iter(())), None)
    if out is None:
        batch = torch.empty((OUT_BATCH,), dtype=torch.float32,
                            device=torch.device("cuda", index))
        _outs[index] = iter(batch.unbind())
        out = next(_outs[index])
    return out


def _as_parts(parts: Parts) -> Tuple[list, torch.device]:
    parts = [parts] if isinstance(parts, torch.Tensor) else list(parts)
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"need 1 to {MAX_PARTS} tensors, got {len(parts)}")
    dtype, dev = parts[0].dtype, parts[0].device
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {dtype} not in {tuple(_DTYPE_CODES)}")
    if not parts[0].is_contiguous():
        raise ValueError("part 0 must be contiguous")
    for i, p in enumerate(parts[1:], 1):
        if p.dtype != dtype:
            raise TypeError(f"part {i}: dtype {p.dtype} != {dtype}")
        if p.device != dev:
            raise ValueError(f"part {i} is on {p.device}, expected {dev}")
        if not p.is_contiguous():
            raise ValueError(f"part {i} must be contiguous")
    return parts, dev


def _check_scalar(t: torch.Tensor, name: str, dev: torch.device) -> None:
    if t.dtype != torch.float32 or t.numel() != 1 or t.device != dev:
        raise ValueError(f"{name} must be one float32 value on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _chunks(parts: list) -> Iterator[torch.Tensor]:
    for p in parts:
        flat = p.reshape(-1)
        for s0 in range(0, flat.numel(), _PLAIN_CHUNK_ELEMS):
            yield flat[s0:s0 + _PLAIN_CHUNK_ELEMS]


def _chunk_total(chunk: torch.Tensor) -> torch.Tensor:
    if chunk.dtype == torch.int8:
        return chunk.sum(dtype=torch.int64).to(torch.float64)
    return chunk.to(torch.float64).sum()


def abs_total(parts: Parts) -> float:
    """The sum of absolute values of every element (float64, chunked): the
    scale of the kernel's float32 rounding."""
    parts, dev = _as_parts(parts)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for chunk in _chunks(parts):
        total += _chunk_total(chunk.abs())
    return float(total)


def stream_sum_torch(parts: Parts,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``stream_sum``: the sum in float64 (int8 chunks
    exactly in int64), one chunk of elements upcast at a time, plus the
    bias, rounded once to float32."""
    parts, dev = _as_parts(parts)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for chunk in _chunks(parts):
        total += _chunk_total(chunk)
    if bias is not None:
        _check_scalar(bias, "bias", dev)
        total += bias.reshape(()).to(torch.float64)
    return total.to(torch.float32)


def stream_sum(parts: Parts, bias: Optional[torch.Tensor] = None, *,
               ctas_per_sm: int = CTAS_PER_SM,
               unroll: int = UNROLL) -> torch.Tensor:
    """The float32 sum of 1 to 8 contiguous tensors of one dtype (float32,
    bfloat16 or int8), each read once, plus an optional float32 scalar
    ``bias``. Launch shape on the card: one launch of ``ctas_per_sm``
    CTAs on every SM, ``unroll`` 16-byte loads in flight per thread."""
    parts, dev = _as_parts(parts)
    if bias is not None:
        _check_scalar(bias, "bias", dev)
    if unroll not in UNROLLS or ctas_per_sm < 1:
        raise ValueError(f"unroll must be in {UNROLLS} and ctas_per_sm >= 1, "
                         f"got {unroll}, {ctas_per_sm}")
    if not parts[0].is_cuda:
        if dev.type == "cpu":
            return stream_sum_torch(parts, bias)
        raise ValueError(f"unsupported device {dev}")
    # This wrapper's host time counts in a call's time: no Stream object,
    # no device switch unless needed, outputs handed out from a batch.
    lib = _library()
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    grid = sm_grid(dev, ctas_per_sm)
    stream = torch._C._cuda_getCurrentRawStream(index)
    out = _next_out(index)
    code = _DTYPE_CODES[parts[0].dtype]
    if len(parts) == 1:
        fn, head = lib.anr_stream_sum1, (code, parts[0].data_ptr(),
                                         parts[0].numel())
    else:
        m = len(parts)
        fn, head = lib.anr_stream_sum, (
            code, m, (ctypes.c_void_p * m)(*[p.data_ptr() for p in parts]),
            (_LL * m)(*[p.numel() for p in parts]))
    args = (_ptr(bias), _scratch_ptr(index, grid, stream), out.data_ptr(),
            grid, unroll, stream)
    if index == current:
        err = fn(*head, *args)
    else:
        with torch.cuda.device(index):
            err = fn(*head, *args)
    if err != 0:
        raise RuntimeError(f"anr_stream_sum failed with cudaError_t {err}")
    stream_sum.launches += 1
    return out


stream_sum.launches = 0


def busy_chain(steps: int) -> np.float32:
    """The chain's value after ``steps`` steps, in float32 on the host."""
    w = _CHAIN_START
    for _ in range(steps):
        w = np.float32(w * _CHAIN_MUL) + _CHAIN_ADD
    return w


def _check_busy(emb, seed, x_iters, grid, tile_rows):
    (emb,), dev = _as_parts(emb)
    if emb.ndim != 2:
        raise ValueError(f"emb must be [N, D], got {tuple(emb.shape)}")
    _check_scalar(seed, "seed", dev)
    if x_iters < 0 or grid < 1 or tile_rows < 1:
        raise ValueError(f"need x_iters >= 0, grid >= 1 and tile_rows >= 1, "
                         f"got {x_iters}, {grid}, {tile_rows}")
    return emb, dev


def stream_sum_busy_torch(
    emb: torch.Tensor, seed: torch.Tensor, x_iters: int, grid: int,
    tile_rows: int = BUSY_TILE_ROWS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``stream_sum_busy``: ``stream_sum_torch`` for the
    sum, and each CTA's chain recomputed on the host from the number of
    tiles t with t mod grid == c."""
    emb, dev = _check_busy(emb, seed, x_iters, grid, tile_rows)
    n_tiles = -(-emb.shape[0] // tile_rows)
    per, extra = divmod(n_tiles, grid)
    lo = busy_chain(per * x_iters)
    hi = busy_chain((per + 1) * x_iters) if extra else lo
    work = np.full(grid, lo, dtype=np.float32)
    work[:extra] = hi
    return (stream_sum_torch(emb, seed),
            torch.as_tensor(work, device=dev))


def stream_sum_busy(
    emb: torch.Tensor, seed: torch.Tensor, x_iters: int, grid: int,
    tile_rows: int = BUSY_TILE_ROWS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(seed + the sum of emb [N, D], work [grid]): the stream in tiles of
    ``tile_rows`` rows, tile t on CTA t mod ``grid``, each CTA stepping
    its float32 chain ``x_iters`` times per tile it visits."""
    emb, dev = _check_busy(emb, seed, x_iters, grid, tile_rows)
    if dev.type == "cpu":
        return stream_sum_busy_torch(emb, seed, x_iters, grid, tile_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    partials = torch.empty((grid,), dtype=torch.float32, device=dev)
    work = torch.empty((grid,), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(lib.anr_stream_sum_busy, _DTYPE_CODES[emb.dtype],
                emb.data_ptr(), emb.numel(), tile_rows * emb.shape[1],
                x_iters, seed.data_ptr(), partials.data_ptr(),
                work.data_ptr(), out.data_ptr(), grid, _BUSY_UNROLL,
                device=dev)
    stream_sum_busy.launches += 1
    return out, work


stream_sum_busy.launches = 0
