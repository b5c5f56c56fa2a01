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
"""

from __future__ import annotations

import ctypes

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    _I,
    _P,
    _check,
    _launch,
    _split_plan,
)
from a_nice_rag_tpu_torch.ops.quantized import int8_dot

UNPACKS = ("mask", "shift")
TILE_DOCS = 128  # TN of csrc/int4.cu
_INT32_MIN = -(2**31)
# Plain versions unpack and multiply at most this many documents at once.
_PLAIN_CHUNK_ROWS = 1 << 18


def _library() -> ctypes.CDLL:
    lib = _build.load("int4")
    if not hasattr(lib, "_anr_bound"):
        lib.anr_int4_scores.argtypes = [_P, _P] + [_I] * 6 + [_P, _P]
        lib.anr_int4_fold_max.argtypes = [_P, _P] + [_I] * 6 + [_P, _P]
        lib.anr_int8_fold_max.argtypes = [_P, _P] + [_I] * 5 + [_P, _P]
        for fn in (lib.anr_int4_scores, lib.anr_int4_fold_max,
                   lib.anr_int8_fold_max):
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


def _plan(n: int, b: int, dev: torch.device):
    return _split_plan(n, b, dev, TILE_DOCS)


def int4_scores(q8: torch.Tensor, packed: torch.Tensor,
                unpack: str = "mask") -> torch.Tensor:
    """The exact int32 [B, N] product of q8 [B, D] and packed [N, D/2]."""
    _check_unpack(unpack)
    n, d, b, dev = _check_packed(q8, packed)
    if dev.type == "cpu":
        return int4_scores_torch(q8, packed, unpack)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _aligned(q8, packed)
    splits, per = _plan(n, b, dev)
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(_library().anr_int4_scores, q8.data_ptr(), packed.data_ptr(),
                b, n, d, int(unpack == "shift"), splits, per, out.data_ptr(),
                device=dev)
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
    _aligned(q8, packed)
    splits, per = _plan(n, b, dev)
    out = torch.full((b,), _INT32_MIN, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(_library().anr_int4_fold_max, q8.data_ptr(),
                packed.data_ptr(), b, n, d, int(unpack == "shift"), splits,
                per, out.data_ptr(), device=dev)
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
    _aligned(q8, e8)
    splits, per = _plan(n, b, dev)
    out = torch.full((b,), _INT32_MIN, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(_library().anr_int8_fold_max, q8.data_ptr(), e8.data_ptr(),
                b, n, d, splits, per, out.data_ptr(), device=dev)
    int8_fold_max.launches += 1
    return out


int8_fold_max.launches = 0
