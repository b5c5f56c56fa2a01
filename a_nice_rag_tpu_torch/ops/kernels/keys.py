"""Order-preserving score keys: CUDA kernels and plain versions.

``xpack_keys`` / ``xpack_values`` replace the key map of the JAX
package's ``test_xpack_key_map_monotone_roundtrip`` (its ``_key_kernel``,
line 433 of the fused-kernel test file, over ``_xpack_scores``,
fused_topk.py:400 of the package's TPU kernels) and its inverse
(``unpack_xpack_vals``, :419): the exact f32 -> int32 key whose integer
order is the float order (-0.0 just below +0.0), bits of negative floats
XORed with 0x7fffffff. The map is its own inverse on 32-bit words, and
both wrappers launch the same kernel.

``bf16_row_reduce`` replaces the four kernels of
``scripts/probe_bf16_fold.py`` (:41, :118): on s = bf16(x [R, W]) (round
to nearest even), per row, (max f32 [R], the lowest column holding it
int32 [R], the max once every column equal to it is replaced by
bf16(-3e38) f32 [R], the column of the max of the packed int32 key
``((key16 - 0x8000) << 16) | (W - 1 - col)`` int32 [R]). W <= 65536.

All in ``csrc/keys.cu``; exact, so the kernels equal their plain versions
bit for bit. On CUDA tensors each wrapper launches its kernel or raises;
it takes its plain PyTorch version only for tensors on the CPU.
``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import _I, _P, _launch
from a_nice_rag_tpu_torch.ops.kernels.stream import sm_grid

MAX_WIDTH = 1 << 16
_FLIP = 0x7FFFFFFF
_MASKED = -3e38  # bf16-rounded, the probe's mask value

RowReduce = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = _build.load("keys")
    if not hasattr(lib, "_anr_bound"):
        flip = [_P, _P, ctypes.c_longlong, _I, _P]
        lib.anr_xpack_keys.argtypes = flip
        lib.anr_xpack_values.argtypes = flip
        lib.anr_bf16_row_reduce.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P]
        for fn in (lib.anr_xpack_keys, lib.anr_xpack_values,
                   lib.anr_bf16_row_reduce):
            fn.restype = _I
        lib._anr_bound = True
    return lib


def _check_flat(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def xpack_keys_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``xpack_keys``."""
    i = x.view(torch.int32)
    return torch.where(i >= 0, i, torch.bitwise_xor(i, _FLIP))


def xpack_values_torch(keys: torch.Tensor) -> torch.Tensor:
    """Plain version of ``xpack_values``."""
    i = torch.where(keys >= 0, keys, torch.bitwise_xor(keys, _FLIP))
    return i.view(torch.float32)


def _flip(fn_name: str, src: torch.Tensor, dtype: torch.dtype):
    dev = src.device
    out = torch.empty(src.shape, dtype=dtype, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        _launch(getattr(lib, fn_name), src.data_ptr(), out.data_ptr(),
                src.numel(), sm_grid(dev), device=dev)
    return out


def xpack_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of a contiguous float32 tensor, same shape."""
    _check_flat(x, "x", torch.float32)
    if x.device.type == "cpu":
        return xpack_keys_torch(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _flip("anr_xpack_keys", x, torch.int32)
    xpack_keys.launches += 1
    return out


xpack_keys.launches = 0


def xpack_values(keys: torch.Tensor) -> torch.Tensor:
    """The float32 values of contiguous int32 keys (exact inverse)."""
    _check_flat(keys, "keys", torch.int32)
    if keys.device.type == "cpu":
        return xpack_values_torch(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    out = _flip("anr_xpack_values", keys, torch.float32)
    xpack_values.launches += 1
    return out


xpack_values.launches = 0


def _check_rows(x: torch.Tensor) -> None:
    _check_flat(x, "x", torch.float32)
    if x.ndim != 2 or not 1 <= x.shape[1] <= MAX_WIDTH or x.shape[0] < 1:
        raise ValueError(f"need x [R, W] with R >= 1 and 1 <= W <= "
                         f"{MAX_WIDTH}, got {tuple(x.shape)}")


def bf16_row_reduce_torch(x: torch.Tensor) -> RowReduce:
    """Plain version of ``bf16_row_reduce``."""
    _check_rows(x)
    w = x.shape[1]
    s = x.to(torch.bfloat16)
    top = s.amax(dim=1)
    at_top = s == top[:, None]
    col = torch.arange(w, device=x.device)
    arg = torch.where(at_top, col, w).amin(dim=1)
    masked = torch.tensor(_MASKED, device=x.device).to(torch.bfloat16)
    second = torch.where(at_top, masked, s).amax(dim=1)
    u = s.view(torch.int16).to(torch.int32) & 0xFFFF
    key = torch.where(u >= 0x8000, 0xFFFF - u, u + 0x8000) - 0x8000
    packed = (key * 65536) | (w - 1 - col)  # key << 16, no overflow
    packed_arg = (w - 1) - (packed.amax(dim=1) & 0xFFFF)
    return (top.to(torch.float32), arg.to(torch.int32),
            second.to(torch.float32), packed_arg.to(torch.int32))


def bf16_row_reduce(x: torch.Tensor) -> RowReduce:
    """(max, its lowest column, max after masking it, packed-key argmax)
    of each row of bf16(x), x [R, W] float32 contiguous."""
    _check_rows(x)
    if x.device.type == "cpu":
        return bf16_row_reduce_torch(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    r, w = x.shape
    dev = x.device
    top = torch.empty((r,), dtype=torch.float32, device=dev)
    arg = torch.empty((r,), dtype=torch.int32, device=dev)
    second = torch.empty((r,), dtype=torch.float32, device=dev)
    packed_arg = torch.empty((r,), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        _launch(lib.anr_bf16_row_reduce, x.data_ptr(), r, w, top.data_ptr(),
                arg.data_ptr(), second.data_ptr(), packed_arg.data_ptr(),
                device=dev)
    bf16_row_reduce.launches += 1
    return top, arg, second, packed_arg


bf16_row_reduce.launches = 0
