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
bit for bit. The key map is one launch for any size and storage offset
(none for an empty tensor): a grid-stride stream of 16-byte vectors on
the input's 16-byte grid, ``KEY_UNROLL`` loads in flight a thread, the
words before the first boundary and after the last vector taken by
threads of the same launch (``key_plan``). The output lies on the
input's 16-byte phase (for a view such as ``x[1:]``, a view as many
words into its own buffer), so the body's stores are 16 bytes too.
``bf16_row_reduce`` is one pass over each row, one CTA a row
(``row_plan``). Both wrappers keep their host work light (one output
allocation, the raw current stream, no device switch when the device is
current), since the call's host time falls inside its event pair. On
CUDA tensors each wrapper launches its kernel or raises; it takes its
plain PyTorch version only for tensors on the CPU. ``.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels._launches import count_launch
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import _I, _P
from a_nice_rag_tpu_torch.ops.kernels.stream import _sms

MAX_WIDTH = 1 << 16
# The key map's launch (key_plan): 16-byte loads in flight a thread and
# CTAs of KEY_THREADS on each SM, chosen by probes/key_map.py's sweep.
KEY_UNROLL, KEY_CTAS_PER_SM, KEY_THREADS = 8, 8, 256
KEY_UNROLLS = (4, 8)
# bf16_row_reduce's 16-byte loads in flight a thread (row_plan).
ROW_UNROLL = 8
_FLIP = 0x7FFFFFFF
_MASKED = -3e38  # bf16-rounded, the probe's mask value

RowReduce = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = _build.load("keys")
    if not hasattr(lib, "_anr_bound"):
        flip = [_P, _P, ctypes.c_longlong, _I, _I, _I, _P]
        lib.anr_xpack_keys.argtypes = flip
        lib.anr_xpack_values.argtypes = flip
        lib.anr_bf16_row_reduce.argtypes = [_P, _I, _I, _I, _P, _P]
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


class KeyPlan(NamedTuple):
    """The key map's launch over n 32-bit words: ``head`` words before the
    input's first 16-byte boundary, then ``vectors`` whole 16-byte vectors,
    then ``tail`` words; ``unroll`` vector loads in flight a thread, a grid
    of ``grid`` CTAs of ``KEY_THREADS``."""

    head: int
    vectors: int
    tail: int
    unroll: int
    grid: int


def key_plan(n: int, offset: int, sms: int, unroll: int = KEY_UNROLL,
             ctas_per_sm: int = KEY_CTAS_PER_SM) -> KeyPlan:
    """The launch over ``n`` words whose first lies ``offset`` words (0-3)
    past a 16-byte boundary, on a card of ``sms`` SMs: ``ctas_per_sm`` CTAs
    on each, fewer where the vectors do not need them."""
    if n < 0 or not 0 <= offset <= 3 or unroll not in KEY_UNROLLS:
        raise ValueError(f"key_plan: n {n}, offset {offset}, unroll "
                         f"{unroll}")
    head = min(n, -offset % 4)
    vectors = (n - head) // 4
    per_cta = KEY_THREADS * unroll
    grid = max(1, min(ctas_per_sm * sms, -(-vectors // per_cta)))
    return KeyPlan(head, vectors, n - head - 4 * vectors, unroll, grid)


def _flip(wrapper, fn_name: str, src: torch.Tensor, dtype: torch.dtype,
          plan: Optional[KeyPlan] = None) -> torch.Tensor:
    """The key map of ``src`` into a new tensor of ``dtype`` on its 16-byte
    phase: one launch (``plan``, default ``key_plan``'s), none for an
    empty ``src``."""
    n, ptr, dev = src.numel(), src.data_ptr(), src.device
    offset = ptr % 16 // 4
    if offset:
        out = torch.empty(offset + n, dtype=dtype, device=dev)[offset:]
        out = out.view(src.shape)
    else:
        out = torch.empty(src.shape, dtype=dtype, device=dev)
    if n == 0:
        return out
    index = dev.index
    if plan is None:
        plan = key_plan(n, offset, _sms(dev))
    args = (ptr, out.data_ptr(), n, plan.head, plan.unroll, plan.grid,
            torch._C._cuda_getCurrentRawStream(index))
    fn = getattr(_library(), fn_name)
    if index == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with cudaError_t {err}")
    count_launch(wrapper)
    return out


def xpack_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of a contiguous float32 tensor, same shape."""
    _check_flat(x, "x", torch.float32)
    if x.device.type == "cpu":
        return xpack_keys_torch(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _flip(xpack_keys, "anr_xpack_keys", x, torch.int32)


xpack_keys.launches = 0


def xpack_values(keys: torch.Tensor) -> torch.Tensor:
    """The float32 values of contiguous int32 keys (exact inverse)."""
    _check_flat(keys, "keys", torch.int32)
    if keys.device.type == "cpu":
        return xpack_values_torch(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    return _flip(xpack_values, "anr_xpack_values", keys, torch.float32)


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


def row_plan(width: int) -> int:
    """Threads of ``bf16_row_reduce``'s CTA for each row of ``width``
    columns: 256, or 512 where 256 threads would hold more than
    ``ROW_UNROLL`` of the row's 16-byte vectors each."""
    return 512 if width // 4 > ROW_UNROLL * 256 else 256


def bf16_row_reduce(x: torch.Tensor) -> RowReduce:
    """(max, its lowest column, max after masking it, packed-key argmax)
    of each row of bf16(x), x [R, W] float32 contiguous."""
    _check_rows(x)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return bf16_row_reduce_torch(x)
        raise ValueError(f"unsupported device {x.device}")
    # This wrapper's host time counts in a call's time: one allocation
    # whose rows are the four outputs, no Stream object, no device switch
    # unless needed.
    r, w = x.shape
    dev = x.device
    index = dev.index
    out = torch.empty((4, r), dtype=torch.int32, device=dev)
    args = (x.data_ptr(), r, w, row_plan(w), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    fn = _library().anr_bf16_row_reduce
    if index == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"anr_bf16_row_reduce failed with cudaError_t "
                           f"{err}")
    count_launch(bf16_row_reduce)
    top, arg, second, packed_arg = out.unbind()
    return top.view(torch.float32), arg, second.view(torch.float32), packed_arg


bf16_row_reduce.launches = 0
