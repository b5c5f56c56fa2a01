"""BM25's sparse top-k: a CUDA kernel and its plain version.

``bm25_sparse_top_k`` computes what ``ops.bm25.bm25_top_k_sparse``
computes, from the same postings and with the same tie rule, without
sorting: each query row's fetched postings are totalled per document in
shared-memory doc slabs of 2^shift documents, and the k best totals are
picked by a radix select over (score desc, id asc) keys
(``csrc/bm25_sparse.cu``, three launches a call: the counted spans and
slab boundaries, the slabs, each row's final k). It needs each term's
postings strictly ascending by document id (``postings_ascend``, checked
once per ``Bm25Arrays`` object and cached).

Which postings count (``counted_spans``): slot j of row b takes the
first n_bj postings of its term, n_bj = min(df, budget - the postings of
the slots before j) clamped at 0 on the flat fetch, min(df, df_cap) on
the window fetch, 0 for term id -1. A document total is the float32 sum
of its impacts in slot order, so it rounds at most T - 1 times (the
torch route's prefix-sum difference errs by about P eps); on integer
impacts both are exact and the lists are equal. Documents >= the dump
row ``n_docs_padded`` and documents masked out never list; a document
lists only if it has a counted posting. Returns (scores [B, k] f32, ids
[B, k] int32), (-inf, -1) padded.

On CUDA tensors the wrapper launches the kernel or raises; the plain
version, ``bm25_sparse_top_k_torch`` (a scatter-add of each slot's
postings in order into a dense [B, N + 1] total, then a stable top k),
runs only for tensors on the CPU. ``.launches`` counts calls of the
kernel; ``.torch_route`` counts the retriever's calls that the route
rule (``kernel_route``) left on the torch route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.bm25 import _term_ranges
from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels._launches import count_launch
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import K_MAX, _I, _P
from a_nice_rag_tpu_torch.ops.topk import stable_top_k

# Documents of a slab: 2^SLAB_SHIFT (csrc/bm25_sparse.cu takes 12-15;
# at the BEIR-NQ shape on an H100, 2^13 ran 1.14 ms, 2^12 1.22, 2^14
# 1.74: probes/bm25_sparse.py).
SLAB_SHIFT = 13
SLAB_SHIFTS = (12, 13, 14, 15)
MAX_SLABS = 65535  # the slab kernel's grid.y
# The span kernel's CTAs a row: one for every SPAN_POSTINGS postings the
# fetch may hold, at most SPAN_GRID_MAX.
SPAN_POSTINGS = 1 << 15
SPAN_GRID_MAX = 32
_LL = ctypes.c_longlong


class Bm25Plan(NamedTuple):
    """The launch over ``n_slabs`` slabs of 2^``shift`` documents, with
    ``span_grid`` CTAs a row in the span kernel."""

    shift: int
    n_slabs: int
    span_grid: int


def bm25_plan(n_docs: int, fetch_cap: int, shift: int = SLAB_SHIFT
              ) -> Bm25Plan:
    """The plan for ``n_docs`` documents (the padded axis) and a fetch of
    at most ``fetch_cap`` postings a row: slabs of 2^``shift`` documents,
    wider where more than ``MAX_SLABS`` would be needed."""
    if shift not in SLAB_SHIFTS or n_docs < 1:
        raise ValueError(f"bm25_plan: shift {shift}, n_docs {n_docs}")
    while -(-n_docs >> shift) > MAX_SLABS:
        if shift == SLAB_SHIFTS[-1]:
            raise ValueError(f"bm25_plan: {n_docs} documents need more "
                             f"than {MAX_SLABS} slabs")
        shift += 1
    grid = max(1, min(SPAN_GRID_MAX, -(-fetch_cap // SPAN_POSTINGS)))
    return Bm25Plan(shift, -(-n_docs >> shift), grid)


def _library() -> ctypes.CDLL:
    lib = _build.load("bm25_sparse")
    if not hasattr(lib, "_anr_bound"):
        lib.anr_bm25_sparse_top_k.argtypes = [
            _P, _I, _I, _P, _I, _P, _P, _I, _P, _LL, _LL, _LL, _I, _I, _I,
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _P]
        lib.anr_bm25_sparse_top_k.restype = _I
        lib._anr_bound = True
    return lib


def counted_spans(indptr: torch.Tensor, q_terms: torch.Tensor, budget: int,
                  df_cap: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first posting, counted postings) [B, T] int64 of each term slot:
    the postings ``ops.bm25``'s flat fetch (``df_cap`` None) or window
    fetch gathers."""
    starts, dfs = _term_ranges(indptr, q_terms)
    if df_cap is not None:
        return starts, torch.clamp(dfs, max=df_cap)
    before = torch.cumsum(dfs, dim=-1) - dfs
    return starts, torch.clamp(torch.minimum(dfs, budget - before), min=0)


def postings_ascend(bm25) -> bool:
    """Whether every term's postings hold document ids >= 0, strictly
    ascending: checked once per ``Bm25Arrays`` object on its device (one
    host sync) and cached on it."""
    if bm25._postings_ascend is None:
        nnz = bm25.nnz
        ids = bm25.doc_ids[:nnz]
        ok = True
        if nnz > 0:
            step = ids[1:] > ids[:-1]
            first = bm25.indptr[1:-1].long()
            first = first[(first > 0) & (first < nnz)]
            step[first - 1] = True  # a term's first posting follows any id
            ok = bool(step.all() & (ids.min() >= 0))
        bm25._postings_ascend = ok
    return bm25._postings_ascend


def kernel_route(bm25, k: int) -> bool:
    """Whether ``bm25_sparse_top_k``'s kernel takes this call: the CSR
    arrays on a CUDA device, k <= K_MAX and ascending postings."""
    return (bm25.doc_ids.device.type == "cuda" and k <= K_MAX
            and postings_ascend(bm25))


def bm25_sparse_top_k_torch(
    bm25, q_terms: torch.Tensor, k: int, mask: Optional[torch.Tensor] = None,
    budget: int = 16384, df_cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``bm25_sparse_top_k``: slot by slot, a scatter-add
    of the counted postings into a dense [B, N + 1] total (column N the
    dump), then the stable top k of the documents with a counted posting."""
    b, t = q_terms.shape
    n = bm25.n_docs_padded
    dev = bm25.doc_ids.device
    starts, lens = counted_spans(bm25.indptr, q_terms, budget, df_cap)
    acc = torch.zeros((b, n + 1), dtype=torch.float32, device=dev)
    hit = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    for j in range(t):
        width = int(lens[:, j].max()) if b else 0
        if width == 0:
            continue
        pos = torch.arange(width, device=dev)
        keep = pos < lens[:, j, None]
        g = torch.where(keep, starts[:, j, None] + pos, 0)
        ids = bm25.doc_ids[g].long()
        keep &= ids < n
        if mask is not None:
            keep &= mask[torch.clamp(ids, 0, mask.shape[0] - 1)].bool()
        ids = torch.where(keep, ids, n)
        acc.scatter_add_(1, ids, torch.where(keep, bm25.impact[g], 0.0))
        hit.scatter_(1, ids, True)
    score = torch.where(hit[:, :n], acc[:, :n], float("-inf"))
    kk = min(k, n)
    vals, pos = stable_top_k(score, kk)
    ids = torch.where(torch.isfinite(vals), pos, -1).to(torch.int32)
    if kk < k:
        vals = torch.cat([vals, torch.full((b, k - kk), float("-inf"),
                                           device=dev)], 1)
        ids = torch.cat([ids, torch.full((b, k - kk), -1, dtype=torch.int32,
                                         device=dev)], 1)
    return vals, ids


def _check(bm25, q_terms: torch.Tensor, k: int,
           mask: Optional[torch.Tensor]) -> None:
    dev = bm25.doc_ids.device
    if q_terms.ndim != 2:
        raise ValueError(f"q_terms must be [B, T], got {tuple(q_terms.shape)}")
    for name, x, dtypes in (
            ("q_terms", q_terms, (torch.int32,)),
            ("indptr", bm25.indptr, (torch.int32,)),
            ("doc_ids", bm25.doc_ids, (torch.int32,)),
            ("impact", bm25.impact, (torch.float32,)),
            ("mask", mask, (torch.bool, torch.uint8))):
        if x is None:
            continue
        if x.dtype not in dtypes or not x.is_contiguous() or x.device != dev:
            raise TypeError(f"{name}: {x.dtype} on {x.device}, contiguous "
                            f"{x.is_contiguous()}; need one of {dtypes}, "
                            f"contiguous, on {dev}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k = {k}: the kernel takes 1 <= k <= {K_MAX}")
    if mask is not None and (mask.ndim != 1 or mask.numel() < 1):
        raise ValueError(f"mask must be 1-D and not empty, got "
                         f"{tuple(mask.shape)}")


def bm25_sparse_top_k(
    bm25, q_terms: torch.Tensor, k: int, mask: Optional[torch.Tensor] = None,
    budget: int = 16384, df_cap: Optional[int] = None,
    plan: Optional[Bm25Plan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, k] f32, doc ids [B, k] int32) of ``bm25``'s sparse top
    k (``ops.bm25.bm25_top_k_sparse``'s arguments); ``plan`` defaults to
    ``bm25_plan``'s. The postings must ascend (``postings_ascend``)."""
    dev = bm25.doc_ids.device
    if dev.type == "cpu":
        return bm25_sparse_top_k_torch(bm25, q_terms, k, mask, budget,
                                       df_cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(bm25, q_terms, k, mask)
    b, t = q_terms.shape
    n = bm25.n_docs_padded
    if plan is None:
        plan = bm25_plan(n, t * df_cap if df_cap is not None else budget)
    ns = plan.n_slabs
    # One workspace: span_start [B][T] i64, bound [B][ns + 1][T] i32,
    # row_cnt [B] i32, row_floor [B] u64, lists [B][ns * k] f32 and i32.
    sizes = (8 * b * t, 4 * b * (ns + 1) * t, 4 * b, 8 * b,
             4 * b * ns * k, 4 * b * ns * k)
    offs, total = [], 0
    for size in sizes:
        offs.append(total)
        total += -(-size // 16) * 16
    work = torch.empty(total, dtype=torch.uint8, device=dev)
    base = work.data_ptr()
    out = torch.empty((2, b, k), dtype=torch.int32, device=dev)
    index = dev.index
    args = (q_terms.data_ptr(), b, t, bm25.indptr.data_ptr(),
            bm25.vocab_size, bm25.doc_ids.data_ptr(),
            bm25.impact.data_ptr(), n,
            mask.data_ptr() if mask is not None else None,
            mask.numel() if mask is not None else 0, budget,
            df_cap if df_cap is not None else 0, k, plan.shift, ns,
            plan.span_grid, *(base + o for o in offs), out[0].data_ptr(),
            out[1].data_ptr(), torch._C._cuda_getCurrentRawStream(index))
    fn = _library().anr_bm25_sparse_top_k
    if index == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"anr_bm25_sparse_top_k failed with cudaError_t "
                           f"{err}")
    count_launch(bm25_sparse_top_k)
    return out[0].view(torch.float32), out[1]


bm25_sparse_top_k.launches = 0
bm25_sparse_top_k.torch_route = 0
