"""Probes of K1/K2: the kernel's anatomy (P4) and its insertion counts (P5).

Both run the split kernel of K1/K2 (``csrc/split_topk.cuh``) from
``csrc/anatomy.cu``, on K1/K2's grid, block and shared-memory layout for
the given k, and replace the TPU probes of the repository:

- ``anatomy_top_k`` / ``anatomy_top_k_int8`` (P4,
  ``scripts/profile_kernel_anatomy.py:138``): K1/K2 with part of the
  work per tile taken away. ``mode`` is one of

  - ``"stage"``: the staging alone. Returns int32 [query blocks,
    splits]: per CTA, the XOR of every 32-bit word it staged, each read
    back after its copy landed: each document's words once (zero-padded
    to whole words), and the query block's words (K1: the f32 query for
    f32 rows, its three bf16 planes ``split_query`` for bf16 rows; K2: the
    int8 query), zero-padded, once where the block is resident in shared
    memory and once per tile where it streams. XOR does not depend on
    order: exact.
  - ``"score"``: + scoring. Returns f32 [B]: each row's best selection
    score (f32 rows q . e; int8 rows float(q8 . e8) * doc scale).
  - ``"compare"``: + the fold's ballot against ``threshold`` [B] f32 (the
    running list's worst entry, pinned; K1 takes it only in the rows its
    scoring flagged as holding a score at least the threshold). Returns
    int32 [B]: the documents scoring at least the threshold. Timed at
    +inf, so nothing enters.
  - ``"full"``: K1/K2 themselves, through their own wrappers.

  The four times, in this order, split K1/K2 into the loads, the
  scoring, the compare pass, and the insertions and merge.

- ``fused_top_k_counted`` / ``fused_top_k_counted_int8`` (P5,
  ``scripts/probe_iteration_count.py:160``): K1/K2's fold with counters.
  Returns K1/K2's (values, ids) and int32 counts [B, splits, 4]: per row
  and doc split, insertions in the split's first 16 tiles of 128
  documents, insertions after them, 32-column windows whose ballot fired,
  and windows seen. With ``tau`` [B] f32 every slot starts as (tau,
  empty): a document enters only if it scores at least tau, and the ids
  stay exact as long as tau is at most the k-th best score
  (``subsample_tau``, K1/K2's own warm start, gives such a bound). The
  probe runs no tau pass of its own: without ``tau`` it counts the cold
  fold.

On CUDA tensors each wrapper launches its kernel or raises; it takes its
plain PyTorch version only for tensors on the CPU, where the split plan
is an H100's (132 SMs): ``split_plan`` for K1's query block and splits,
``split_plan_int8`` for K2's (``topk_plan.fused_plan``).
``.launches`` counts kernel launches. The plain versions compute each
output directly: the XOR over the words, the max and the count over the
score matrix, and the counts by replaying each split's running list
window by window (document j of a split enters iff fewer than k earlier
documents of the split beat it under (score desc, id asc) and, with tau,
it scores at least tau; a window fires iff its best document enters).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from a_nice_rag_tpu_torch.ops.kernels import _build, topk_plan
from a_nice_rag_tpu_torch.ops.kernels._launches import count_launch
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (  # noqa: F401
    TAU_SLACK,
    TAU_STRIDE,
    _I,
    _P,
    _ROWS,
    _check,
    _chunk_rows,
    _check_k,
    _float_scores,
    _int8_scores,
    _launch,
    _outputs,
    _ptr,
    _sm_count,
    _workspace,
    fused_dense_top_k,
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_torch,
    fused_dense_top_k_torch,
    split_query,
    subsample_tau,
    subsample_tau_int8,
)

MODES = ("stage", "score", "compare", "full")
_MODE_CODES = {"stage": 1, "score": 2, "compare": 3}
_COUNTED = 4
TILE_DOCS = topk_plan.TN
WINDOW = 32  # columns per ballot
EARLY_TILES = 16
COUNTERS = ("early", "late", "fired", "seen")
_EMPTY_ID = 2**31 - 1

ScoreChunk = Callable[[int, int], torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = _build.load("anatomy")
    if not hasattr(lib, "_anr_bound"):
        # mode, q, e; B N D k bq qres splits per; thr counts words row_max
        # workspace out_v out_i stream.
        floats = [_I, _P, _P] + [_I] * 8 + [_P] * 8
        lib.anr_anatomy_f32.argtypes = floats
        lib.anr_anatomy_bf16.argtypes = floats
        # mode, q, q scales, values, scales; B N D k bq splits per; the
        # same buffers.
        lib.anr_anatomy_int8.argtypes = [_I] + [_P] * 4 + [_I] * 7 + [_P] * 8
        for fn in (lib.anr_anatomy_f32, lib.anr_anatomy_bf16,
                   lib.anr_anatomy_int8):
            fn.restype = _I
        lib._anr_bound = True
    return lib


def split_plan(n: int, b: int, d: int, k: int, rows: str,
               device: torch.device) -> topk_plan.FusedPlan:
    """(query block, doc splits, docs per split) of K1 for [n, d] rows of
    ``rows`` ("float32" or "bfloat16"), b queries and k on ``device``."""
    return topk_plan.fused_plan(n, b, d, k, _sm_count(device), rows)


def split_plan_int8(n: int, b: int, d: int, k: int,
                    device: torch.device) -> topk_plan.FusedPlan:
    """(query block, doc splits, docs per split) of K2 for [n, d] rows,
    b queries and k on ``device``."""
    return topk_plan.fused_plan(n, b, d, k, _sm_count(device))


def _check_vector(t: Optional[torch.Tensor], name: str, b: int,
                  dev: torch.device, required: bool) -> None:
    if t is None:
        if required:
            raise ValueError(f"{name} [B] float32 is required here")
        return
    _check(t, name, (torch.float32,), (b,), dev)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _check_rows(emb: torch.Tensor, queries: torch.Tensor, k: int):
    _check_k(k)
    if emb.ndim != 2 or queries.ndim != 2 or queries.shape[1] != emb.shape[1]:
        raise ValueError(f"need emb [N, D] and queries [B, D], got "
                         f"{tuple(emb.shape)} and {tuple(queries.shape)}")
    (n, d), b, dev = emb.shape, queries.shape[0], emb.device
    _check(emb, "emb", (torch.float32, torch.bfloat16), (n, d), dev)
    _check(queries, "queries", (torch.float32, torch.bfloat16), (b, d), dev,
           contiguous=False)
    return n, d, b, dev


def _check_int8_rows(values, scales, q_values, q_scales, k: int):
    _check_k(k)
    if values.ndim != 2 or q_values.ndim != 2 \
            or q_values.shape[1] != values.shape[1]:
        raise ValueError(f"need values [N, D] and q_values [B, D], got "
                         f"{tuple(values.shape)} and {tuple(q_values.shape)}")
    (n, d), b, dev = values.shape, q_values.shape[0], values.device
    _check(values, "values", (torch.int8,), (n, d), dev)
    _check(scales, "scales", (torch.float32,), (n,), dev)
    _check(q_values, "q_values", (torch.int8,), (b, d), dev)
    _check(q_scales, "q_scales", (torch.float32,), (b,), dev)
    return n, d, b, dev


# -- plain pieces --------------------------------------------------------


def _row_max(scores: ScoreChunk, n: int, b: int, d: int,
             device: torch.device) -> torch.Tensor:
    best = torch.full((b,), float("-inf"), device=device)
    step = _chunk_rows(b, d)
    for s0 in range(0, n, step):
        best = torch.maximum(best, scores(s0, min(n, s0 + step)).amax(dim=1))
    return best


def _count_at_least(scores: ScoreChunk, threshold: torch.Tensor, n: int,
                    b: int, d: int) -> torch.Tensor:
    count = torch.zeros((b,), dtype=torch.int64, device=threshold.device)
    step = _chunk_rows(b, d)
    for s0 in range(0, n, step):
        count += (scores(s0, min(n, s0 + step))
                  >= threshold[:, None]).sum(dim=1)
    return count.to(torch.int32)


def _xor_rows(x: torch.Tensor) -> torch.Tensor:
    """The XOR of every element of each row of an int32 [R, M] tensor."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = F.pad(x, (0, 1))
        half = x.shape[1] // 2
        x = torch.bitwise_xor(x[:, :half], x[:, half:])
    return x[:, 0] if x.shape[1] else torch.zeros(x.shape[0], dtype=x.dtype,
                                                   device=x.device)


def _words(x: torch.Tensor) -> torch.Tensor:
    """The little-endian 32-bit words of the rows (last dimension) of x
    (int8, bf16 or f32), the last word of a row zero-padded, as the
    staging copies load them."""
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    pad = -x.shape[-1] % (4 // x.element_size())
    return (F.pad(x, (0, pad)) if pad else x).contiguous().view(torch.int32)


def _staged_xor(q_words: torch.Tensor, e_words: torch.Tensor,
                plan: Tuple[int, int], block: int,
                query_once: bool) -> torch.Tensor:
    """[q_blocks, splits]: each CTA's XOR of the words it staged, for
    query blocks of ``block`` rows; q_words [planes, B, W] (or [B, W]).
    A resident query block (``query_once``) enters each CTA's XOR once; a
    streamed one is staged once per tile, so it stays in the XOR only for
    an odd count of tiles. The whole splits are one view of the rows and
    the last, partial one is taken apart, so the matrix is never
    copied."""
    splits, per = plan
    if q_words.ndim == 2:
        q_words = q_words[None]
    planes, b, w = q_words.shape
    n = e_words.shape[0]
    qb = -(-b // block)
    qx = _xor_rows(F.pad(q_words, (0, 0, 0, qb * block - b))
                   .reshape(planes, qb, block * w).permute(1, 0, 2)
                   .reshape(qb, -1))
    whole = n // per
    ex = torch.zeros(splits, dtype=torch.int32, device=e_words.device)
    if whole:
        ex[:whole] = _xor_rows(e_words[:whole * per].reshape(whole, -1))
    if whole < splits:
        ex[whole:] = _xor_rows(e_words[whole * per:].reshape(1, -1))
    starts = torch.arange(splits, device=e_words.device) * per
    tiles = -(-(n - starts).clamp(max=per) // TILE_DOCS)
    odd = (query_once | (tiles % 2 == 1))[None, :]
    return torch.bitwise_xor(ex[None, :],
                             torch.where(odd, qx[:, None], 0))


def _float_plan(n: int, b: int, d: int, k: int, rows: str,
                dev: torch.device):
    """K1's plan and whether its query block is resident."""
    plan = split_plan(n, b, d, k, rows, dev)
    return plan, topk_plan.resident(plan.bq, d, k, rows)


def _query_planes(emb: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """The query planes K1 stages: the f32 query, or for bf16 rows its
    three bf16 pieces."""
    if emb.dtype == torch.bfloat16:
        return split_query(queries)
    return queries.to(torch.float32)[None]


def _counted_plain(scores: ScoreChunk, n: int, b: int, d: int, k: int,
                   plan: Tuple[int, int], tau: Optional[torch.Tensor],
                   device: torch.device):
    """Replay every split's running list window by window: (selection
    values [B, k], ids [B, k] int32, counts [B, splits, 4] int32)."""
    splits, per = plan
    flat = torch.full((b, splits * per), float("-inf"), device=device)
    step = _chunk_rows(b, d)
    for s0 in range(0, n, step):
        s1 = min(n, s0 + step)
        flat[:, s0:s1] = scores(s0, s1)
    flat = flat.view(b, splits, per)
    starts = torch.arange(splits, device=device) * per
    lens = (n - starts).clamp(0, per)
    i64 = dict(dtype=torch.int64, device=device)
    run_v = (torch.full((b, splits, k), float("-inf"), device=device)
             if tau is None else
             tau.to(torch.float32)[:, None, None].expand(b, splits, k).clone())
    run_i = torch.full((b, splits, k), _EMPTY_ID, **i64)
    counts = torch.zeros((b, splits, len(COUNTERS)), **i64)
    counts[..., 3] = (-(-lens // TILE_DOCS) * (TILE_DOCS // WINDOW))[None, :]
    earlier = torch.ones((WINDOW, WINDOW), dtype=torch.bool,
                         device=device).tril(-1)  # [x, y]: y before x
    for w0 in range(0, per, WINDOW):
        pos = w0 + torch.arange(WINDOW, device=device)
        valid = pos[None, :] < lens[:, None]  # [S, W]
        ids = (starts[:, None] + pos[None, :]).expand(b, -1, -1)
        s = flat[:, :, w0:w0 + WINDOW]  # [B, S, W]
        lv, li = run_v[:, :, None, :], run_i[:, :, None, :]
        beat_list = ((lv > s[..., None])
                     | ((lv == s[..., None]) & (li < ids[..., None]))
                     ).sum(dim=-1)
        # Earlier documents of the window have lower ids: they beat x at
        # an equal score.
        beat_window = ((s[:, :, None, :] >= s[..., None]) & earlier).sum(-1)
        cand = valid & (beat_list < k)
        entered = cand & (beat_list + beat_window < k)
        counts[..., 0 if w0 < EARLY_TILES * TILE_DOCS else 1] += \
            entered.sum(dim=-1)
        counts[..., 2] += cand.any(dim=-1)
        run_v, run_i = _top_k_by_rule(
            torch.cat([run_v, torch.where(valid, s, float("-inf"))], dim=-1),
            torch.cat([run_i, torch.where(valid, ids, _EMPTY_ID)], dim=-1),
            k)
    vals, ids = _top_k_by_rule(run_v.reshape(b, -1), run_i.reshape(b, -1), k)
    empty = ids == _EMPTY_ID
    vals = torch.where(empty, float("-inf"), vals)
    ids = torch.where(empty, -1, ids).to(torch.int32)
    return vals, ids, counts.to(torch.int32)


def _top_k_by_rule(v: torch.Tensor, i: torch.Tensor, k: int):
    """The k best of each row's (value, id) pairs under (value desc, id
    asc), in that order."""
    i, pos = torch.sort(i, dim=-1, stable=True)
    v = torch.take_along_dim(v, pos, dim=-1)
    v, pos = torch.sort(v, dim=-1, descending=True, stable=True)
    i = torch.take_along_dim(i, pos, dim=-1)
    return v[..., :k], i[..., :k]


# -- P4: anatomy -----------------------------------------------------------


def anatomy_top_k_torch(emb: torch.Tensor, queries: torch.Tensor, k: int,
                        mode: str,
                        threshold: Optional[torch.Tensor] = None):
    """Plain version of ``anatomy_top_k`` (direct computations)."""
    _check_mode(mode)
    n, d, b, dev = _check_rows(emb, queries, k)
    if mode == "full":
        return fused_dense_top_k_torch(emb, queries, k)
    if mode == "stage":
        plan, qres = _float_plan(n, b, d, k, _ROWS[emb.dtype], dev)
        return _staged_xor(_words(_query_planes(emb, queries)), _words(emb),
                           plan[1:], plan.bq, query_once=qres)
    scores = _float_scores(emb, queries)
    if mode == "score":
        return _row_max(scores, n, b, d, dev)
    _check_vector(threshold, "threshold", b, dev, True)
    return _count_at_least(scores, threshold, n, b, d)


def anatomy_top_k_int8_torch(values: torch.Tensor, scales: torch.Tensor,
                             q_values: torch.Tensor, q_scales: torch.Tensor,
                             k: int, mode: str,
                             threshold: Optional[torch.Tensor] = None):
    """Plain version of ``anatomy_top_k_int8`` (direct computations)."""
    _check_mode(mode)
    n, d, b, dev = _check_int8_rows(values, scales, q_values, q_scales, k)
    if mode == "full":
        return fused_dense_top_k_int8_torch(values, scales, q_values,
                                            q_scales, k)
    if mode == "stage":
        plan = split_plan_int8(n, b, d, k, dev)
        return _staged_xor(_words(q_values), _words(values), plan[1:],
                           plan.bq, query_once=True)
    scores = _int8_scores(values, scales, q_values)
    if mode == "score":
        return _row_max(scores, n, b, d, dev)
    _check_vector(threshold, "threshold", b, dev, True)
    return _count_at_least(scores, threshold, n, b, d)


def _probe_buffers(mode: str, b: int, splits: int, dev: torch.device,
                   block: int):
    """(counts, words, row_max) for one probe mode, filled as the kernel's
    atomics expect; None where the mode writes nothing."""
    if mode == "compare":
        return torch.zeros((b,), dtype=torch.int32, device=dev), None, None
    if mode == "stage":
        qb = -(-b // block)
        return None, torch.zeros((qb, splits), dtype=torch.int32,
                                 device=dev), None
    return None, None, torch.full((b,), float("-inf"), device=dev)


def anatomy_top_k(emb: torch.Tensor, queries: torch.Tensor, k: int,
                  mode: str, threshold: Optional[torch.Tensor] = None):
    """K1 (emb [N, D] f32 or bf16, queries [B, D]) with part of its work
    taken away; see the module docstring for ``mode`` and the outputs.
    ``threshold`` [B] f32 is needed by "compare" only."""
    _check_mode(mode)
    n, d, b, dev = _check_rows(emb, queries, k)
    _check_vector(threshold, "threshold", b, dev, mode == "compare")
    if mode == "full":
        return fused_dense_top_k(emb, queries, k)
    if dev.type == "cpu":
        return anatomy_top_k_torch(emb, queries, k, mode, threshold)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    rows = _ROWS[emb.dtype]
    q = queries.to(torch.float32).contiguous()
    plan, qres = _float_plan(n, b, d, k, rows, dev)
    counts, words, row_max = _probe_buffers(mode, b, plan.splits, dev,
                                            plan.bq)
    ws = _workspace(b, k, plan.splits, 0, d, rows == "bfloat16", dev)
    fn = (lib.anr_anatomy_f32 if rows == "float32"
          else lib.anr_anatomy_bf16)
    with torch.cuda.device(dev):
        _launch(fn, _MODE_CODES[mode], q.data_ptr(), emb.data_ptr(), b, n,
                d, k, plan.bq, int(qres), plan.splits, plan.per,
                _ptr(threshold), _ptr(counts), _ptr(words), _ptr(row_max),
                ws.data_ptr(), None, None, device=dev)
    count_launch(anatomy_top_k)
    return {"stage": words, "score": row_max, "compare": counts}[mode]


anatomy_top_k.launches = 0


def anatomy_top_k_int8(values: torch.Tensor, scales: torch.Tensor,
                       q_values: torch.Tensor, q_scales: torch.Tensor,
                       k: int, mode: str,
                       threshold: Optional[torch.Tensor] = None):
    """K2 (int8 rows, ops.quantized layout) with part of its work taken
    away; the outputs as ``anatomy_top_k``'s, on selection scores
    float(q8 . e8) * doc scale."""
    _check_mode(mode)
    n, d, b, dev = _check_int8_rows(values, scales, q_values, q_scales, k)
    _check_vector(threshold, "threshold", b, dev, mode == "compare")
    if mode == "full":
        return fused_dense_top_k_int8(values, scales, q_values, q_scales, k)
    if dev.type == "cpu":
        return anatomy_top_k_int8_torch(values, scales, q_values, q_scales,
                                        k, mode, threshold)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    plan = split_plan_int8(n, b, d, k, dev)
    counts, words, row_max = _probe_buffers(mode, b, plan.splits, dev,
                                            plan.bq)
    ws = _workspace(b, k, plan.splits, 0, d, False, dev)
    with torch.cuda.device(dev):
        _launch(lib.anr_anatomy_int8, _MODE_CODES[mode], q_values.data_ptr(),
                q_scales.data_ptr(), values.data_ptr(), scales.data_ptr(), b,
                n, d, k, *plan, _ptr(threshold), _ptr(counts),
                _ptr(words), _ptr(row_max), ws.data_ptr(), None, None,
                device=dev)
    count_launch(anatomy_top_k_int8)
    return {"stage": words, "score": row_max, "compare": counts}[mode]


anatomy_top_k_int8.launches = 0


# -- P5: counted fold ------------------------------------------------------


def fused_top_k_counted_torch(emb: torch.Tensor, queries: torch.Tensor,
                              k: int, tau: Optional[torch.Tensor] = None):
    """Plain version of ``fused_top_k_counted``."""
    n, d, b, dev = _check_rows(emb, queries, k)
    _check_vector(tau, "tau", b, dev, False)
    return _counted_plain(_float_scores(emb, queries), n, b, d, k,
                          split_plan(n, b, d, k, _ROWS[emb.dtype], dev)[1:],
                          tau, dev)


def fused_top_k_counted_int8_torch(values: torch.Tensor,
                                   scales: torch.Tensor,
                                   q_values: torch.Tensor,
                                   q_scales: torch.Tensor, k: int,
                                   tau: Optional[torch.Tensor] = None):
    """Plain version of ``fused_top_k_counted_int8``."""
    n, d, b, dev = _check_int8_rows(values, scales, q_values, q_scales, k)
    _check_vector(tau, "tau", b, dev, False)
    vals, ids, counts = _counted_plain(
        _int8_scores(values, scales, q_values), n, b, d, k,
        split_plan_int8(n, b, d, k, dev)[1:], tau, dev)
    return torch.where(ids < 0, float("-inf"),
                       vals * q_scales[:, None]), ids, counts


def _counted_launch(fn, head, b: int, n: int, d: int, k: int,
                    tau: Optional[torch.Tensor], dev: torch.device,
                    plan: Tuple[int, ...], pieces: bool):
    """``plan``: (query block, resident, splits, per) for K1, (query
    block, splits, per) for K2, passed on as the entry point takes them."""
    splits = plan[-2]
    out_v, out_i = _outputs(b, k, dev)
    ws = _workspace(b, k, splits, 0, d, pieces, dev)
    counts = torch.empty((b, splits, len(COUNTERS)), dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        _launch(fn, _COUNTED, *head, b, n, d, k, *plan, _ptr(tau),
                counts.data_ptr(), None, None, ws.data_ptr(),
                out_v.data_ptr(), out_i.data_ptr(), device=dev)
    return out_v, out_i, counts


def fused_top_k_counted(emb: torch.Tensor, queries: torch.Tensor, k: int,
                        tau: Optional[torch.Tensor] = None):
    """K1 with insertion counters: (values [B, k], ids [B, k], counts
    [B, splits, 4] int32); ``tau`` [B] f32 seeds every slot."""
    n, d, b, dev = _check_rows(emb, queries, k)
    _check_vector(tau, "tau", b, dev, False)
    if dev.type == "cpu":
        return fused_top_k_counted_torch(emb, queries, k, tau)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    rows = _ROWS[emb.dtype]
    q = queries.to(torch.float32).contiguous()
    fn = (lib.anr_anatomy_f32 if rows == "float32"
          else lib.anr_anatomy_bf16)
    plan, qres = _float_plan(n, b, d, k, rows, dev)
    out = _counted_launch(fn, (q.data_ptr(), emb.data_ptr()), b, n, d, k,
                          tau, dev, (plan.bq, int(qres), plan.splits,
                                     plan.per), rows == "bfloat16")
    count_launch(fused_top_k_counted)
    return out


fused_top_k_counted.launches = 0


def fused_top_k_counted_int8(values: torch.Tensor, scales: torch.Tensor,
                             q_values: torch.Tensor, q_scales: torch.Tensor,
                             k: int, tau: Optional[torch.Tensor] = None):
    """K2 with insertion counters; ``tau`` [B] f32 is on the selection
    scores float(q8 . e8) * doc scale (before the query scale)."""
    n, d, b, dev = _check_int8_rows(values, scales, q_values, q_scales, k)
    _check_vector(tau, "tau", b, dev, False)
    if dev.type == "cpu":
        return fused_top_k_counted_int8_torch(values, scales, q_values,
                                              q_scales, k, tau)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    out = _counted_launch(
        lib.anr_anatomy_int8, (q_values.data_ptr(), q_scales.data_ptr(),
                               values.data_ptr(), scales.data_ptr()),
        b, n, d, k, tau, dev, tuple(split_plan_int8(n, b, d, k, dev)),
        False)
    count_launch(fused_top_k_counted_int8)
    return out


fused_top_k_counted_int8.launches = 0
