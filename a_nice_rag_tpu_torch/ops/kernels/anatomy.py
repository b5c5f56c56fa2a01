"""Probes of K1/K2: the kernel's anatomy (P4) and its insertion counts (P5).

Each probe has two designs. ``design="split"`` (the default) runs the
split kernel of K1/K2 (``csrc/split_topk.cuh``) from ``csrc/anatomy.cu``,
on K1/K2's grid, block and shared-memory layout for the given k: K1's and
K2's own anatomy for as long as they run there. ``design="cluster"`` runs
the cluster kernel (``csrc/cluster_probe.cu``, ``ops/kernels/
cluster_probe.py``) on the score ``kind`` ("exact": K1's or K2's
function; "rounded": K1r / K2r; "compare": K1c), bf16 or int8 rows and B
past 16, where its plan takes the TMA route with the query planes
resident; a call that plan refuses raises (on CUDA it never falls back
to the split design). Both replace the TPU probes of the repository:

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

The cluster design's outputs (``cluster_probe``'s docstring): "stage"
int32 [query blocks, walkers], "score" f32 [B] (the kind's selection
score), "compare" int32 [B], "full" the kind's whole call on the cluster
kernel (K1's / K2's lists for "exact"); the counted fold returns (values,
ids, counts [B, walkers, 4]: entries early and late, tiles with an
entry, tiles seen, heap [B, walkers]: the kernel's insertions, or the
plain version's survivors) and takes ``tau`` [B] or ``lists`` (an
earlier pass's top k, ``cluster_probe.subsample_seeds``) as its seed.

On CUDA tensors each wrapper launches its kernel or raises; it takes its
plain PyTorch version only for tensors on the CPU, where the split plan
is an H100's (132 SMs): ``split_plan`` for K1's query block and splits,
``split_plan_int8`` for K2's (``topk_plan.fused_plan``); the cluster
plan likewise (the card's active clusters passed in on CUDA).
``.launches`` counts kernel launches, the split design's on
``anatomy_top_k`` and the others, the cluster design's on
``anatomy_top_k_cluster`` and the others of that name. The split
design's plain versions compute each output directly: the XOR over the
words, the max and the count over the score matrix, and the counts by
replaying each split's running list
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
from a_nice_rag_tpu_torch.ops.kernels import cluster_probe as CP
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
DESIGNS = ("split", "cluster")
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


def _check_design(design: str) -> None:
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")


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
        run_v, run_i = CP.top_k_by_rule(
            torch.cat([run_v, torch.where(valid, s, float("-inf"))], dim=-1),
            torch.cat([run_i, torch.where(valid, ids, _EMPTY_ID)], dim=-1),
            k)
    vals, ids = CP.top_k_by_rule(run_v.reshape(b, -1), run_i.reshape(b, -1), k)
    empty = ids == _EMPTY_ID
    vals = torch.where(empty, float("-inf"), vals)
    ids = torch.where(empty, -1, ids).to(torch.int32)
    return vals, ids, counts.to(torch.int32)


# -- P4: anatomy -----------------------------------------------------------


def anatomy_top_k_torch(emb: torch.Tensor, queries: torch.Tensor, k: int,
                        mode: str,
                        threshold: Optional[torch.Tensor] = None,
                        design: str = "split", kind: str = "exact"):
    """Plain version of ``anatomy_top_k`` (direct computations)."""
    _check_mode(mode)
    _check_design(design)
    if design == "cluster":
        return anatomy_top_k_cluster_torch(emb, queries, k, mode, threshold,
                                           kind)
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
                             threshold: Optional[torch.Tensor] = None,
                             design: str = "split", kind: str = "exact"):
    """Plain version of ``anatomy_top_k_int8`` (direct computations)."""
    _check_mode(mode)
    _check_design(design)
    if design == "cluster":
        return anatomy_top_k_int8_cluster_torch(values, scales, q_values,
                                                q_scales, k, mode, threshold,
                                                kind)
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
                  mode: str, threshold: Optional[torch.Tensor] = None,
                  design: str = "split", kind: str = "exact"):
    """K1 (emb [N, D] f32 or bf16, queries [B, D]) with part of its work
    taken away; see the module docstring for ``mode``, ``design``,
    ``kind`` (the cluster design's) and the outputs. ``threshold`` [B]
    f32 is needed by "compare" only."""
    _check_mode(mode)
    _check_design(design)
    if design == "cluster":
        return anatomy_top_k_cluster(emb, queries, k, mode, threshold, kind)
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
                       threshold: Optional[torch.Tensor] = None,
                       design: str = "split", kind: str = "exact"):
    """K2 (int8 rows, ops.quantized layout) with part of its work taken
    away; the outputs as ``anatomy_top_k``'s, on selection scores
    float(q8 . e8) * doc scale (the cluster design's "rounded" kind: K2r's,
    rounded to bf16)."""
    _check_mode(mode)
    _check_design(design)
    if design == "cluster":
        return anatomy_top_k_int8_cluster(values, scales, q_values, q_scales,
                                          k, mode, threshold, kind)
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
                              k: int, tau: Optional[torch.Tensor] = None,
                              design: str = "split", kind: str = "exact",
                              lists=None):
    """Plain version of ``fused_top_k_counted``."""
    _check_design(design)
    if design == "cluster":
        return fused_top_k_counted_cluster_torch(emb, queries, k, tau, lists,
                                                 kind)
    n, d, b, dev = _check_rows(emb, queries, k)
    _check_vector(tau, "tau", b, dev, False)
    return _counted_plain(_float_scores(emb, queries), n, b, d, k,
                          split_plan(n, b, d, k, _ROWS[emb.dtype], dev)[1:],
                          tau, dev)


def fused_top_k_counted_int8_torch(values: torch.Tensor,
                                   scales: torch.Tensor,
                                   q_values: torch.Tensor,
                                   q_scales: torch.Tensor, k: int,
                                   tau: Optional[torch.Tensor] = None,
                                   design: str = "split",
                                   kind: str = "exact", lists=None):
    """Plain version of ``fused_top_k_counted_int8``."""
    _check_design(design)
    if design == "cluster":
        return fused_top_k_counted_int8_cluster_torch(
            values, scales, q_values, q_scales, k, tau, lists, kind)
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
                        tau: Optional[torch.Tensor] = None,
                        design: str = "split", kind: str = "exact",
                        lists=None):
    """K1 with insertion counters: (values [B, k], ids [B, k], counts
    [B, splits, 4] int32); ``tau`` [B] f32 seeds every slot. The cluster
    design: see the module docstring."""
    _check_design(design)
    if design == "cluster":
        return fused_top_k_counted_cluster(emb, queries, k, tau, lists, kind)
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
                             k: int, tau: Optional[torch.Tensor] = None,
                             design: str = "split", kind: str = "exact",
                             lists=None):
    """K2 with insertion counters; ``tau`` [B] f32 is on the selection
    scores float(q8 . e8) * doc scale (before the query scale)."""
    _check_design(design)
    if design == "cluster":
        return fused_top_k_counted_int8_cluster(values, scales, q_values,
                                                q_scales, k, tau, lists, kind)
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


# -- the cluster design ------------------------------------------------------


def _check_bf16_cluster(emb, queries, k):
    n, d, b, dev = _check_rows(emb, queries, k)
    if emb.dtype != torch.bfloat16:
        raise ValueError("the cluster design takes bf16 or int8 rows; f32 "
                         "rows are the split design's")
    return n, d, b, dev


def _check_seed(tau, lists, b, k, dev) -> None:
    _check_vector(tau, "tau", b, dev, False)
    if lists is None:
        return
    if tau is not None:
        raise ValueError("give tau or lists, not both")
    lv, li, every = lists
    _check(lv, "list values", (torch.float32,), (b, k), dev)
    _check(li, "list ids", (torch.int32,), (b, k), dev)
    if every < 1:
        raise ValueError(f"lists' row stride must be >= 1, got {every}")


def cluster_active_clusters(rows: torch.Tensor, b: int, k: int,
                            kind: str = "exact", mode: str = "counted"
                            ) -> Optional[int]:
    """The active clusters a cluster-design probe over ``rows`` (bf16 or
    int8) takes its walkers from on their CUDA device, for the plain
    versions' ``active``; None on the CPU (an H100's SMs)."""
    if rows.device.type != "cuda":
        return None
    return CP.active_clusters(rows, b, k,
                              CP.source_kind(rows.dtype == torch.int8, kind),
                              mode)


def _anatomy_cluster(rows, queries, k, mode, threshold, kind, scales,
                     q_scales, plain: bool, active=None):
    b, dev = queries.shape[0], rows.device
    _check_vector(threshold, "threshold", b, dev, mode == "compare")
    if mode == "full":
        fn = CP.top_k_torch if plain else CP.top_k
        return fn(rows, queries, k, kind, scales, q_scales)
    if plain:
        return CP.cluster_probe_torch(mode, rows, queries, k, kind, scales,
                                      q_scales, threshold=threshold,
                                      active=active)
    return CP.cluster_probe(mode, rows, queries, k, kind, scales, q_scales,
                            threshold=threshold)


def _launching(dev: torch.device) -> bool:
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def anatomy_top_k_cluster_torch(emb, queries, k, mode, threshold=None,
                                kind="exact", active=None):
    """Plain version of ``anatomy_top_k_cluster`` (``active``: the card's
    clusters, for its walkers; None: an H100's SMs)."""
    _check_mode(mode)
    _check_bf16_cluster(emb, queries, k)
    return _anatomy_cluster(emb, queries, k, mode, threshold,
                            CP.source_kind(False, kind), None, None, True,
                            active)


def anatomy_top_k_cluster(emb: torch.Tensor, queries: torch.Tensor, k: int,
                          mode: str, threshold: Optional[torch.Tensor] = None,
                          kind: str = "exact"):
    """P4 on the cluster kernel over bf16 rows (``anatomy_top_k(...,
    design="cluster")``)."""
    _check_mode(mode)
    _, _, _, dev = _check_bf16_cluster(emb, queries, k)
    if not _launching(dev):
        return anatomy_top_k_cluster_torch(emb, queries, k, mode, threshold,
                                           kind)
    out = _anatomy_cluster(emb, queries, k, mode, threshold,
                           CP.source_kind(False, kind), None, None, False)
    count_launch(anatomy_top_k_cluster)
    return out


anatomy_top_k_cluster.launches = 0


def anatomy_top_k_int8_cluster_torch(values, scales, q_values, q_scales, k,
                                     mode, threshold=None, kind="exact",
                                     active=None):
    """Plain version of ``anatomy_top_k_int8_cluster``."""
    _check_mode(mode)
    _check_int8_rows(values, scales, q_values, q_scales, k)
    return _anatomy_cluster(values, q_values, k, mode, threshold,
                            CP.source_kind(True, kind), scales, q_scales,
                            True, active)


def anatomy_top_k_int8_cluster(values: torch.Tensor, scales: torch.Tensor,
                               q_values: torch.Tensor,
                               q_scales: torch.Tensor, k: int, mode: str,
                               threshold: Optional[torch.Tensor] = None,
                               kind: str = "exact"):
    """P4 on the cluster kernel over int8 rows (``anatomy_top_k_int8(...,
    design="cluster")``)."""
    _check_mode(mode)
    _, _, _, dev = _check_int8_rows(values, scales, q_values, q_scales, k)
    if not _launching(dev):
        return anatomy_top_k_int8_cluster_torch(
            values, scales, q_values, q_scales, k, mode, threshold, kind)
    out = _anatomy_cluster(values, q_values, k, mode, threshold,
                           CP.source_kind(True, kind), scales, q_scales,
                           False)
    count_launch(anatomy_top_k_int8_cluster)
    return out


anatomy_top_k_int8_cluster.launches = 0


def _counted_cluster(rows, queries, k, tau, lists, kind, scales, q_scales,
                     plain: bool, active=None):
    _check_seed(tau, lists, queries.shape[0], k, rows.device)
    if plain:
        return CP.cluster_probe_torch("counted", rows, queries, k, kind,
                                      scales, q_scales, tau=tau, lists=lists,
                                      active=active)
    return CP.cluster_probe("counted", rows, queries, k, kind, scales,
                            q_scales, tau=tau, lists=lists)


def fused_top_k_counted_cluster_torch(emb, queries, k, tau=None, lists=None,
                                      kind="exact", active=None):
    """Plain version of ``fused_top_k_counted_cluster``: its last output
    is the tiles' survivors, the least the kernel's insertions can be."""
    _check_bf16_cluster(emb, queries, k)
    return _counted_cluster(emb, queries, k, tau, lists,
                            CP.source_kind(False, kind), None, None, True,
                            active)


def fused_top_k_counted_cluster(emb: torch.Tensor, queries: torch.Tensor,
                                k: int, tau: Optional[torch.Tensor] = None,
                                lists=None, kind: str = "exact"):
    """P5 on the cluster kernel over bf16 rows (``fused_top_k_counted(...,
    design="cluster")``): (values, ids, counts [B, walkers, 4], heap
    insertions [B, walkers])."""
    _, _, _, dev = _check_bf16_cluster(emb, queries, k)
    if not _launching(dev):
        return fused_top_k_counted_cluster_torch(emb, queries, k, tau, lists,
                                                 kind)
    out = _counted_cluster(emb, queries, k, tau, lists,
                           CP.source_kind(False, kind), None, None, False)
    count_launch(fused_top_k_counted_cluster)
    return out


fused_top_k_counted_cluster.launches = 0


def fused_top_k_counted_int8_cluster_torch(values, scales, q_values,
                                           q_scales, k, tau=None,
                                           lists=None, kind="exact",
                                           active=None):
    """Plain version of ``fused_top_k_counted_int8_cluster``."""
    _check_int8_rows(values, scales, q_values, q_scales, k)
    return _counted_cluster(values, q_values, k, tau, lists,
                            CP.source_kind(True, kind), scales, q_scales,
                            True, active)


def fused_top_k_counted_int8_cluster(values: torch.Tensor,
                                     scales: torch.Tensor,
                                     q_values: torch.Tensor,
                                     q_scales: torch.Tensor, k: int,
                                     tau: Optional[torch.Tensor] = None,
                                     lists=None, kind: str = "exact"):
    """P5 on the cluster kernel over int8 rows; tau and the lists on the
    selection scores (before the query scale)."""
    _, _, _, dev = _check_int8_rows(values, scales, q_values, q_scales, k)
    if not _launching(dev):
        return fused_top_k_counted_int8_cluster_torch(
            values, scales, q_values, q_scales, k, tau, lists, kind)
    out = _counted_cluster(values, q_values, k, tau, lists,
                           CP.source_kind(True, kind), scales, q_scales,
                           False)
    count_launch(fused_top_k_counted_int8_cluster)
    return out


fused_top_k_counted_int8_cluster.launches = 0


def check_counted(got, want, what: str = "counted fold") -> None:
    """A cluster counted fold's run against its plain version: values,
    ids and the four counters equal, and the kernel's heap insertions
    between the plain version's survivors and the entries."""
    for a, b, name in zip(got[:3], want[:3], ("values", "ids", "counters")):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differ from the plain "
                                 f"version's")
    entries = got[2][..., 0] + got[2][..., 1]
    if not bool(((want[3] <= got[3]) & (got[3] <= entries)).all()):
        raise AssertionError(f"{what}: heap insertions outside [survivors, "
                             f"entries]")
