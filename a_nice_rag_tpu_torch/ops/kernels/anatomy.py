"""Probes of K1/K2: the kernel's anatomy (P4) and its insertion counts (P5).

Both run the split kernel of K1/K2 (``csrc/split_topk.cuh``) from
``csrc/anatomy.cu``, on K1/K2's grid, block and shared-memory layout for
the given k, and replace the TPU probes of the repository:

- ``anatomy_top_k`` / ``anatomy_top_k_int8`` (P4,
  ``scripts/profile_kernel_anatomy.py:138``): K1/K2 with part of the
  work per tile taken away. ``mode`` is one of

  - ``"stage"``: the staging loops alone. Returns int32 [ceil(B / 64),
    splits]: per CTA, the XOR of every 32-bit word it staged (the query
    block's f32 words, or packed int8 words, once per tile; each
    document's words once). XOR does not depend on order: exact.
  - ``"score"``: + scoring. Returns f32 [B]: each row's best selection
    score (f32 rows q . e; int8 rows float(q8 . e8) * doc scale).
  - ``"compare"``: + the fold's ballot against ``threshold`` [B] f32 (the
    running list's worst entry, pinned). Returns int32 [B]: the documents
    scoring at least the threshold. Timed at +inf, so nothing enters.
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
  (``subsample_tau`` gives such a bound).

On CUDA tensors each wrapper launches its kernel or raises; it takes its
plain PyTorch version only for tensors on the CPU, where the split plan
is an H100's (132 SMs). ``.launches`` counts kernel launches. The plain
versions compute each output directly: the XOR over the words, the max
and the count over the score matrix, and the counts by replaying each
split's running list window by window (document j of a split enters iff
fewer than k earlier documents of the split beat it under (score desc,
id asc) and, with tau, it scores at least tau; a window fires iff its
best document enters).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    _BLOCK_Q,
    _I,
    _P,
    _check,
    _chunk_rows,
    _check_k,
    _launch,
    _outputs,
    _ptr,
    _split_plan,
    fused_dense_top_k,
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_torch,
    fused_dense_top_k_torch,
)
from a_nice_rag_tpu_torch.ops.quantized import int8_dot

MODES = ("stage", "score", "compare", "full")
_MODE_CODES = {"stage": 1, "score": 2, "compare": 3}
_COUNTED = 4
TILE_DOCS = 128  # TN of csrc/topk_common.cuh
WINDOW = 32  # columns per ballot
EARLY_TILES = 16
COUNTERS = ("early", "late", "fired", "seen")
TAU_STRIDE = 64
# tau from a subsample is lowered by this much relative to |tau| (and
# 1e-30): room for a second summation order when the subsample is scored
# apart from the full matrix.
TAU_SLACK = 1e-5
_EMPTY_ID = 2**31 - 1

ScoreChunk = Callable[[int, int], torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = _build.load("anatomy")
    if not hasattr(lib, "_anr_bound"):
        tail = [_I] * 6 + [_P] * 9  # B N D k splits per, 8 buffers, stream
        lib.anr_anatomy_f32.argtypes = [_I, _P, _P] + tail
        lib.anr_anatomy_bf16.argtypes = [_I, _P, _P] + tail
        lib.anr_anatomy_int8.argtypes = [_I, _P, _P, _P, _P] + tail
        for fn in (lib.anr_anatomy_f32, lib.anr_anatomy_bf16,
                   lib.anr_anatomy_int8):
            fn.restype = _I
        lib._anr_bound = True
    return lib


def split_plan(n: int, b: int, device: torch.device) -> Tuple[int, int]:
    """(doc splits, docs per split) of K1/K2 for [n, *] rows and b
    queries on ``device``."""
    return _split_plan(n, b, device, TILE_DOCS)


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


def _float_scores(emb: torch.Tensor, queries: torch.Tensor) -> ScoreChunk:
    q = queries.to(torch.float32)
    return lambda s0, s1: q @ emb[s0:s1].to(torch.float32).T


def _int8_scores(values: torch.Tensor, scales: torch.Tensor,
                 q_values: torch.Tensor) -> ScoreChunk:
    return lambda s0, s1: (int8_dot(q_values, values[s0:s1])
                           .to(torch.float32) * scales[s0:s1][None, :])


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


def _float_words(x: torch.Tensor) -> torch.Tensor:
    """The f32 words the staging loops write for f32 or bf16 rows."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def _int8_words(x: torch.Tensor) -> torch.Tensor:
    """The little-endian 32-bit words of int8 rows, the last one of a row
    zero-padded, as the staging loops load them (a view when D % 4 ==
    0)."""
    pad = -x.shape[1] % 4
    return (F.pad(x, (0, pad)) if pad else x).contiguous().view(torch.int32)


def _staged_xor(q_words: torch.Tensor, e_words: torch.Tensor,
                plan: Tuple[int, int]) -> torch.Tensor:
    """[q_blocks, splits]: each CTA's XOR of the words it staged. The
    query block is staged once per tile, so it stays in the XOR only for
    an odd count of tiles. The whole splits are one view of the rows and
    the last, partial one is taken apart, so the matrix is never
    copied."""
    splits, per = plan
    (b, _), n = q_words.shape, e_words.shape[0]
    qb = -(-b // _BLOCK_Q)
    qx = _xor_rows(F.pad(q_words, (0, 0, 0, qb * _BLOCK_Q - b))
                   .reshape(qb, -1))
    whole = n // per
    ex = torch.zeros(splits, dtype=torch.int32, device=e_words.device)
    if whole:
        ex[:whole] = _xor_rows(e_words[:whole * per].reshape(whole, -1))
    if whole < splits:
        ex[whole:] = _xor_rows(e_words[whole * per:].reshape(1, -1))
    starts = torch.arange(splits, device=e_words.device) * per
    tiles = -(-(n - starts).clamp(max=per) // TILE_DOCS)
    odd = (tiles % 2 == 1)[None, :]
    return torch.bitwise_xor(ex[None, :],
                             torch.where(odd, qx[:, None], 0))


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
        return _staged_xor(_float_words(queries), _float_words(emb),
                           split_plan(n, b, dev))
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
        return _staged_xor(_int8_words(q_values), _int8_words(values),
                           split_plan(n, b, dev))
    scores = _int8_scores(values, scales, q_values)
    if mode == "score":
        return _row_max(scores, n, b, d, dev)
    _check_vector(threshold, "threshold", b, dev, True)
    return _count_at_least(scores, threshold, n, b, d)


def _probe_buffers(mode: str, b: int, splits: int, dev: torch.device):
    """(counts, words, row_max) for one probe mode, filled as the kernel's
    atomics expect; None where the mode writes nothing."""
    if mode == "compare":
        return torch.zeros((b,), dtype=torch.int32, device=dev), None, None
    if mode == "stage":
        qb = -(-b // _BLOCK_Q)
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
    q = queries.to(torch.float32).contiguous()
    splits, per = split_plan(n, b, dev)
    counts, words, row_max = _probe_buffers(mode, b, splits, dev)
    fn = (lib.anr_anatomy_f32 if emb.dtype == torch.float32
          else lib.anr_anatomy_bf16)
    with torch.cuda.device(dev):
        _launch(fn, _MODE_CODES[mode], q.data_ptr(), emb.data_ptr(), b, n,
                d, k, splits, per, _ptr(threshold), _ptr(counts),
                _ptr(words), _ptr(row_max), None, None, None, None,
                device=dev)
    anatomy_top_k.launches += 1
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
    splits, per = split_plan(n, b, dev)
    counts, words, row_max = _probe_buffers(mode, b, splits, dev)
    with torch.cuda.device(dev):
        _launch(lib.anr_anatomy_int8, _MODE_CODES[mode], q_values.data_ptr(),
                q_scales.data_ptr(), values.data_ptr(), scales.data_ptr(), b,
                n, d, k, splits, per, _ptr(threshold), _ptr(counts),
                _ptr(words), _ptr(row_max), None, None, None, None,
                device=dev)
    anatomy_top_k_int8.launches += 1
    return {"stage": words, "score": row_max, "compare": counts}[mode]


anatomy_top_k_int8.launches = 0


# -- P5: counted fold ------------------------------------------------------


def fused_top_k_counted_torch(emb: torch.Tensor, queries: torch.Tensor,
                              k: int, tau: Optional[torch.Tensor] = None):
    """Plain version of ``fused_top_k_counted``."""
    n, d, b, dev = _check_rows(emb, queries, k)
    _check_vector(tau, "tau", b, dev, False)
    return _counted_plain(_float_scores(emb, queries), n, b, d, k,
                          split_plan(n, b, dev), tau, dev)


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
        split_plan(n, b, dev), tau, dev)
    return torch.where(ids < 0, float("-inf"),
                       vals * q_scales[:, None]), ids, counts


def _counted_launch(fn, head, b: int, n: int, d: int, k: int,
                    tau: Optional[torch.Tensor], dev: torch.device):
    splits, per = split_plan(n, b, dev)
    part_v, part_i, out_v, out_i = _outputs(b, k, splits, dev)
    counts = torch.empty((b, splits, len(COUNTERS)), dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        _launch(fn, _COUNTED, *head, b, n, d, k, splits, per, _ptr(tau),
                counts.data_ptr(), None, None, part_v.data_ptr(),
                part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                device=dev)
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
    q = queries.to(torch.float32).contiguous()
    fn = (lib.anr_anatomy_f32 if emb.dtype == torch.float32
          else lib.anr_anatomy_bf16)
    out = _counted_launch(fn, (q.data_ptr(), emb.data_ptr()), b, n, d, k,
                          tau, dev)
    fused_top_k_counted.launches += 1
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
        b, n, d, k, tau, dev)
    fused_top_k_counted_int8.launches += 1
    return out


fused_top_k_counted_int8.launches = 0


def _lowered(kth: torch.Tensor) -> torch.Tensor:
    return kth - kth.abs() * TAU_SLACK - 1e-30


def subsample_tau(emb: torch.Tensor, queries: torch.Tensor,
                  k: int) -> torch.Tensor:
    """A lower bound on each row's k-th best score: the k-th best over
    every ``TAU_STRIDE``-th document (K1 on the subsample), lowered by
    ``TAU_SLACK``. As ``scripts/probe_iteration_count.py:57-67``."""
    vals, _ = fused_dense_top_k(emb[::TAU_STRIDE].contiguous(), queries, k)
    return _lowered(vals[:, -1])


def subsample_tau_int8(values: torch.Tensor, scales: torch.Tensor,
                       q_values: torch.Tensor, k: int) -> torch.Tensor:
    """``subsample_tau`` on K2's selection scores (query scales of 1)."""
    ones = torch.ones((q_values.shape[0],), device=values.device)
    vals, _ = fused_dense_top_k_int8(values[::TAU_STRIDE].contiguous(),
                                     scales[::TAU_STRIDE].contiguous(),
                                     q_values, ones, k)
    return _lowered(vals[:, -1])
