"""P4's anatomy and P5's counted fold on the cluster kernel
(``csrc/cluster_probe.cu`` over ``csrc/cluster_topk.cuh``): the probe's
plan, its launchers and its plain versions.

The rows and the score a probe selects on are its ``kind``, named as the
callers name them (``KINDS``): bf16 rows "exact" (K1's function: the f32
query against the row, f32 sums, unrounded), "rounded" (K1r) or
"compare" (K1c); int8 rows "exact" (K2's: float(acc) * doc scale, the
query scale after selection) or "rounded" (K2r). ``source_kind`` maps
them to the kernel's row kinds (``cluster_topk.KINDS``).

A probe runs one pass over every row in one of ``MODES``:

- "stage": the ring alone. int32 [query blocks, walkers]: per CTA the XOR
  of every 32-bit word that landed in its ring slots (with multicast the
  whole cluster's boxes: each doc word of the walker's tiles once, zero
  past the rows and the row) and of its resident query planes (the kind's:
  int8 q, the f32 query's three bf16 planes ``split_query``, bf16(q)),
  zero past B. XOR does not depend on order or on the swizzle: exact.
- "score": + wgmma. f32 [B]: each row's best selection score (the
  rounded kinds' -0.0 carried as the negative denormal 0x80000001; rows
  past N and masked docs never count; -inf if none; a best of zero may
  carry either sign, which torch.equal does not tell apart).
- "compare": + the epilogue's test against the pinned ``threshold`` [B].
  int32 [B]: the docs whose selection score is at least it.
- "full": + the offers and the merge: the main pass with its lists seeded
  (``tau`` [B]: every slot (tau, empty); ``lists``: an earlier pass's top
  k as the kernel's ``seed_lists`` takes it; neither: -inf), its walkers'
  lists merged into (values [B, k], ids [B, k]) as the folds return them.
- "counted": "full" with counters, (values, ids, counts [B, walkers, 4],
  heap [B, walkers]). Against each walker's list as a tile began (the
  top k of its seed and of its earlier tiles' docs under (score desc, id
  asc)), a doc enters iff it beats that list's worst entry; ``counts``:
  entries in the walker's first ``EARLY_TILES`` tiles, entries after
  them, tiles with an entry, tiles seen. ``heap``: the kernel's own
  insertions (docs that beat the heap's top as offered), which depend on
  the order of lanes and warpgroups; the plain version gives the tile's
  survivors there instead (its docs still in the list as it ends), and a
  run is held to survivors <= insertions <= entries.

``top_k`` is the whole call of a kind on this design (the seed, tau and
main passes and the merges): for the exact kinds, K1's or K2's lists.

The plan (``probe_plan``) is ``cluster_plan``'s for the kind (with the
counters' shared memory for "counted"); a probe runs only where it takes
the TMA route with the query planes resident, and past ``SPLIT_MAX_B``
queries: elsewhere it raises, on the CPU as on the card (f32 rows and B
<= 16 are the split design's alone). On CUDA tensors the launchers run
the kernel or raise; the plain versions (``*_torch``) compute each output
directly, the counters by replaying every walker tile by tile over the
plan's walker ranges: on the CPU an H100's 132 SMs, on the card the
device's ``active_clusters``, passed in.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels import cluster_topk as ct
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    TAU_STRIDE,
    _chunk_rows,
    _launch,
    _lowered,
    _plain_top_k,
    _ptr,
    _sm_count,
    round_scores,
    split_query,
    unround_values,
)
from a_nice_rag_tpu_torch.ops.quantized import int8_dot

KINDS = ("exact", "rounded", "compare")
# The source's Mode.
MODES = {"full": 0, "stage": 1, "score": 2, "compare": 3, "counted": 4}
COUNTERS = ("early", "late", "tiles_entered", "tiles_seen")
EARLY_TILES = 16
# Batches up to this many queries are the split design's alone.
SPLIT_MAX_B = 16
EMPTY_ID = 2**31 - 1
# Elements of a plain replay step's [B, walkers, docs] block.
_REPLAY_ELEMS = 1 << 25

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = _build.load("cluster_probe")
    if not hasattr(lib, "_anr_bound"):
        # kind, mode; q, q scales, e, scales, mask, seed, list_v, list_i;
        # list_every B N D k qg cl groups stages resident smem walkers;
        # part_v, part_i, words, best, counts, out_v, out_i, stream.
        lib.anr_cluster_probe.argtypes = [_I] * 2 + [_P] * 8 + [_I] * 12 \
            + [_P] * 8
        # kind; q, q scales, e, scales; B N D k qg cl groups stages
        # resident smem tma walkers tau_tma tau_walkers seed_tma
        # seed_walkers; workspace, out_v, out_i, stream.
        lib.anr_cluster_exact_topk.argtypes = [_I] + [_P] * 4 + [_I] * 16 \
            + [_P] * 4
        lib.anr_cluster_probe_active_clusters.argtypes = [_I] * 5
        for fn in (lib.anr_cluster_probe, lib.anr_cluster_exact_topk,
                   lib.anr_cluster_probe_active_clusters):
            fn.restype = _I
        lib._anr_bound = True
    return lib


def source_kind(int8: bool, kind: str) -> str:
    """The kernel's row kind for rows int8 (else bf16) and ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if not int8:
        return kind
    if kind == "compare":
        raise ValueError("int8 rows have no compare kind")
    return "int8_exact" if kind == "exact" else "int8"


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")


def probe_plan(n: int, b: int, d: int, k: int, kind: str,
               counted: bool = False, sms: int = ct.H100_SMS,
               aligned: bool = True, active_clusters: Optional[int] = None,
               qg: Optional[int] = None) -> ct.ClusterPlan:
    """``cluster_plan`` of a probe over rows of the source kind ``kind``
    (``counted``: with the counters in shared memory); ValueError where
    the cluster design does not take the call: B <= ``SPLIT_MAX_B``, query
    planes not resident, rows the TMA cannot take."""
    if b <= SPLIT_MAX_B:
        raise ValueError(f"B = {b}: the cluster design takes B > "
                         f"{SPLIT_MAX_B} (smaller batches are the split "
                         f"design's)")
    plan = ct.cluster_plan(n, b, d, k, sms, aligned, active_clusters, qg=qg,
                           kind=kind, counted=counted)
    if not plan.resident:
        raise ValueError(f"the {kind} rows' query planes at B = {b}, D = "
                         f"{d}, k = {k} do not stay resident in a CTA")
    if not plan.tma:
        raise ValueError(f"the TMA does not take these rows (N = {n}, D = "
                         f"{d}, aligned = {aligned})")
    return plan


@functools.lru_cache(maxsize=128)
def device_active_clusters(index: int, kind: str, mode: str, qg: int,
                           cl: int, smem: int) -> int:
    """Clusters of ``cl`` CTAs of the probe kernel over rows ``kind`` in
    ``mode`` with ``smem`` bytes each that CUDA device ``index`` holds at
    once (cudaOccupancyMaxActiveClusters)."""
    with torch.cuda.device(index):
        n = _library().anr_cluster_probe_active_clusters(
            ct.KINDS[kind], MODES[mode], qg, cl, smem)
    if n < 1:
        raise RuntimeError(f"anr_cluster_probe_active_clusters({kind!r}, "
                           f"{mode!r}, {qg}, {cl}, {smem}) returned {n}")
    return n


def active_clusters(rows: torch.Tensor, b: int, k: int, kind: str,
                    mode: str, qg: Optional[int] = None) -> int:
    """Clusters of the probe's shape that the rows' CUDA device holds at
    once (the count its walkers come from; give it to the plain version
    to replay the same walks). Raises where ``probe_plan`` does."""
    _check_mode(mode)
    (n, d), dev = rows.shape, rows.device
    plan = probe_plan(n, b, d, k, kind, mode == "counted", _sm_count(dev),
                      rows.data_ptr() % 16 == 0, qg=qg)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return device_active_clusters(index, kind, mode, plan.qg, plan.cluster,
                                  plan.smem_bytes)


def _device_plan(rows, b, k, kind, mode, qg):
    (n, d), dev = rows.shape, rows.device
    return probe_plan(n, b, d, k, kind, mode == "counted", _sm_count(dev),
                      rows.data_ptr() % 16 == 0,
                      active_clusters(rows, b, k, kind, mode, qg), qg)


def query_planes(queries: torch.Tensor, kind: str) -> torch.Tensor:
    """The query planes the kernel multiplies for the source kind: int8 q
    [B, D]; the three bf16 planes [3, B, D] of the f32 query; bf16(q)."""
    if ct.ELEMENT_BYTES[kind] == 1:
        return queries.contiguous()
    if ct.PLANES[kind] == 3:
        return split_query(queries).contiguous()
    return queries.to(torch.bfloat16).contiguous()


# -- the launchers (CUDA tensors the caller has checked) ---------------------


def cluster_probe(mode: str, rows: torch.Tensor, queries: torch.Tensor,
                  k: int, kind: str, scales: Optional[torch.Tensor] = None,
                  q_scales: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  tau: Optional[torch.Tensor] = None,
                  lists: Optional[Tuple[torch.Tensor, torch.Tensor,
                                        int]] = None,
                  threshold: Optional[torch.Tensor] = None,
                  qg: Optional[int] = None):
    """One probe pass on the card: rows [N, D] (int8 with ``scales`` and
    ``q_scales``, or bf16 with an optional [N] bool ``mask``), queries
    [B, D] (int8, or f32 / bf16), the source ``kind``; the outputs of the
    module docstring. Raises where the plan refuses or a launch fails."""
    _check_mode(mode)
    (n, d), b, dev = rows.shape, queries.shape[0], rows.device
    plan = _device_plan(rows, b, k, kind, mode, qg)
    fold = mode in ("full", "counted")
    f32, i32 = dict(dtype=torch.float32, device=dev), \
        dict(dtype=torch.int32, device=dev)
    words = best = counts = part_v = part_i = out_v = out_i = None
    if mode == "stage":
        words = torch.zeros((plan.groups * plan.cluster, plan.walkers), **i32)
    elif mode == "score":
        best = torch.full((b,), float("-inf"), **f32)
    elif mode == "compare":
        counts = torch.zeros((b,), **i32)
    if fold:
        part_v = torch.empty((b, plan.walkers, k), **f32)
        part_i = torch.empty((b, plan.walkers, k), **i32)
        out_v = torch.empty((b, k), **f32)
        out_i = torch.empty((b, k), **i32)
    if mode == "counted":
        counts = torch.empty((b, plan.walkers, ct.CLUSTER_COUNTERS), **i32)
    list_v, list_i, every = lists if lists is not None else (None, None, 0)
    seed = threshold if mode == "compare" else tau
    q = query_planes(queries, kind)
    _launch(_library().anr_cluster_probe, ct.KINDS[kind], MODES[mode],
            q.data_ptr(), _ptr(q_scales), rows.data_ptr(), _ptr(scales),
            _ptr(mask), _ptr(seed), _ptr(list_v), _ptr(list_i), every, b, n,
            d, k, plan.qg, plan.cluster, plan.groups, plan.stages,
            int(plan.resident), plan.smem_bytes, plan.walkers, _ptr(part_v),
            _ptr(part_i), _ptr(words), _ptr(best), _ptr(counts), _ptr(out_v),
            _ptr(out_i), device=dev)
    if mode == "stage":
        return words
    if mode == "score":
        return best
    if mode == "compare":
        return counts
    if mode == "full":
        return out_v, out_i
    return out_v, out_i, counts[..., :4], counts[..., 4]


def top_k(rows: torch.Tensor, queries: torch.Tensor, k: int, kind: str,
          scales: Optional[torch.Tensor] = None,
          q_scales: Optional[torch.Tensor] = None,
          qg: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole call of a kind on the cluster kernel, on the card: the
    exact kinds through ``csrc/cluster_probe.cu`` (K1's or K2's lists),
    the others through the folds' launchers (K1r, K1c, K2r). Raises where
    the plan refuses or a launch fails."""
    (n, d), b, dev = rows.shape, queries.shape[0], rows.device
    sms = _sm_count(dev)
    probe_plan(n, b, d, k, kind, False, sms, rows.data_ptr() % 16 == 0,
               qg=qg)
    if kind == "int8":
        return ct.rounded_top_k_int8(rows, scales, queries, q_scales, k, sms,
                                     qg)
    if kind in ("rounded", "compare"):
        return ct.bf16_top_k(rows, queries, k, sms, kind, qg=qg)
    plan = _device_plan(rows, b, k, kind, "full", qg)
    ws = torch.empty(ct.workspace_bytes(b, k, plan.walkers, plan.tau_walkers,
                                        plan.seed_walkers, d, kind),
                     dtype=torch.uint8, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    q = queries.contiguous() if kind == "int8_exact" else \
        queries.to(torch.float32).contiguous()
    _launch(_library().anr_cluster_exact_topk, ct.KINDS[kind], q.data_ptr(),
            _ptr(q_scales), rows.data_ptr(), _ptr(scales), b, n, d, k,
            plan.qg, plan.cluster, plan.groups, plan.stages,
            int(plan.resident), plan.smem_bytes, int(plan.tma), plan.walkers,
            int(plan.tau_tma), plan.tau_walkers, int(plan.seed_tma),
            plan.seed_walkers, ws.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), device=dev)
    return out_v, out_i


# -- plain versions -------------------------------------------------------


def _scorer(kind: str, rows: torch.Tensor, scales: Optional[torch.Tensor],
            queries: torch.Tensor, mask: Optional[torch.Tensor]):
    """fn(sel) -> [B, M] selection scores of the docs rows[sel] (a slice
    or an index tensor): NaN where masked; -0.0 as +0.0 for the kinds that
    tie them (only the rounded kinds order a -0.0, carried)."""
    if ct.ELEMENT_BYTES[kind] == 1:
        qv = queries
    elif kind == "compare":
        q = queries.to(torch.bfloat16).to(torch.float32)
    else:
        q = queries.to(torch.float32)

    def scores(sel) -> torch.Tensor:
        if ct.ELEMENT_BYTES[kind] == 1:
            s = int8_dot(qv, rows[sel]).to(torch.float32) * scales[sel][None]
        else:
            s = q @ rows[sel].to(torch.float32).T
            if kind == "compare":
                s = s.to(torch.bfloat16).to(torch.float32)
        s = round_scores(s) if kind in ("rounded", "int8") else s + 0.0
        if mask is not None:
            s = torch.where(mask[sel][None], s, float("nan"))
        return s

    return scores


def _words(x: torch.Tensor) -> torch.Tensor:
    """The little-endian 32-bit words of the rows (last dimension) of int8
    or bf16 x, whose rows are whole words here (the TMA's rows are)."""
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.contiguous().view(torch.int32)


def _xor_all(x: torch.Tensor) -> torch.Tensor:
    """The XOR of every element of an int32 tensor (0 if empty)."""
    x = x.reshape(-1)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        half = x.numel() // 2
        x = torch.bitwise_xor(x[:half], x[half:])
    return x[0] if x.numel() else torch.zeros((), dtype=torch.int32,
                                              device=x.device)


def _walks(plan: ct.ClusterPlan, n: int, device: torch.device):
    """Each walker's tiles [t_begin, t_end) and docs [lo, hi), as the
    kernel splits plan.tiles among plan.walkers."""
    t = ct.tile_docs(plan.qg)
    per = -(-plan.tiles // plan.walkers)
    t_begin = torch.arange(plan.walkers, device=device) * per
    t_end = (t_begin + per).clamp(max=plan.tiles)
    return per, t_begin, t_end, t_begin * t, (t_end * t).clamp(max=n)


def _stage_plain(rows, planes, plan) -> torch.Tensor:
    n, dev = rows.shape[0], rows.device
    _, _, _, lo, hi = _walks(plan, n, dev)
    ex = torch.stack([_xor_all(_words(rows[int(a):max(int(a), int(z))]))
                      for a, z in zip(lo.tolist(), hi.tolist())])
    if planes.ndim == 2:
        planes = planes[None]
    qw = _words(planes)  # [P, B, W]
    q = ct.cta_queries(plan.qg)
    blocks = plan.groups * plan.cluster
    qw = torch.nn.functional.pad(qw, (0, 0, 0, blocks * q - qw.shape[1]))
    qx = torch.stack([_xor_all(qw[:, i * q:(i + 1) * q])
                      for i in range(blocks)])
    return torch.bitwise_xor(qx[:, None], ex[None, :])


def _best_plain(scores, n, b, d, device) -> torch.Tensor:
    best = torch.full((b,), float("-inf"), device=device)
    step = _chunk_rows(b, d)
    for s0 in range(0, n, step):
        s = scores(slice(s0, min(n, s0 + step)))
        s = torch.where(torch.isnan(s), float("-inf"), s)
        best = torch.maximum(best, s.amax(dim=1))
    return best


def _count_plain(scores, threshold, n, b, d) -> torch.Tensor:
    count = torch.zeros((b,), dtype=torch.int64, device=threshold.device)
    step = _chunk_rows(b, d)
    for s0 in range(0, n, step):
        s = scores(slice(s0, min(n, s0 + step)))
        count += (s >= threshold[:, None]).sum(dim=1)
    return count.to(torch.int32)


def top_k_by_rule(v: torch.Tensor, i: torch.Tensor, k: int):
    """The k best of each row's (value, id) pairs under (value desc, id
    asc), in that order."""
    i, pos = torch.sort(i, dim=-1, stable=True)
    v = torch.take_along_dim(v, pos, dim=-1)
    v, pos = torch.sort(v, dim=-1, descending=True, stable=True)
    i = torch.take_along_dim(i, pos, dim=-1)
    return v[..., :k], i[..., :k]


def _lowered_kept(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``lowered``: finite scores lowered, the others kept."""
    return torch.where(torch.isfinite(x), _lowered(x), x)


def _seeded(b, k, plan, n, tau, lists, device):
    """Every walker's list as the kernel seeds it, values descending and
    ids EMPTY_ID: [B, walkers, k] each."""
    w = plan.walkers
    if lists is None:
        if tau is None:
            v = torch.full((b, w, k), float("-inf"), device=device)
        else:
            v = tau.to(torch.float32)[:, None, None].expand(b, w, k).clone()
    else:
        lv, li, every = lists
        t = ct.tile_docs(plan.qg)
        _, t_begin, t_end, _, _ = _walks(plan, n, device)
        d_lo, d_hi = t_begin * t, t_end * t
        doc = li.to(torch.int64)[:, None, :] * every
        outside = (li[:, None, :] >= 0) & ((doc < d_lo[None, :, None])
                                           | (doc >= d_hi[None, :, None]))
        low = _lowered_kept(lv.to(torch.float32))
        v = torch.where(outside, low[:, None, :],
                        low[:, k - 1][:, None, None])
        v = torch.sort(v, dim=-1, descending=True).values
    return v, torch.full((b, w, k), EMPTY_ID, dtype=torch.int64,
                         device=device)


def _replay(scores, n, b, k, plan, run_v, run_i, count: bool, device):
    """Each walker's list tile by tile (``count``) or a block of tiles at a
    time: the lists at the end, and with ``count`` the counters [B, W, 4]
    and the tiles' survivors [B, W] (int64)."""
    t = ct.tile_docs(plan.qg)
    w = plan.walkers
    per, t_begin, t_end, lo, hi = _walks(plan, n, device)
    i64 = dict(dtype=torch.int64, device=device)
    counts = torch.zeros((b, w, len(COUNTERS)), **i64)
    counts[..., 3] = (t_end - t_begin).clamp(min=0)[None]
    survived = torch.zeros((b, w), **i64)
    step = 1 if count else max(1, _REPLAY_ELEMS // (b * w * t))
    for s0 in range(0, per, step):
        m = min(step, per - s0) * t
        ids = lo[:, None] + s0 * t + torch.arange(m, device=device)[None]
        valid = ids < hi[:, None]
        if not bool(valid.any()):
            break
        s = scores(ids.clamp(max=n - 1).reshape(-1)).reshape(b, w, m)
        cand = valid[None] & ~torch.isnan(s)
        s = torch.where(cand, s, float("-inf"))
        sid = torch.where(cand, ids[None], EMPTY_ID)
        if count:
            wv, wi = run_v[..., -1:], run_i[..., -1:]
            ent = cand & ((s > wv) | ((s == wv) & (sid < wi)))
            e = ent.sum(dim=-1)
            counts[..., 0 if s0 < EARLY_TILES else 1] += e
            counts[..., 2] += e > 0
        run_v, run_i = top_k_by_rule(torch.cat([run_v, s], dim=-1),
                                      torch.cat([run_i, sid], dim=-1), k)
        if count:
            t_lo = (lo + s0 * t)[None, :, None]
            survived += ((run_i >= t_lo) & (run_i < t_lo + t)).sum(dim=-1)
    return run_v, run_i, counts, survived


def _merged(run_v, run_i, k, kind, q_scales):
    """The merge of the walkers' lists as the kernel's: the k best entries
    that are docs, (-inf, -1) past them; the rounded kinds' -0.0 written
    back, int8 kinds' values times the query scale."""
    b = run_v.shape[0]
    run_v = torch.where(run_i == EMPTY_ID, float("-inf"), run_v)
    v, i = top_k_by_rule(run_v.reshape(b, -1), run_i.reshape(b, -1), k)
    return _finish(v, i, kind, q_scales, i == EMPTY_ID)


def _finish(v, i, kind, q_scales, empty):
    if kind in ("rounded", "int8"):
        v = unround_values(v)
    if ct.ELEMENT_BYTES[kind] == 1:
        v = v * q_scales[:, None]
    return (torch.where(empty, float("-inf"), v),
            torch.where(empty, -1, i).to(torch.int32))


def cluster_probe_torch(mode: str, rows: torch.Tensor, queries: torch.Tensor,
                        k: int, kind: str,
                        scales: Optional[torch.Tensor] = None,
                        q_scales: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None,
                        tau: Optional[torch.Tensor] = None,
                        lists=None,
                        threshold: Optional[torch.Tensor] = None,
                        qg: Optional[int] = None, sms: int = ct.H100_SMS,
                        active: Optional[int] = None):
    """Plain version of ``cluster_probe`` on the rows' device, over the
    walks of ``probe_plan`` with ``sms`` and ``active`` clusters (the
    card's: ``active_clusters``); "counted"'s last output is the tiles'
    survivors (see the module docstring)."""
    _check_mode(mode)
    (n, d), b, dev = rows.shape, queries.shape[0], rows.device
    plan = probe_plan(n, b, d, k, kind, mode == "counted", sms,
                      rows.data_ptr() % 16 == 0, active, qg)
    if mode == "stage":
        return _stage_plain(rows, query_planes(queries, kind), plan)
    scores = _scorer(kind, rows, scales, queries, mask)
    if mode == "score":
        return _best_plain(scores, n, b, d, dev)
    if mode == "compare":
        return _count_plain(scores, threshold, n, b, d)
    run_v, run_i = _seeded(b, k, plan, n, tau, lists, dev)
    run_v, run_i, counts, survived = _replay(scores, n, b, k, plan, run_v,
                                             run_i, mode == "counted", dev)
    vals, ids = _merged(run_v, run_i, k, kind, q_scales)
    if mode == "full":
        return vals, ids
    return vals, ids, counts.to(torch.int32), survived.to(torch.int32)


def top_k_torch(rows: torch.Tensor, queries: torch.Tensor, k: int,
                kind: str, scales: Optional[torch.Tensor] = None,
                q_scales: Optional[torch.Tensor] = None,
                qg: Optional[int] = None, sms: int = ct.H100_SMS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``top_k``: the k best docs under the kind's
    selection score (score desc, id asc), as the whole call returns them
    (K1's or K2's lists for the exact kinds); raises where the plan
    refuses, as ``top_k`` does."""
    (n, d), b = rows.shape, queries.shape[0]
    probe_plan(n, b, d, k, kind, False, sms, rows.data_ptr() % 16 == 0,
               qg=qg)
    scores = _scorer(kind, rows, scales, queries, None)
    vals, ids = _plain_top_k(lambda s0, s1: scores(slice(s0, s1)), n, b, d,
                             k, rows.device)
    return _finish(vals, ids, kind, q_scales, ids < 0)


def subsample_seeds(rows: torch.Tensor, queries: torch.Tensor, k: int,
                    kind: str, scales: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor, int]]:
    """The two warm starts of a counted probe, from the subsample of every
    TAU_STRIDE-th row on its selection scores (plain torch, on the rows'
    device): tau [B] (its k-th best, lowered; -inf with fewer than k) and
    the lists (values [B, k], ids [B, k] int32 in the subsample's rows,
    TAU_STRIDE) that the kernel's ``seed_lists`` takes, as K1r's main pass
    gets them from its tau pass."""
    sub = slice(0, rows.shape[0], TAU_STRIDE)
    s = _scorer(kind, rows, scales, queries, None)(sub)
    vals, ids = _plain_top_k(lambda s0, s1: s[:, s0:s1], s.shape[1],
                             s.shape[0], 1, k, rows.device)
    return (_lowered_kept(vals[:, k - 1]).contiguous(),
            (vals.contiguous(), ids.contiguous(), TAU_STRIDE))
