"""Where does the fused top-k kernel's time go? An ablation of K1/K2.

    python -m a_nice_rag_tpu_torch.probes.kernel_anatomy [bf16|int8] [N]
        [--design split|cluster] [--kind exact|rounded|compare]

Counterpart of ``scripts/profile_kernel_anatomy.py`` (which attributed
the TPU kernel's time the same way, docs/BENCHMARKS.md:234-252). Four
calls share K1/K2's grid, block and shared-memory layout and differ only
in the work per tile (``ops.kernels.anatomy``):

  stage    the staging (the query block and the tiles' bytes through the
           ring of copies into shared memory);
  score    + scoring (K1: bf16 tensor-core MMA on bf16 rows, FFMA on f32
           rows; K2: int8 MMA);
  compare  + the fold's compare pass against a threshold of +inf (no
           insertion; K1 flags the rows with a score at least the
           threshold as it writes the scores, and its fold skips the
           rest, here every row);
  full     K1/K2 as they are: + the tau pass, insertions and the merge.

The three deltas attribute the kernel to loads, scoring, the compare pass
and the insertions. ``--design cluster`` runs the same four modes on the
cluster kernel (``anatomy_top_k(..., design="cluster", kind=...)``): the
TMA-multicast ring alone, + wgmma, + the epilogue's threshold test (at
+inf: nothing offered), and the kind's whole call (seed, tau and main
passes, the merges); beside them the main pass alone, seeded with the
subsample's tau, and its offers (full main pass - compare). Default:
the TPU probe's shape, 4,005,888 x 256 bf16 rows (randn), B = 256 bf16
queries, k = 32; ``int8``: 10,485,760 x 1024 int8 rows, B = 256, k =
25. Each mode is first held against its plain version on the whole
matrix. One JSON line, with the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional

import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops.kernels import anatomy as A
from a_nice_rag_tpu_torch.ops.kernels import cluster_probe as CP

TimeFn = Callable[[Callable[[], object], int], float]
# kind -> (N, D, B, k)
SHAPES = {"bf16": (4_005_888, 256, 256, 32),
          "int8": (10_485_760, 1024, 256, 25)}
N_LOOP = 5  # timed calls per mode, after one warm-up
# One H100 SXM (NVIDIA data sheet): HBM bytes/s.
HBM_BYTES_S = 3.35e12
# The cluster design's "score" against its plain version on float rows:
# the exact kind's f32 sums within 1e-5 of the largest |score|, the
# rounded and compare kinds within one bf16 ulp of it (the two sums may
# straddle a rounding midpoint).
CLUSTER_TOL = {"exact": 1e-5, "rounded": 2.0 ** -8, "compare": 2.0 ** -8}


def _calls(emb, queries, k, scales, q_scales, threshold) -> Dict[str, tuple]:
    """mode -> (kernel call, plain call)."""
    out = {}
    for mode in A.MODES:
        thr = threshold if mode == "compare" else None
        if scales is None:
            out[mode] = (
                lambda m=mode, t=thr: A.anatomy_top_k(emb, queries, k, m, t),
                lambda m=mode, t=thr: A.anatomy_top_k_torch(emb, queries, k,
                                                            m, t))
        else:
            args = (emb, scales, queries, q_scales, k)
            out[mode] = (
                lambda m=mode, t=thr: A.anatomy_top_k_int8(*args, m, t),
                lambda m=mode, t=thr: A.anatomy_top_k_int8_torch(*args, m, t))
    return out


def _threshold(top: torch.Tensor, tol: float) -> torch.Tensor:
    """Per row, a threshold halfway across the last gap wider than ``tol``
    in the row's top-k list ``top`` (descending, with a virtual entry
    2 tol above its best), so that two summation orders agree on which
    scores lie above it: a score inside the gap would be in the list."""
    s = torch.cat([top[:, :1] + 2 * tol, top], dim=1)
    wide = ((s[:, :-1] - s[:, 1:]) > tol).to(torch.int32)
    j = (wide.shape[1] - 1 - wide.flip(1).argmax(dim=1))[:, None]
    return ((s.gather(1, j) + s.gather(1, j + 1)) / 2).squeeze(1).contiguous()


def check(emb: torch.Tensor, queries: torch.Tensor, k: int,
          scales: Optional[torch.Tensor] = None,
          q_scales: Optional[torch.Tensor] = None) -> float:
    """Every mode against its plain version: "stage" bit for bit, "score"
    within 1e-5 of the largest |best score| (f32 rows: two summation
    orders; int8 rows exactly), "compare" exactly at a threshold taken
    from the plain top-k that no score lies within that tolerance of,
    "full" as K1/K2 are held (ties within 1e-4 for f32 and bf16 rows,
    int8 exactly). The plain versions work chunk by chunk, so this runs
    at the size of the matrices the probe times. Raises on a difference;
    returns the largest "score" difference."""
    from a_nice_rag_tpu_torch.testing.parity import check_top_k

    exact = scales is not None
    plain = _calls(emb, queries, k, scales, q_scales, None)
    want = {mode: plain[mode][1]() for mode in ("full", "score")}
    tol = 0.0 if exact else 1e-5 * max(1.0,
                                       float(want["score"].abs().max()))
    top = want["full"][0]
    if exact:  # the threshold is on the selection scores
        top = top / q_scales[:, None]
    calls = _calls(emb, queries, k, scales, q_scales,
                   _threshold(top, max(tol, 1e-6) * 4))
    err = 0.0
    for mode, (kernel, ref) in calls.items():
        got = kernel()
        expected = want[mode] if mode in want else ref()
        if mode == "full":
            check_top_k(expected[0], expected[1], got[0], got[1],
                        0.0 if exact else 1e-4)
        elif mode == "score":
            err = float((got - expected).abs().max())
            if not err <= tol:
                raise AssertionError(f"anatomy score differs by {err} "
                                     f"(tolerance {tol})")
        elif not torch.equal(got, expected):
            raise AssertionError(f"anatomy {mode} differs from its plain "
                                 f"version")
    return err


def run(emb: torch.Tensor, queries: torch.Tensor, k: int, time_ms: TimeFn,
        scales: Optional[torch.Tensor] = None,
        q_scales: Optional[torch.Tensor] = None) -> dict:
    """The four modes' device ms and their deltas (int8 rows when
    ``scales`` is given), and the ms of K1/K2's tau pass alone (its part
    of the last delta)."""
    b = queries.shape[0]
    inf = torch.full((b,), float("inf"), device=emb.device)
    calls = _calls(emb, queries, k, scales, q_scales, inf)
    ms = {mode: time_ms(kernel, N_LOOP)
          for mode, (kernel, _) in calls.items()}
    tau_ms = time_ms(
        (lambda: A.subsample_tau(emb, queries, k)) if scales is None else
        (lambda: A.subsample_tau_int8(emb, scales, queries, k)), N_LOOP)
    n, d = emb.shape
    nbytes = emb.numel() * emb.element_size()
    return {
        "rows": "int8" if scales is not None else str(emb.dtype)[6:],
        "n": n, "d": d, "b": b, "k": k, "ms": ms,
        "loads_ms": ms["stage"],
        "scoring_ms": ms["score"] - ms["stage"],
        "compare_ms": ms["compare"] - ms["score"],
        "insert_merge_ms": ms["full"] - ms["compare"],
        "tau_pass_ms": tau_ms,
        "splits": (A.split_plan(n, b, d, k, str(emb.dtype)[6:],
                                emb.device).splits if scales is None else
                   A.split_plan_int8(n, b, d, k, emb.device).splits),
        "stage_gb_s": nbytes / 1e9 / ms["stage"] * 1e3,
        "byte_floor_ms": nbytes / HBM_BYTES_S * 1e3,
    }


def _cluster_calls(rows, queries, k, kind, scales, q_scales, threshold,
                   active) -> Dict[str, tuple]:
    """mode -> (kernel call, plain call) of the cluster design; the plain
    versions walk the card's ``active`` clusters' ranges (per mode)."""
    out = {}
    for mode in A.MODES:
        thr = threshold if mode == "compare" else None
        if scales is None:
            out[mode] = (
                lambda m=mode, t=thr: A.anatomy_top_k_cluster(
                    rows, queries, k, m, t, kind),
                lambda m=mode, t=thr: A.anatomy_top_k_cluster_torch(
                    rows, queries, k, m, t, kind, active.get(m)))
        else:
            args = (rows, scales, queries, q_scales, k)
            out[mode] = (
                lambda m=mode, t=thr: A.anatomy_top_k_int8_cluster(
                    *args, m, t, kind),
                lambda m=mode, t=thr: A.anatomy_top_k_int8_cluster_torch(
                    *args, m, t, kind, active.get(m)))
    return out


def check_cluster(rows: torch.Tensor, queries: torch.Tensor, k: int,
                  kind: str = "exact",
                  scales: Optional[torch.Tensor] = None,
                  q_scales: Optional[torch.Tensor] = None,
                  exact: Optional[bool] = None) -> float:
    """Every mode of the cluster design against its plain version over the
    card's walks: "stage" bit for bit; "score" exactly where ``exact``
    (int8 rows, or integer grids: the default for int8 rows only), else
    within CLUSTER_TOL[kind] of the largest |score|; "compare" exactly, at
    a threshold from the plain lists that no score lies within that
    tolerance of; "full" (the kind's whole call) exactly where ``exact``,
    else through check_top_k at the tolerance (for "exact": K1's plain
    version, F32 tolerance). Raises on a difference; returns the largest
    "score" difference."""
    from a_nice_rag_tpu_torch.testing.parity import check_top_k

    exact = scales is not None if exact is None else exact
    b = queries.shape[0]
    active = {m: A.cluster_active_clusters(rows, b, k, kind, m)
              for m in ("stage", "score", "compare")}
    plain = _cluster_calls(rows, queries, k, kind, scales, q_scales, None,
                           active)
    want = {mode: plain[mode][1]() for mode in ("full", "score")}
    finite = want["score"][torch.isfinite(want["score"])]
    big = max(1.0, float(finite.abs().max())) if finite.numel() else 1.0
    tol = 0.0 if exact else CLUSTER_TOL[kind] * big
    top = want["full"][0]
    if scales is not None:  # the threshold is on the selection scores
        top = top / q_scales[:, None]
    calls = _cluster_calls(rows, queries, k, kind, scales, q_scales,
                           _threshold(top, max(tol, 1e-6) * 4), active)
    err = 0.0
    for mode, (kernel, ref) in calls.items():
        got = kernel()
        expected = want[mode] if mode in want else ref()
        if mode == "full":
            if exact:
                ok = torch.equal(got[0], expected[0]) and torch.equal(
                    got[1], expected[1])
                if not ok:
                    raise AssertionError(f"cluster {kind} full differs "
                                         f"from its plain version")
            else:
                check_top_k(expected[0], expected[1], got[0], got[1], tol)
        elif mode == "score":
            both = torch.isfinite(got) & torch.isfinite(expected)
            err = float((got - expected)[both].abs().max()) \
                if bool(both.any()) else 0.0
            if not (err <= tol and torch.equal(torch.isfinite(got),
                                               torch.isfinite(expected))):
                raise AssertionError(f"cluster {kind} score differs by "
                                     f"{err} (tolerance {tol})")
        elif not torch.equal(got, expected):
            raise AssertionError(f"cluster {kind} {mode} differs from its "
                                 f"plain version")
    return err


def run_cluster(rows: torch.Tensor, queries: torch.Tensor, k: int,
                time_ms: TimeFn, kind: str = "exact",
                scales: Optional[torch.Tensor] = None,
                q_scales: Optional[torch.Tensor] = None) -> dict:
    """The cluster design's four modes (compare at +inf), the main pass
    alone seeded with the subsample's tau ("main_pass"), their device ms
    and deltas, and the probe's plan."""
    b = queries.shape[0]
    inf = torch.full((b,), float("inf"), device=rows.device)
    calls = _cluster_calls(rows, queries, k, kind, scales, q_scales, inf, {})
    ms = {mode: time_ms(kernel, N_LOOP)
          for mode, (kernel, _) in calls.items()}
    src = CP.source_kind(scales is not None, kind)
    tau, _ = CP.subsample_seeds(rows, queries, k, src, scales)
    probe = CP.cluster_probe if rows.is_cuda else CP.cluster_probe_torch
    ms["main_pass"] = time_ms(lambda: probe(
        "full", rows, queries, k, src, scales, q_scales, tau=tau), N_LOOP)
    n, d = rows.shape
    plan = CP.probe_plan(n, b, d, k, src, active_clusters=(
        A.cluster_active_clusters(rows, b, k, kind, "full")),
        sms=CP._sm_count(rows.device) if rows.is_cuda else CP.ct.H100_SMS)
    nbytes = rows.numel() * rows.element_size()
    return {
        "design": "cluster", "kind": kind,
        "rows": "int8" if scales is not None else str(rows.dtype)[6:],
        "n": n, "d": d, "b": b, "k": k, "ms": ms,
        "loads_ms": ms["stage"],
        "scoring_ms": ms["score"] - ms["stage"],
        "compare_ms": ms["compare"] - ms["score"],
        "insert_merge_ms": ms["full"] - ms["compare"],
        "main_pass_offers_ms": ms["main_pass"] - ms["compare"],
        "plan": {key: getattr(plan, key) for key in (
            "qg", "cluster", "groups", "walkers", "stages", "smem_bytes")},
        "stage_gb_s": nbytes / 1e9 / ms["stage"] * 1e3,
        "byte_floor_ms": nbytes / HBM_BYTES_S * 1e3,
    }


def make_rows(kind: str, n: int, device: torch.device):
    """(rows, queries, k, scales, q_scales) of the probe's shapes."""
    _, d, b, k = SHAPES[kind]
    g = torch.Generator(device=device).manual_seed(0)
    if kind == "bf16":
        emb = torch.randn((n, d), generator=g,
                          device=device).to(torch.bfloat16)
        q = torch.randn((b, d), generator=g, device=device).to(torch.bfloat16)
        return emb, q, k, None, None
    values = torch.randint(-127, 128, (n, d), generator=g, device=device,
                           dtype=torch.int8)
    q_values = torch.randint(-127, 128, (b, d), generator=g, device=device,
                             dtype=torch.int8)
    scales = torch.rand(n, generator=g, device=device) * 1e-2 + 1e-3
    q_scales = torch.rand(b, generator=g, device=device) * 1e-2 + 1e-3
    return values, q_values, k, scales, q_scales


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="?", default="bf16", choices=list(SHAPES))
    ap.add_argument("n", nargs="?", type=int, default=None)
    ap.add_argument("--design", default="split", choices=list(A.DESIGNS))
    ap.add_argument("--kind", default="exact", choices=list(CP.KINDS))
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    from a_nice_rag_tpu_torch.bench import card_line
    from a_nice_rag_tpu_torch.ops.kernels import build_kernels
    from a_nice_rag_tpu_torch.testing.timing import cuda_event_ms

    args = _args(sys.argv[1:] if argv is None else argv)
    n = args.n if args.n is not None else SHAPES[args.rows][0]
    device = require_cuda()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    rows, q, k, scales, q_scales = make_rows(args.rows, n, device)
    time_ms = lambda fn, m: cuda_event_ms(fn, n=m)  # noqa: E731
    if args.design == "cluster":
        check_cluster(rows, q, k, args.kind, scales, q_scales)
        line = run_cluster(rows, q, k, time_ms, args.kind, scales, q_scales)
    else:
        check(rows, q, k, scales, q_scales)
        line = run(rows, q, k, time_ms, scales, q_scales)
    print(json.dumps({**line, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
