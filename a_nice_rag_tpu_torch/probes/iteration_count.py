"""How often does the fused top-k kernel's running list take a document?

    python -m a_nice_rag_tpu_torch.probes.iteration_count [bf16|int8] [N]
        [--design split|cluster] [--kind exact|rounded|compare]

Counterpart of ``scripts/probe_iteration_count.py``, which counted the
TPU fold's extraction iterations to decide whether a warm start of the
running threshold could remove a material share of them. Here K1/K2 run
with counters (``fused_top_k_counted``): per row and doc split,
insertions in the split's first 16 tiles and after them, and 32-column
windows whose ballot fired, against windows seen. Each split starts its
list cold, so a split of n documents takes about k (1 + ln(n / k))
insertions on random scores; the run with ``tau`` (each row's k-th best
over every 64th document, lowered by ``TAU_SLACK``, seeding every slot)
says how many of them a warm start removes. Both runs' ids and values
must equal K1/K2's, and every output the plain version's: exactly for
int8 rows; for float rows, whose kernel scores (bf16 tensor-core MMA, or
FFMA) and the plain version's f32 matmul differ by a few ulps, the
values and ids up to ties within ``FLOAT_RTOL`` of the largest |value|
(``check_top_k``), and the counters up to ``COUNT_SLACK`` of their
total (a near-tie of two scores can flip one insertion).

``--design cluster`` counts the cluster kernel's fold instead
(``fused_top_k_counted(..., design="cluster", kind=...)``): per row and
walker, the docs that enter (beat the walker's list as their tile began)
in its first 16 tiles and after, the tiles with an entry, the tiles seen,
and the heap's own insertions, under three seeds: none, the subsample's
tau, and its top k as the kernel's ``seed_lists`` takes them (K1r's main
pass gets them so; K2r seeds with tau). Each run's lists must equal the
kind's whole call on the cluster kernel, its counters the plain
version's (exactly on int8 rows and integer grids; float rows as above),
and its insertions lie between the plain version's survivors and its
entries.

Default: the TPU probe's shape, 4,005,888 x 256 bf16 rows (randn), B =
256, k = 32; ``int8``: 10,485,760 x 1024, B = 256, k = 25 (the rows of
``kernel_anatomy.make_rows``). One JSON line per run, with the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, List, Optional

import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops.kernels import anatomy as A
from a_nice_rag_tpu_torch.ops.kernels import cluster_probe as CP
from a_nice_rag_tpu_torch.ops.kernels import (
    fused_dense_top_k,
    fused_dense_top_k_int8,
)
from a_nice_rag_tpu_torch.testing.parity import check_top_k

TimeFn = Callable[[Callable[[], object], int], float]
N_LOOP = 5  # timed calls per run, after one warm-up
# Float rows against the plain version: values within FLOAT_RTOL of the
# largest |value| (the port's bf16 tolerance, 1e-4 on unit-norm rows),
# counters within COUNT_SLACK of their total.
FLOAT_RTOL = 1e-4
COUNT_SLACK = 1e-4


def _check_plain(out, plain, exact: bool, tau: bool) -> int:
    """Raise unless the counted fold's (values, ids, counts) match the
    plain version's (exactly, or for float rows up to near-ties); returns
    the counters' total absolute difference."""
    what = f"counted fold (tau={tau}) differs from its plain version"
    if exact:
        if not all(torch.equal(a, b) for a, b in zip(out, plain)):
            raise AssertionError(what)
        return 0
    finite = plain[0][torch.isfinite(plain[0])]
    scale = max(1.0, float(finite.abs().max())) if finite.numel() else 1.0
    check_top_k(plain[0], plain[1], out[0], out[1], FLOAT_RTOL * scale)
    diff = int((out[2].long() - plain[2].long()).abs().sum())
    if diff > COUNT_SLACK * max(1, int(plain[2].long().sum())):
        raise AssertionError(f"{what}: counters off by {diff}")
    return diff


def _line(counts: torch.Tensor, ms: float, tau: bool, k: int) -> dict:
    """Counts [B, splits, 4] summed over the splits, averaged over rows."""
    per_row = counts.to(torch.float64).sum(dim=1).mean(dim=0).tolist()
    early, late, fired, seen = per_row
    b, splits, _ = counts.shape
    return {
        "tau": tau, "ms": ms, "splits": splits, "k": k, "b": b,
        "insertions_per_row": early + late,
        "insertions_early_per_row": early, "insertions_late_per_row": late,
        "insertions_per_row_split": (early + late) / splits,
        "fired_windows_per_row": fired, "windows_per_row": seen,
        "fired_share": fired / seen,
    }


def run(rows: torch.Tensor, queries: torch.Tensor, k: int, time_ms: TimeFn,
        scales: Optional[torch.Tensor] = None,
        q_scales: Optional[torch.Tensor] = None) -> List[dict]:
    """Two lines, without and with tau: counts, fired share and device ms
    of the counted kernel. Raises unless each run's ids and values equal
    K1/K2's (int8 rows when ``scales`` is given) and its values, ids and
    every counter the plain version's (seconds a run at the default
    shapes)."""
    if scales is None:
        ref = fused_dense_top_k(rows, queries, k)
        tau = A.subsample_tau(rows, queries, k)

        def counted(t):
            return A.fused_top_k_counted(rows, queries, k, t)

        def counted_plain(t):
            return A.fused_top_k_counted_torch(rows, queries, k, t)
    else:
        ref = fused_dense_top_k_int8(rows, scales, queries, q_scales, k)
        tau = A.subsample_tau_int8(rows, scales, queries, k)

        def counted(t):
            return A.fused_top_k_counted_int8(rows, scales, queries,
                                              q_scales, k, t)

        def counted_plain(t):
            return A.fused_top_k_counted_int8_torch(rows, scales, queries,
                                                    q_scales, k, t)
    lines = []
    for t in (None, tau):
        out = counted(t)
        vals, ids, counts = out
        if not (torch.equal(ids, ref[1]) and torch.equal(vals, ref[0])):
            raise AssertionError(f"counted fold (tau={t is not None}) "
                                 f"differs from the kernel it counts")
        off = _check_plain(out, counted_plain(t), scales is not None,
                           t is not None)
        ms = time_ms(lambda tt=t: counted(tt), N_LOOP)
        lines.append({**_line(counts, ms, t is not None, k),
                      "counters_off_plain": off})
    return lines


SEEDS = ("none", "tau", "lists")


def check_cluster_plain(got, want, exact: bool, tol: float = 0.0) -> int:
    """Raise unless a cluster counted run matches its plain version:
    exactly (``anatomy.check_counted``), or for float rows the lists
    through check_top_k at ``tol``, the counters within COUNT_SLACK of
    their total and the heap's insertions within that of its bounds;
    returns the counters' total absolute difference."""
    if exact:
        A.check_counted(got, want)
        return 0
    check_top_k(want[0], want[1], got[0], got[1], tol)
    diff = int((got[2].long() - want[2].long()).abs().sum())
    slack = COUNT_SLACK * max(1, int(want[2].long().sum()))
    entries = got[2][..., 0] + got[2][..., 1]
    low = int((want[3] - got[3]).clamp(min=0).sum())
    if diff > slack or low > slack or bool((got[3] > entries).any()):
        raise AssertionError(f"cluster counted fold: counters off by {diff}"
                             f", insertions under survivors by {low}")
    return diff


def run_cluster(rows: torch.Tensor, queries: torch.Tensor, k: int,
                time_ms: Optional[TimeFn], kind: str = "exact",
                scales: Optional[torch.Tensor] = None,
                q_scales: Optional[torch.Tensor] = None,
                exact: Optional[bool] = None) -> List[dict]:
    """One line per seed (none, tau, lists) of the cluster kernel's counted
    fold over ``kind``: counts per row (summed over walkers), the share of
    tiles with an entry, the heap's insertions beside the plain version's
    survivors, device ms (``time_ms`` None: not timed). Raises unless each
    run's lists equal the kind's whole call and its outputs the plain
    version's (``exact``: int8 rows and integer grids; the default for
    int8 rows only)."""
    from a_nice_rag_tpu_torch.probes.kernel_anatomy import CLUSTER_TOL

    exact = scales is not None if exact is None else exact
    b = queries.shape[0]
    src = CP.source_kind(scales is not None, kind)
    tau, lists = CP.subsample_seeds(rows, queries, k, src, scales)
    active = A.cluster_active_clusters(rows, b, k, kind, "counted")
    if scales is None:
        ref = A.anatomy_top_k_cluster(rows, queries, k, "full", kind=kind)

        def counted(**seed):
            return A.fused_top_k_counted_cluster(rows, queries, k, kind=kind,
                                                 **seed)

        def counted_plain(**seed):
            return A.fused_top_k_counted_cluster_torch(
                rows, queries, k, kind=kind, active=active, **seed)
    else:
        args = (rows, scales, queries, q_scales, k)
        ref = A.anatomy_top_k_int8_cluster(*args, "full", kind=kind)

        def counted(**seed):
            return A.fused_top_k_counted_int8_cluster(*args, kind=kind,
                                                      **seed)

        def counted_plain(**seed):
            return A.fused_top_k_counted_int8_cluster_torch(
                *args, kind=kind, active=active, **seed)
    finite = ref[0][torch.isfinite(ref[0])]
    big = max(1.0, float(finite.abs().max())) if finite.numel() else 1.0
    tol = CLUSTER_TOL[kind] * big
    lines = []
    for name, seed in zip(SEEDS, ({}, {"tau": tau}, {"lists": lists})):
        out = counted(**seed)
        if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
            raise AssertionError(f"cluster counted fold ({kind}, seed "
                                 f"{name}) differs from the whole call")
        want = counted_plain(**seed)
        off = check_cluster_plain(out, want, exact, tol)
        ms = None if time_ms is None else time_ms(
            lambda sd=seed: counted(**sd), N_LOOP)
        per_row = out[2].to(torch.float64).sum(dim=1).mean(dim=0).tolist()
        early, late, tiles, seen = per_row
        lines.append({
            "design": "cluster", "kind": kind, "seed": name, "ms": ms,
            "walkers": out[2].shape[1], "k": k, "b": b,
            "entries_per_row": early + late,
            "entries_early_per_row": early, "entries_late_per_row": late,
            "tiles_entered_per_row": tiles, "tiles_per_row": seen,
            "tiles_entered_share": tiles / seen if seen else 0.0,
            "insertions_per_row": float(out[3].double().sum(1).mean()),
            "survivors_per_row": float(want[3].double().sum(1).mean()),
            "counters_off_plain": off,
        })
    return lines


def _args(argv):
    from a_nice_rag_tpu_torch.probes.kernel_anatomy import SHAPES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="?", default="bf16", choices=list(SHAPES))
    ap.add_argument("n", nargs="?", type=int, default=None)
    ap.add_argument("--design", default="split", choices=list(A.DESIGNS))
    ap.add_argument("--kind", default="exact", choices=list(CP.KINDS))
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    from a_nice_rag_tpu_torch.bench import card_line
    from a_nice_rag_tpu_torch.ops.kernels import build_kernels
    from a_nice_rag_tpu_torch.probes.kernel_anatomy import SHAPES, make_rows
    from a_nice_rag_tpu_torch.testing.timing import cuda_event_ms

    args = _args(sys.argv[1:] if argv is None else argv)
    n = args.n if args.n is not None else SHAPES[args.rows][0]
    device = require_cuda()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    rows, q, k, scales, q_scales = make_rows(args.rows, n, device)
    time_ms = lambda fn, m: cuda_event_ms(fn, n=m)  # noqa: E731
    lines = (run_cluster(rows, q, k, time_ms, args.kind, scales, q_scales)
             if args.design == "cluster" else
             run(rows, q, k, time_ms, scales, q_scales))
    for line in lines:
        print(json.dumps({**line, "rows": args.rows, "n": n, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
