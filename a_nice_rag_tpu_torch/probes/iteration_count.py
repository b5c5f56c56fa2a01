"""How often does the fused top-k kernel's running list take a document?

    python -m a_nice_rag_tpu_torch.probes.iteration_count [bf16|int8] [N]

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
must equal K1/K2's, and every output the plain version's.

Default: the TPU probe's shape, 4,005,888 x 256 bf16 rows (randn), B =
256, k = 32; ``int8``: 10,485,760 x 1024, B = 256, k = 25 (the rows of
``kernel_anatomy.make_rows``). One JSON line per run, with the card.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, List, Optional

import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops.kernels import anatomy as A
from a_nice_rag_tpu_torch.ops.kernels import (
    fused_dense_top_k,
    fused_dense_top_k_int8,
)

TimeFn = Callable[[Callable[[], object], int], float]
N_LOOP = 5  # timed calls per run, after one warm-up


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
        if not all(torch.equal(a, b) for a, b in zip(out, counted_plain(t))):
            raise AssertionError(f"counted fold (tau={t is not None}) "
                                 f"differs from its plain version")
        ms = time_ms(lambda tt=t: counted(tt), N_LOOP)
        lines.append(_line(counts, ms, t is not None, k))
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    from a_nice_rag_tpu_torch.bench import card_line
    from a_nice_rag_tpu_torch.ops.kernels import build_kernels
    from a_nice_rag_tpu_torch.probes.kernel_anatomy import SHAPES, make_rows
    from a_nice_rag_tpu_torch.testing.timing import cuda_event_ms

    argv = sys.argv[1:] if argv is None else argv
    kind = argv[0] if argv else "bf16"
    n = int(argv[1]) if len(argv) > 1 else SHAPES[kind][0]
    device = require_cuda()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    rows, q, k, scales, q_scales = make_rows(kind, n, device)
    for line in run(rows, q, k, lambda fn, m: cuda_event_ms(fn, n=m),
                    scales, q_scales):
        print(json.dumps({**line, "rows": kind, "n": n, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
