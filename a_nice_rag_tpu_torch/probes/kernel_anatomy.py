"""Where does the fused top-k kernel's time go? An ablation of K1/K2.

    python -m a_nice_rag_tpu_torch.probes.kernel_anatomy [bf16|int8] [N]

Counterpart of ``scripts/profile_kernel_anatomy.py`` (which attributed
the TPU kernel's time the same way, docs/BENCHMARKS.md:234-252). Four
calls share K1/K2's grid, block and shared-memory layout and differ only
in the work per tile (``ops.kernels.anatomy``):

  stage    the staging loops (the tile's bytes into shared memory);
  score    + scoring;
  compare  + the fold's ballot against a threshold of +inf (no insertion);
  full     K1/K2 as they are: + insertions and the merge.

The three deltas attribute the kernel to loads, scoring, the compare pass
and the insertions. Default: the TPU probe's shape, 4,005,888 x 256 bf16
rows (randn), B = 256 bf16 queries, k = 32; ``int8``: 10,485,760 x 1024
int8 rows, B = 256, k = 25. Each mode is first held against its plain
version on the whole matrix. One JSON line, with the card.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, Dict, List, Optional

import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops.kernels import anatomy as A

TimeFn = Callable[[Callable[[], object], int], float]
# kind -> (N, D, B, k)
SHAPES = {"bf16": (4_005_888, 256, 256, 32),
          "int8": (10_485_760, 1024, 256, 25)}
N_LOOP = 5  # timed calls per mode, after one warm-up
# One H100 SXM (NVIDIA data sheet): HBM bytes/s.
HBM_BYTES_S = 3.35e12


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
    ``scales`` is given)."""
    b = queries.shape[0]
    inf = torch.full((b,), float("inf"), device=emb.device)
    calls = _calls(emb, queries, k, scales, q_scales, inf)
    ms = {mode: time_ms(kernel, N_LOOP)
          for mode, (kernel, _) in calls.items()}
    n, d = emb.shape
    nbytes = emb.numel() * emb.element_size()
    return {
        "rows": "int8" if scales is not None else str(emb.dtype)[6:],
        "n": n, "d": d, "b": b, "k": k, "ms": ms,
        "loads_ms": ms["stage"],
        "scoring_ms": ms["score"] - ms["stage"],
        "compare_ms": ms["compare"] - ms["score"],
        "insert_merge_ms": ms["full"] - ms["compare"],
        "splits": A.split_plan(n, b, emb.device)[0],
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


def main(argv: Optional[List[str]] = None) -> int:
    from a_nice_rag_tpu_torch.bench import card_line
    from a_nice_rag_tpu_torch.ops.kernels import build_kernels
    from a_nice_rag_tpu_torch.testing.timing import cuda_event_ms

    argv = sys.argv[1:] if argv is None else argv
    kind = argv[0] if argv else "bf16"
    n = int(argv[1]) if len(argv) > 1 else SHAPES[kind][0]
    device = require_cuda()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    rows, q, k, scales, q_scales = make_rows(kind, n, device)
    check(rows, q, k, scales, q_scales)
    line = run(rows, q, k, lambda fn, m: cuda_event_ms(fn, n=m), scales,
               q_scales)
    print(json.dumps({**line, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
