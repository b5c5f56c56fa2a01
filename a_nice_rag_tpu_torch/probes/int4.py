"""Does int4 packing (half the bytes of int8) speed up streaming scoring?

    python -m a_nice_rag_tpu_torch.probes.int4 [N]

Counterpart of ``scripts/probe_int4.py``:

- exactness (its stages 1 and 3): ``int4_scores`` with both unpacks, at
  N = 1024, D = 256, B = 128, equal to the exact product (in float64) of
  the unpacked values and to the plain version; ``int4_fold_max`` and
  ``int8_fold_max`` equal to their plain versions there too;
- the kernels' edges (``check_edges``): every kernel ``torch.equal`` to
  its plain version over depths, batches, ragged row counts, extreme
  values, all-negative products and rows at addresses that are not
  16-byte aligned;
- the anatomy (``run_anatomy``): each fold's stream alone beside the
  whole fold;
- throughput (its stage 2): ``int8_fold_max`` over an [N, 1024] int8
  matrix and ``int4_fold_max`` over an [N, 512] packed one (default N =
  10,485,760: 10.7 GB and 5.4 GB, both resident at once on an 80 GB card,
  where the TPU had to free one before making the other), B = 256. Each
  line: device ms, GB/s of the bytes streamed, and int4's speedup.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, List, Optional

import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops.kernels import int4 as I

TimeFn = Callable[[Callable[[], object], int], float]
N_STAGE2, D_STAGE2, B_STAGE2 = 10_485_760, 1024, 256
N_LOOP = 5  # timed calls per fold, after one warm-up
# The edges: depths (element loads at 8, 40, 1000; TMA at 1024, 2048),
# batches across the 64-query block and the cluster of 1-4 blocks, row
# counts below one 256-row tile and ragged past many.
EDGE_D = (8, 40, 1000, 1024, 2048)
EDGE_B = (1, 8, 16, 17, 64, 65, 129, 256)
EDGE_N = (100, 70_001)
EDGE_VIEWS = ("rows", "rows[1:]", "4 bytes past 16")


def small_case(device: torch.device):
    """(q8, e4, packed) of stages 1 and 3 (N 1024, D 256, B 128): int4
    values in [-8, 7], int8 queries in [-128, 127]."""
    g = torch.Generator(device=device).manual_seed(0)
    e4 = torch.randint(-8, 8, (1024, 256), generator=g, device=device,
                       dtype=torch.int8)
    q8 = torch.randint(-128, 128, (128, 256), generator=g, device=device,
                       dtype=torch.int8)
    return q8, e4, I.pack_int4(e4)


def check_exact(device: torch.device) -> dict:
    """Stages 1 and 3: every kernel equal to its plain version and to the
    exact product, at the TPU probe's small shape."""
    q8, e4, packed = small_case(device)
    # float64 holds every partial sum exactly (|sum| < 2^19).
    want = (q8.double() @ e4.double().T).to(torch.int32)
    if not torch.equal(I.unpack_int4(packed), e4):
        raise AssertionError("unpack_int4(pack_int4(e4)) != e4")
    for unpack in I.UNPACKS:
        got = I.int4_scores(q8, packed, unpack)
        if not (torch.equal(got, want)
                and torch.equal(got, I.int4_scores_torch(q8, packed))):
            raise AssertionError(f"int4_scores ({unpack}) is not exact")
        if not torch.equal(I.int4_fold_max(q8, packed, unpack),
                           want.amax(dim=1)):
            raise AssertionError(f"int4_fold_max ({unpack}) is not exact")
    e8 = torch.randint(-127, 128, e4.shape, device=device, dtype=torch.int8,
                       generator=torch.Generator(device=device).manual_seed(1))
    if not torch.equal(I.int8_fold_max(q8, e8), I.int8_fold_max_torch(q8, e8)):
        raise AssertionError("int8_fold_max is not exact")
    return {"stage": "exact", "shape": list(e4.shape) + [q8.shape[0]],
            "unpacks": list(I.UNPACKS), "exact": True}


def edge_data(device: torch.device, n: int, d: int, b: int,
              negative: bool, seed: int):
    """(q8 [b, d], e8 [n, d], packed [n, d / 2]). ``negative``: queries in
    [1, 127] against rows in [-128, -1] (nibbles in [-8, -1]), so every
    product is negative and a zero-filled row past N would win the max;
    else the full ranges with rows and queries at -128 / 127 (nibbles at
    -8 / 7)."""
    g = torch.Generator(device=device).manual_seed(seed)
    i8 = dict(generator=g, device=device, dtype=torch.int8)
    if negative:
        return (torch.randint(1, 128, (b, d), **i8),
                torch.randint(-128, 0, (n, d), **i8),
                I.pack_int4(torch.randint(-8, 0, (n, d), **i8)))
    q8 = torch.randint(-128, 128, (b, d), **i8)
    e8 = torch.randint(-128, 128, (n, d), **i8)
    e4 = torch.randint(-8, 8, (n, d), **i8)
    q8[b // 2] = 127
    q8[-1] = -128
    e8[n // 3], e8[-1] = 127, -128
    e4[n // 3], e4[-1] = 7, -8
    return q8, e8, I.pack_int4(e4)


def _view(t: torch.Tensor, view: str) -> torch.Tensor:
    """t[:-1] as stored, t[1:], or a copy of t[:-1] whose base is 4 bytes
    past a 16-byte boundary."""
    if view == "rows[1:]":
        return t[1:]
    if view == "rows":
        return t[:-1]
    buf = torch.empty(t[:-1].numel() + 32, dtype=t.dtype, device=t.device)
    start = -buf.data_ptr() % 16 + 4
    out = buf[start:start + t[:-1].numel()].view(t[:-1].shape)
    out.copy_(t[:-1])
    return out


def _equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{what} differs from its plain version")


def check_edges(device: torch.device, ns=EDGE_N, ds=EDGE_D,
                bs=EDGE_B) -> dict:
    """Every (D, B) pair, N cycling through ``ns`` and every other pair
    all-negative, each in EDGE_VIEWS: int8_fold_max, and int4_fold_max and
    int4_scores with both unpacks, each torch.equal to its plain
    version."""
    cases = 0
    for i, d in enumerate(ds):
        for j, b in enumerate(bs):
            n = ns[(i + j) % len(ns)]
            negative = (i + j) % 2 == 1
            q8, e8, packed = edge_data(device, n + 1, d, b, negative,
                                       1000 * i + j)
            for view in EDGE_VIEWS:
                what = f"(N {n}, D {d}, B {b}, {view})"
                r8, rp = _view(e8, view), _view(packed, view)
                _equal(I.int8_fold_max(q8, r8), I.int8_fold_max_torch(q8, r8),
                       "int8_fold_max " + what)
                for unpack in I.UNPACKS:
                    _equal(I.int4_fold_max(q8, rp, unpack),
                           I.int4_fold_max_torch(q8, rp, unpack),
                           f"int4_fold_max ({unpack}) {what}")
                    _equal(I.int4_scores(q8, rp, unpack),
                           I.int4_scores_torch(q8, rp, unpack),
                           f"int4_scores ({unpack}) {what}")
                cases += 1
    return {"stage": "edges", "cases": cases, "n": list(ns), "d": list(ds),
            "b": list(bs), "views": list(EDGE_VIEWS), "exact": True}


def stage2_inputs(device: torch.device, n: int = N_STAGE2,
                  d: int = D_STAGE2, b: int = B_STAGE2):
    """(q8 [b, d], packed [n, d / 2]) from one seeded generator, as the
    TPU probe drew them (random bytes: every nibble in [-8, 7])."""
    g = torch.Generator(device=device).manual_seed(2)
    q8 = torch.randint(-127, 128, (b, d), generator=g, device=device,
                       dtype=torch.int8)
    packed = torch.randint(-128, 128, (n, d // 2), generator=g,
                           device=device, dtype=torch.int8)
    return q8, packed


def run_stage2(q8: torch.Tensor, e8: torch.Tensor, packed: torch.Tensor,
               time_ms: TimeFn) -> List[dict]:
    """int8 over ``e8`` [N, D] and int4 over ``packed`` [N', D / 2] (the
    "mask" unpack, the one the TPU probe timed): ms, GB/s and int4's
    speedup."""
    t8 = time_ms(lambda: I.int8_fold_max(q8, e8), N_LOOP)
    t4 = time_ms(lambda: I.int4_fold_max(q8, packed), N_LOOP)
    gb8 = e8.numel() / 1e9
    gb4 = packed.numel() / 1e9
    b, d = q8.shape
    return [
        {"stage": "2", "rows": "int8", "shape": list(e8.shape), "b": b,
         "ms": t8, "gb_s": gb8 / t8 * 1e3},
        {"stage": "2", "rows": "int4", "shape": [packed.shape[0], d],
         "b": b, "unpack": "mask", "ms": t4, "gb_s": gb4 / t4 * 1e3,
         "speedup_vs_int8": t8 / t4 * packed.shape[0] / e8.shape[0]},
    ]


def run_anatomy(q8: torch.Tensor, e8: torch.Tensor, packed: torch.Tensor,
                time_ms: TimeFn) -> List[dict]:
    """The folds' time split: the stream alone (``fold_stream``: the same
    launch and ring, no MMA) and the whole fold, int8 over ``e8`` and int4
    over ``packed`` with each unpack. CUDA only."""
    lines = []
    for rows, name, bytes_ in ((e8, "int8", e8.numel()),
                               (packed, "int4", packed.numel())):
        packed_rows = name == "int4"
        stream = time_ms(lambda: I.fold_stream(q8, rows, packed_rows),
                         N_LOOP)
        folds = ({"int8": lambda: I.int8_fold_max(q8, rows)} if not
                 packed_rows else
                 {f"int4 {u}": lambda u=u: I.int4_fold_max(q8, rows, u)
                  for u in I.UNPACKS})
        for label, fn in folds.items():
            ms = time_ms(fn, N_LOOP)
            lines.append({"rows": label, "shape": list(rows.shape),
                          "b": q8.shape[0], "stream_ms": stream,
                          "stream_gb_s": bytes_ / 1e9 / stream * 1e3,
                          "fold_ms": ms, "mma_ms": ms - stream})
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    from a_nice_rag_tpu_torch.bench import card_line
    from a_nice_rag_tpu_torch.ops.kernels import build_kernels
    from a_nice_rag_tpu_torch.testing.timing import cuda_event_ms

    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else N_STAGE2
    device = require_cuda()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    print(json.dumps({**check_exact(device), "card": card}), flush=True)
    print(json.dumps({**check_edges(device), "card": card}), flush=True)
    q8, packed = stage2_inputs(device, n)
    e8 = torch.randint(-127, 128, (n, D_STAGE2), device=device,
                       dtype=torch.int8,
                       generator=torch.Generator(device=device).manual_seed(1))
    time_ms = lambda fn, m: cuda_event_ms(fn, n=m)  # noqa: E731
    for line in (run_stage2(q8, e8, packed, time_ms)
                 + run_anatomy(q8, e8, packed, time_ms)):
        print(json.dumps({**line, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
