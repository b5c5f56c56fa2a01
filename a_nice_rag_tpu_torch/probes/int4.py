"""Does int4 packing (half the bytes of int8) speed up streaming scoring?

    python -m a_nice_rag_tpu_torch.probes.int4 [N]

Counterpart of ``scripts/probe_int4.py``:

- exactness (its stages 1 and 3): ``int4_scores`` with both unpacks, at
  N = 1024, D = 256, B = 128, equal to the exact product (in float64) of
  the unpacked values and to the plain version; ``int4_fold_max`` and
  ``int8_fold_max`` equal to their plain versions there too;
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
    q8, packed = stage2_inputs(device, n)
    e8 = torch.randint(-127, 128, (n, D_STAGE2), device=device,
                       dtype=torch.int8,
                       generator=torch.Generator(device=device).manual_seed(1))
    for line in run_stage2(q8, e8, packed,
                           lambda fn, m: cuda_event_ms(fn, n=m)):
        print(json.dumps({**line, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
