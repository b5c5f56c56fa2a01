"""Row reductions over bf16-rounded scores, and the packed (value, column)
key that gives both from one integer max.

    python -m a_nice_rag_tpu_torch.probes.bf16_fold

Counterpart of ``scripts/probe_bf16_fold.py``, which checked that these
building blocks of a bf16 or packed selection lowered on the TPU and
timed them. ``bf16_row_reduce`` computes all four per row (the max, its
lowest column, the max after masking it, the column of the packed key's
max); here they are held against their plain versions bit for bit, and
the packed argmax against ``torch.argmax`` on the bf16-rounded scores (as
at :112-132: agreement of the columns, and of the values at them), at
[128, 8192] (the probe's shape) and [256, 16384]. One JSON line per
shape, with the device ms of the kernel and of its plain version.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops.kernels import (
    bf16_row_reduce,
    bf16_row_reduce_torch,
)

TimeFn = Callable[[Callable[[], object], int], float]
SHAPES = ((128, 8192), (256, 16384))
N_LOOP = 20  # back-to-back calls per timing


def check(x: torch.Tensor) -> None:
    """The kernel's four outputs equal the plain version's."""
    for name, got, want in zip(("max", "arg", "second", "packed_arg"),
                               bf16_row_reduce(x), bf16_row_reduce_torch(x)):
        if not torch.equal(got, want):
            raise AssertionError(f"bf16_row_reduce {name} differs from its "
                                 f"plain version at {tuple(x.shape)}")


def run(device: torch.device, time_ms: TimeFn,
        shapes: Sequence[Tuple[int, int]] = SHAPES) -> List[dict]:
    g = torch.Generator(device=device).manual_seed(1)
    lines = []
    for rows, width in shapes:
        x = torch.randn((rows, width), generator=g, device=device)
        check(x)
        _, _, _, packed_arg = bf16_row_reduce(x)
        xb = x.to(torch.bfloat16)
        ref = torch.argmax(xb.float(), dim=1)
        picked = packed_arg.long()
        lines.append({
            "shape": [rows, width],
            "ms": time_ms(lambda: bf16_row_reduce(x), N_LOOP),
            "plain_ms": time_ms(lambda: bf16_row_reduce_torch(x), N_LOOP),
            "packed_argmax_agreement": float((picked == ref).float().mean()),
            "packed_value_agreement": float(
                (xb.gather(1, picked[:, None])
                 == xb.gather(1, ref[:, None])).float().mean()),
            "outputs_equal_plain": True,
        })
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    from a_nice_rag_tpu_torch.bench import card_line
    from a_nice_rag_tpu_torch.ops.kernels import build_kernels
    from a_nice_rag_tpu_torch.testing.timing import device_loop_ms

    device = require_cuda()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    for line in run(device, lambda fn, n: device_loop_ms(fn, n_loop=n)):
        print(json.dumps({**line, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
