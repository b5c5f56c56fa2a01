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
``--kernel-times`` prints instead the kernel alone (``torch.profiler``,
per launch) at both shapes, warm (one input, which stays in the
50 MB L2) and cold (copies filling twice the L2, taken in turn); it
needs only the ``bf16_row_reduce`` wrapper, so it times any version of
the kernel the package holds. ``check_edges`` holds the kernel to its plain
version on the edge cases of its one-pass design (``edge_cases``): R in
{1, 7, 256, 4096}, W from 1 to 65536 (odd widths and storage offsets
leave row bases off the 16-byte grid), ties for the max across a row's
threads and warps, all-equal rows, -inf and values below the mask value, +-0.0 and values
that round to one bf16, one launch per call.
"""

from __future__ import annotations

import itertools
import json
import sys
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops.kernels import (
    bf16_row_reduce,
    bf16_row_reduce_torch,
)

TimeFn = Callable[[Callable[[], object], int], float]
SHAPES = ((128, 8192), (256, 16384))
N_LOOP = 20  # back-to-back calls per timing
L2_BYTES = 50 << 20  # an H100's L2
# Edge cases: (R, W) shapes, value kinds, storage offsets in elements.
EDGE_SHAPES = ((1, 1), (7, 3), (1, 65_536), (7, 1000), (256, 4097),
               (256, 16_384), (4096, 17), (4096, 1000), (3, 65_536))
EDGE_KINDS = ("normal", "ties", "equal", "extreme", "zeros", "near",
              "planted")
EDGE_OFFSETS = (0, 1, 3)
_EXTREMES = (float("-inf"), -3.3e38, -3.1e38, -3e38, -1e38, -1.0, 0.0)


def edge_values(kind: str, rows: int, width: int,
                g: torch.Generator) -> torch.Tensor:
    """[rows, width] float32 of one edge kind, made on the CPU from ``g``."""
    shape = (rows, width)
    if kind == "normal":
        return torch.randn(shape, generator=g)
    if kind == "ties":  # the max at many columns, across a row's warps
        return torch.randint(-3, 4, shape, generator=g).float()
    if kind == "equal":  # every column holds the max
        return torch.randint(-2, 3, (rows, 1), generator=g).float().expand(
            shape).contiguous()
    if kind == "extreme":  # -inf and values at or below the mask value
        pick = torch.randint(0, len(_EXTREMES), shape, generator=g)
        x = torch.tensor(_EXTREMES)[pick]
        x[0::3] = float("-inf")  # rows of -inf only
        x[1::3] = float("-inf")  # and rows whose max is below the mask
        x[1::3, -1] = -3.3e38
        return x
    if kind == "zeros":  # +-0.0 tie under ==
        pick = torch.randint(0, 3, shape, generator=g)
        return torch.tensor((-0.0, 0.0, -1.0))[pick]
    if kind == "near":  # distinct floats that round to one bf16
        return 1.0 + torch.randint(0, 4, shape, generator=g).float() / 1024
    if kind == "planted":  # one max at a few columns spread over the row
        x = torch.randn(shape, generator=g)
        for c in {width - 1, width // 2, width // 3, (2 * width) // 3}:
            x[:, c] = 10.0
        return x
    raise ValueError(f"unknown edge kind {kind!r}")


def edge_cases(device: torch.device, shapes=EDGE_SHAPES, kinds=EDGE_KINDS,
               offsets=EDGE_OFFSETS) -> Iterator[Tuple[str, torch.Tensor]]:
    """(label, x): every shape x kind x storage offset, x a contiguous
    [R, W] view ``offset`` elements into its buffer."""
    g = torch.Generator().manual_seed(6)
    for rows, width in shapes:
        for kind in kinds:
            x = edge_values(kind, rows, width, g)
            for off in offsets:
                buf = torch.empty(off + rows * width, device=device)
                view = buf[off:].view(rows, width)
                view.copy_(x)
                yield f"{kind} [{rows}, {width}] +{off}", view


def check_edges(device: torch.device, shapes=EDGE_SHAPES) -> dict:
    """The kernel equal to its plain version on every edge case, one
    launch per call."""
    n = 0
    for label, x in edge_cases(device, shapes):
        before = bf16_row_reduce.launches
        got = bf16_row_reduce(x)
        if x.is_cuda and bf16_row_reduce.launches != before + 1:
            raise AssertionError(f"bf16_row_reduce: not one launch ({label})")
        for name, a, w in zip(("max", "arg", "second", "packed_arg"), got,
                              bf16_row_reduce_torch(x)):
            if not torch.equal(a, w):
                raise AssertionError(f"bf16_row_reduce {name} differs from "
                                     f"its plain version: {label}")
        n += 1
    return {"cases": n, "shapes": [list(s) for s in shapes],
            "kinds": list(EDGE_KINDS), "offsets": list(EDGE_OFFSETS),
            "one_launch_per_call": True, "outputs_equal_plain": True}


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


def cold_inputs(rows: int, width: int, g: torch.Generator,
                device: torch.device) -> List[torch.Tensor]:
    """Copies of a [rows, width] input that fill twice the L2, so that one
    taken in turn was last read a full L2 ago."""
    copies = -(-2 * L2_BYTES // (rows * width * 4)) + 1
    return [torch.randn((rows, width), generator=g, device=device)
            for _ in range(copies)]


def kernel_times(device: torch.device, kernel_ms: TimeFn,
                 shapes: Sequence[Tuple[int, int]] = SHAPES,
                 n: int = 50) -> List[dict]:
    """The kernel alone per launch, ``kernel_ms(fn, n)``, warm and cold."""
    g = torch.Generator(device=device).manual_seed(2)
    lines = []
    for rows, width in shapes:
        xs = cold_inputs(rows, width, g, device)
        turn = itertools.cycle(xs)
        lines.append({
            "shape": [rows, width], "cold_copies": len(xs),
            "kernel_ms": kernel_ms(lambda: bf16_row_reduce(xs[0]), n),
            "kernel_cold_ms": kernel_ms(
                lambda: bf16_row_reduce(next(turn)), n),
        })
        del xs, turn
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    from a_nice_rag_tpu_torch.bench import card_line
    from a_nice_rag_tpu_torch.ops.kernels import build_kernels
    from a_nice_rag_tpu_torch.testing.timing import device_loop_ms

    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    if "--kernel-times" in argv:
        from a_nice_rag_tpu_torch.testing.timing import profiled_kernel_ms

        lines = kernel_times(device, lambda fn, n: profiled_kernel_ms(
            fn, "row_reduce", n=n))
    else:
        lines = run(device, lambda fn, n: device_loop_ms(fn, n_loop=n))
    for line in lines:
        print(json.dumps({**line, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
