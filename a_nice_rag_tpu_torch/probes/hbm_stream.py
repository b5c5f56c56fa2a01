"""How fast does one pass over device memory go, and does more than one
stream raise the rate?

    python -m a_nice_rag_tpu_torch.probes.hbm_stream [N_LOG2=22] [D=256]

Counterpart of ``scripts/probe_hbm_stream.py`` (the TPU probe of the
same question), on 2^22 x 256 bf16 (2.1 GB) by default. Lines:

  a  the library's sum, ``torch.sum(x, dtype=torch.float32)``;
  p  the plain version, ``stream_sum_torch(x)`` (float64, chunked);
  b  ``stream_sum(x)`` over launch shapes: CTAs per SM x 16-byte loads
     in flight per thread (the TPU probe swept its block rows instead);
  c  two matrices through the library: two ``torch.sum`` calls;
  d  the same two in one kernel: ``stream_sum([x, y])``;
  e  m in {1, 2, 3, 4, 6, 8} parts of the same total bytes;
  f  ``stream_sum(parts, bias=previous)``: each call seeded with the
     last one's result, so calls cannot overlap (the TPU probe threaded
     its loop carry through the bias the same way).

Every line: device ms per call (CUDA events around back-to-back calls,
``device_loop_ms``), GB/s of the bytes read, and the card. Every
``stream_sum`` result is held against its plain version first.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, List, Optional

import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops.kernels import stream_sum, stream_sum_torch
from a_nice_rag_tpu_torch.ops.kernels.stream import UNROLLS
from a_nice_rag_tpu_torch.testing.parity import check_stream_sum

TimeFn = Callable[[Callable[[], object], int], float]
CTAS_PER_SM = (1, 2, 4, 8)
STREAM_COUNTS = (1, 2, 3, 4, 6, 8)


def run(device: torch.device, time_ms: TimeFn, n_rows: int = 1 << 22,
        dim: int = 256, n_loop: int = 20) -> List[dict]:
    g = torch.Generator(device=device).manual_seed(0)

    def matrix(rows):
        return torch.randn((rows, dim), generator=g,
                           device=device).to(torch.bfloat16)

    x, y = matrix(n_rows), matrix(n_rows)
    nbytes = x.numel() * x.element_size()
    lines: List[dict] = []

    def line(tag, what, fn, n_bytes, **extra):
        ms = time_ms(fn, n_loop)
        lines.append({"line": tag, "what": what, "ms": ms,
                      "gb_s": n_bytes / 1e9 / ms * 1e3, "bytes": n_bytes,
                      **extra})

    line("a", "torch.sum(x, dtype=float32)",
         lambda: torch.sum(x, dtype=torch.float32), nbytes)
    line("p", "stream_sum_torch(x)", lambda: stream_sum_torch(x), nbytes)
    for ctas in CTAS_PER_SM:
        for unroll in UNROLLS:
            check_stream_sum(x, ctas_per_sm=ctas, unroll=unroll)
            line("b", "stream_sum(x)", lambda c=ctas, u=unroll: stream_sum(
                x, ctas_per_sm=c, unroll=u), nbytes, ctas_per_sm=ctas,
                unroll=unroll)
    line("c", "torch.sum(x) + torch.sum(y)",
         lambda: torch.sum(x, dtype=torch.float32)
         + torch.sum(y, dtype=torch.float32), 2 * nbytes)
    check_stream_sum([x, y])
    line("d", "stream_sum([x, y])", lambda: stream_sum([x, y]), 2 * nbytes)
    del x, y
    for m in STREAM_COUNTS:
        parts = [matrix(n_rows // m) for _ in range(m)]
        total = sum(p.numel() * p.element_size() for p in parts)
        check_stream_sum(parts)
        line("e", f"stream_sum({m} parts)", lambda p=parts: stream_sum(p),
             total, parts=m)
        state = [torch.zeros((), dtype=torch.float32, device=device)]
        check_stream_sum(parts, state[0])

        def threaded(p=parts):
            state[0] = stream_sum(p, bias=state[0])

        line("f", f"stream_sum({m} parts, bias=previous)", threaded, total,
             parts=m)
        del parts
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    from a_nice_rag_tpu_torch.bench import card_line
    from a_nice_rag_tpu_torch.ops.kernels import build_kernels
    from a_nice_rag_tpu_torch.testing.timing import device_loop_ms

    argv = sys.argv[1:] if argv is None else argv
    n_log2 = int(argv[0]) if len(argv) > 0 else 22
    dim = int(argv[1]) if len(argv) > 1 else 256
    device = require_cuda()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    for row in run(device, lambda fn, n: device_loop_ms(fn, n_loop=n),
                   n_rows=1 << n_log2, dim=dim):
        print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
