"""Does a plain streaming kernel hide independent ALU work under its loads?

    python -m a_nice_rag_tpu_torch.probes.dma_overlap [N_LOG2=22] [TILE_ROWS=16]

Counterpart of ``scripts/probe_dma_overlap.py`` (which asked whether the
TPU's grid pipeline overlaps a tile's copy with compute). Here
``stream_sum_busy`` streams an [N, 256] bf16 matrix in tiles of
``TILE_ROWS`` rows, tile t on CTA t mod grid, and every thread of a CTA
steps one float32 chain X times per tile it visits, on registers that
never touch the tile. The chain is carried from tile to tile, so the
compiler cannot hoist it out of the loop: the slope of ms against X
shows it ran. For X in {0, 1, 2, 4, 8, 16, 32, 64}:

  flat, then rising  the loads hide the chain until it outlasts them;
  rising from X = 0  the chain adds to the stream.

Each line: device ms per call (``device_loop_ms``), the added ms against
X = 0, that increase per chain step per CTA (ns; the chain's latency if
nothing hides it), and the stream's GB/s. The chain values are held bit
for bit, and the sum within 1e-5 of sum |x|, against the plain version.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, List, Optional, Sequence

import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops.kernels import stream_sum_busy
from a_nice_rag_tpu_torch.ops.kernels.stream import BUSY_TILE_ROWS
from a_nice_rag_tpu_torch.testing.parity import check_stream_sum_busy

TimeFn = Callable[[Callable[[], object], int], float]
XS = (0, 1, 2, 4, 8, 16, 32, 64)


def run(emb: torch.Tensor, time_ms: TimeFn, grid: int,
        xs: Sequence[int] = XS, tile_rows: int = BUSY_TILE_ROWS,
        n_loop: int = 20) -> List[dict]:
    seed = torch.zeros((), dtype=torch.float32, device=emb.device)
    n_tiles = -(-emb.shape[0] // tile_rows)
    tiles_per_cta = -(-n_tiles // grid)
    nbytes = emb.numel() * emb.element_size()
    lines: List[dict] = []
    ms0 = None
    for x in xs:
        check_stream_sum_busy(emb, seed, x, grid, tile_rows)
        ms = time_ms(lambda xx=x: stream_sum_busy(emb, seed, xx, grid,
                                                  tile_rows), n_loop)
        ms0 = ms if ms0 is None else ms0
        lines.append({
            "x_iters": x, "ms": ms, "added_ms": ms - ms0,
            "ns_per_step_per_cta": ((ms - ms0) * 1e6 / (tiles_per_cta * x)
                                    if x else 0.0),
            "stream_gb_s": nbytes / 1e9 / ms * 1e3,
            "tiles": n_tiles, "tile_rows": tile_rows, "grid": grid,
        })
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    from a_nice_rag_tpu_torch.bench import card_line
    from a_nice_rag_tpu_torch.ops.kernels import build_kernels
    from a_nice_rag_tpu_torch.ops.kernels.stream import sm_grid
    from a_nice_rag_tpu_torch.testing.timing import device_loop_ms

    argv = sys.argv[1:] if argv is None else argv
    n_log2 = int(argv[0]) if len(argv) > 0 else 22
    tile_rows = int(argv[1]) if len(argv) > 1 else BUSY_TILE_ROWS
    device = require_cuda()
    build_kernels()
    card = card_line()
    print(card, flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    emb = torch.randn((1 << n_log2, 256), generator=g,
                      device=device).to(torch.bfloat16)
    for row in run(emb, lambda fn, n: device_loop_ms(fn, n_loop=n),
                   sm_grid(device), tile_rows=tile_rows):
        print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
