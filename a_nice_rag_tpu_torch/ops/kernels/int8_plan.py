"""The work plan of the int8 kernels K2 and K4 (``csrc/int8_mma.cuh``).

One place decides, for both the CUDA wrappers and the plain versions that
reproduce a kernel's per-CTA outputs (the probes' counters and staged
words):

- the query block: 16 queries for B <= 16 (two n8 MMA tiles), else 64,
  as long as a CTA's shared memory holds it (``query_block``);
- the shared memory of a CTA (``smem_bytes``, the same sum as
  ``smem_bytes_int8`` in the source) and the CTAs an SM holds;
- K2's doc splits (``fused_plan``) and K4's walkers and work items
  (``ivf_plan``, ``ivf_items``).

On the CPU the SM count is an H100's (132), so a plan made there is the
card's. The plan changes only how the work is spread: the kernels' top-k
values and ids do not depend on it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

TN = 128  # documents per tile
CHUNK = 128  # bytes of depth per staged chunk
STAGES = 3  # chunks in a CTA's ring
SMALL_BQ, LARGE_BQ = 16, 64
# H100: 228 KiB of shared memory per SM, 1 KiB of it reserved per CTA, at
# most 227 KiB for one CTA. The probe modes add 16 bytes a query.
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
SMEM_PER_CTA = 232_448
# The kernels' __launch_bounds__ minimum of CTAs per SM.
MAX_CTAS = {SMALL_BQ: 3, LARGE_BQ: 2}


class FusedPlan(NamedTuple):
    bq: int  # queries per CTA
    splits: int  # doc splits
    per: int  # documents per split


class IvfPlan(NamedTuple):
    bq: int
    walkers: int  # CTAs per query block
    spt: int  # sub-tiles of TN rows per table tile


def depth_pad(d: int) -> int:
    return -(-d // CHUNK) * CHUNK


def smem_bytes(bq: int, d: int, k: int) -> int:
    """Dynamic shared memory of one CTA: the ring, the query block, the
    scores tile, the running lists and their worst entries, keep."""
    return (STAGES * TN * CHUNK + bq * depth_pad(d) + 4 * bq * (TN + 1)
            + 8 * bq * k + 12 * bq + TN)


def query_block(b: int, d: int, k: int) -> int:
    """16 for B <= 16, else 64; 16 too where 64 rows of depth d do not fit
    in a CTA's shared memory. Raises where neither fits."""
    for bq in ((LARGE_BQ, SMALL_BQ) if b > SMALL_BQ else (SMALL_BQ,)):
        if smem_bytes(bq, d, k) + 16 * bq <= SMEM_PER_CTA:
            return bq
    raise ValueError(
        f"D={d} is too deep for the int8 kernels: a CTA holds its query "
        f"block in shared memory ({smem_bytes(SMALL_BQ, d, k)} bytes "
        f"needed at 16 queries, {SMEM_PER_CTA} available)")


def ctas_per_sm(bq: int, d: int, k: int) -> int:
    per_cta = smem_bytes(bq, d, k) + 16 * bq + SMEM_RESERVED
    return max(1, min(MAX_CTAS[bq], SMEM_PER_SM // per_cta))


def fused_plan(n: int, b: int, d: int, k: int, sms: int) -> FusedPlan:
    """K2: doc splits x query blocks, enough to give every SM the CTAs
    it holds; each split a whole number of tiles."""
    bq = query_block(b, d, k)
    q_blocks = -(-b // bq)
    tiles = -(-n // TN)
    splits = min(max(1, -(-ctas_per_sm(bq, d, k) * sms // q_blocks)), tiles)
    per = -(-tiles // splits) * TN
    return FusedPlan(bq, -(-n // per), per)


def ivf_plan(max_tiles: int, tile_n: int, b: int, d: int, k: int,
             sms: int) -> IvfPlan:
    """K4: a walker per CTA the SMs hold and query block, at most one
    per item."""
    bq = query_block(b, d, k)
    q_blocks = -(-b // bq)
    spt = -(-tile_n // TN)
    walkers = min(max(1, ctas_per_sm(bq, d, k) * sms // q_blocks),
                  max_tiles * spt)
    return IvfPlan(bq, walkers, spt)

def ivf_items(table: Sequence[int], max_tiles: int, tile_n: int, rows: int,
              walkers: int, spt: int) -> List[List[Tuple[int, int]]]:
    """K4's walk, as each walker takes it: walker w scores items w, w +
    walkers, ... (item i: sub-tile i % spt of table slot i // spt) until
    the slots run out or reach a -1; item rows [r0, r1), clipped to the
    tile and to ``rows`` (r1 == r0 for a sub-tile past the real rows)."""
    out = []
    for w in range(walkers):
        items = []
        item = w
        while item // spt < max_tiles and table[item // spt] >= 0:
            base = table[item // spt] * tile_n
            r0 = base + (item % spt) * TN
            r1 = min(base + tile_n, r0 + TN, rows)
            items.append((r0, max(r0, r1)))
            item += walkers
        out.append(items)
    return out
