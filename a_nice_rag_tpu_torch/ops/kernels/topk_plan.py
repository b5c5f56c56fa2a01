"""The work plan of the streaming top-k kernels K1-K4 (``csrc/float_mma.cuh``
for f32 and bf16 rows, ``csrc/int8_mma.cuh`` for int8 rows).

One place decides, for both the CUDA wrappers and the plain versions that
reproduce a kernel's per-CTA outputs (the probes' counters and staged
words):

- the query block: 16 queries for B <= 16 (two n8 MMA tiles), else 64, as
  long as a CTA's shared memory holds it (``query_block``); for float rows
  whether the block stays resident in shared memory or streams by depth
  chunk beside the doc chunks (``resident``);
- the shared memory of a CTA (``smem_bytes``, the same sums as
  ``smem_bytes_int8`` and ``smem_bytes_float`` in the sources) and the CTAs
  an SM holds;
- K1/K2's doc splits (``fused_plan``; ``override_plan`` checks a caller's
  query block and splits, the tuner's) and K3/K4's walkers and work items
  (``ivf_plan``, ``ivf_items``);
- the tau pass's: the same kernels over every ``TAU_STRIDE``-th row
  (``tau_fused_plan``, ``tau_ivf_walkers``).

``rows`` names the row type: "int8", "bfloat16" or "float32". bf16 rows
take the query as three bf16 planes, so their query block is three times
as deep in bytes; ``planes`` overrides that count where a kernel takes
another (the bf16 compare fold K1c: ``COMPARE_PLANES``, one bf16 plane).
On the CPU the SM count is an H100's (132), so a plan made there is the
card's. The plan changes only how the work is spread: the kernels' top-k
values and ids do not depend on it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

TN = 128  # documents per tile
CHUNK = 128  # bytes of depth per staged chunk
STAGES = 3  # chunks in a CTA's ring
SMALL_BQ, LARGE_BQ = 16, 64
TAU_STRIDE = 64  # the tau pass scores every 64th candidate row
# H100: 228 KiB of shared memory per SM, 1 KiB of it reserved per CTA, at
# most 227 KiB for one CTA. The probe modes add 16 bytes a query.
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
SMEM_PER_CTA = 232_448
ROWS = ("int8", "bfloat16", "float32")
ELEMENT_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}
QUERY_PLANES = {"int8": 1, "bfloat16": 3, "float32": 1}
COMPARE_PLANES = 1  # K1c: bf16(q), or the f32 query on f32 rows
# The kernels' __launch_bounds__ minimum of CTAs per SM (split_topk.cuh,
# MinCtas): their registers allow no more.
MAX_CTAS = {"int8": {SMALL_BQ: 3, LARGE_BQ: 2},
            "bfloat16": {SMALL_BQ: 3, LARGE_BQ: 1},
            "float32": {SMALL_BQ: 3, LARGE_BQ: 1}}


class FusedPlan(NamedTuple):
    bq: int  # queries per CTA
    splits: int  # doc splits
    per: int  # documents per split


class IvfPlan(NamedTuple):
    bq: int
    walkers: int  # CTAs per query block
    spt: int  # sub-tiles of TN rows per table tile


def _check_rows(rows: str) -> None:
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {ROWS}, got {rows!r}")


def depth_pad(nbytes: int) -> int:
    """Bytes of a row of ``nbytes`` rounded up to whole chunks."""
    return -(-nbytes // CHUNK) * CHUNK


def _tail(bq: int, k: int) -> int:
    """The scores tile, the running lists and their worst entries, keep."""
    return 4 * bq * (TN + 1) + 8 * bq * k + 12 * bq + TN


def smem_bytes(bq: int, d: int, k: int, rows: str = "int8",
               qres: bool = True, planes: Optional[int] = None) -> int:
    """Dynamic shared memory of one CTA: the ring (doc chunks, and the
    query chunks when the block is streamed), the resident query block
    (``planes`` of them, default ``QUERY_PLANES[rows]``), the tail, and
    for float rows a hit flag per query. int8 rows always hold their
    query block."""
    _check_rows(rows)
    planes = QUERY_PLANES[rows] if planes is None else planes
    es = ELEMENT_BYTES[rows]
    stage = TN * CHUNK + (0 if qres else planes * bq * CHUNK)
    qblock = planes * bq * depth_pad(d * es) if qres else 0
    hits = 0 if rows == "int8" else bq
    return STAGES * stage + qblock + _tail(bq, k) + hits


def _fits(bq: int, d: int, k: int, rows: str, qres: bool,
          planes: Optional[int] = None) -> bool:
    return smem_bytes(bq, d, k, rows, qres, planes) + 16 * bq <= SMEM_PER_CTA


def resident(bq: int, d: int, k: int, rows: str = "int8",
             planes: Optional[int] = None) -> bool:
    """Whether the query block stays in shared memory for the CTA's whole
    walk (always for int8 rows; float rows where it fits)."""
    return rows == "int8" or _fits(bq, d, k, rows, True, planes)


def query_block(b: int, d: int, k: int, rows: str = "int8",
                planes: Optional[int] = None) -> int:
    """16 for B <= 16, else 64; 16 too where 64 rows do not fit in a CTA's
    shared memory. Raises where neither fits (int8 rows past a depth of
    about 9,800: their query block is always resident)."""
    _check_rows(rows)
    for bq in ((LARGE_BQ, SMALL_BQ) if b > SMALL_BQ else (SMALL_BQ,)):
        if _fits(bq, d, k, rows, True, planes) or (
                rows != "int8" and _fits(bq, d, k, rows, False, planes)):
            return bq
    raise ValueError(
        f"D={d} is too deep for the {rows} kernels: a CTA holds its query "
        f"block in shared memory "
        f"({smem_bytes(SMALL_BQ, d, k, rows, planes=planes)} bytes "
        f"needed at 16 queries, {SMEM_PER_CTA} available)")


def ctas_per_sm(bq: int, d: int, k: int, rows: str = "int8",
                planes: Optional[int] = None) -> int:
    per_cta = (smem_bytes(bq, d, k, rows, resident(bq, d, k, rows, planes),
                          planes)
               + 16 * bq + SMEM_RESERVED)
    return max(1, min(MAX_CTAS[rows][bq], SMEM_PER_SM // per_cta))


def doc_splits(n: int, b: int, bq: int, ctas: int, sms: int,
               span: int) -> Tuple[int, int]:
    """(splits, rows per split) of ``n`` rows in whole spans of ``span``
    rows, enough to give every SM ``ctas`` CTAs; no split empty."""
    q_blocks = -(-b // bq)
    spans = -(-n // span)
    splits = min(max(1, -(-ctas * sms // q_blocks)), spans)
    per = -(-spans // splits) * span
    return -(-n // per), per


def fused_plan(n: int, b: int, d: int, k: int, sms: int,
               rows: str = "int8",
               planes: Optional[int] = None) -> FusedPlan:
    """K1/K2: doc splits x query blocks, enough to give every SM the CTAs
    it holds; each split a whole number of tiles."""
    bq = query_block(b, d, k, rows, planes)
    return FusedPlan(bq, *doc_splits(
        n, b, bq, ctas_per_sm(bq, d, k, rows, planes), sms, TN))


def override_plan(n: int, b: int, d: int, k: int, sms: int, rows: str,
                  bq: Optional[int] = None,
                  splits: Optional[int] = None,
                  planes: Optional[int] = None) -> FusedPlan:
    """K1's plan with a caller's query block and doc splits (the tuner's
    candidates; None keeps the plan's own): ``bq`` 16 or 64 where its block
    fits a CTA's shared memory, resident or streamed by depth chunk;
    ``splits`` at least 1, cut to whole tiles with no split empty. Raises
    on a block that does not fit."""
    _check_rows(rows)
    if bq is None:
        bq = query_block(b, d, k, rows, planes)
    elif bq not in (SMALL_BQ, LARGE_BQ):
        raise ValueError(f"bq must be {SMALL_BQ} or {LARGE_BQ}, got {bq!r}")
    elif not (_fits(bq, d, k, rows, True, planes)
              or (rows != "int8" and _fits(bq, d, k, rows, False, planes))):
        raise ValueError(
            f"a {bq}-query block of {rows} rows at D={d}, k={k} does not fit "
            f"in a CTA's shared memory ({SMEM_PER_CTA} bytes)")
    if splits is None:
        return FusedPlan(bq, *doc_splits(
            n, b, bq, ctas_per_sm(bq, d, k, rows, planes), sms, TN))
    if not isinstance(splits, int) or splits < 1:
        raise ValueError(f"splits must be an int >= 1, got {splits!r}")
    spans = -(-n // TN)
    per = -(-spans // min(splits, spans)) * TN
    return FusedPlan(bq, -(-n // per), per)


def tau_fused_plan(n: int, b: int, d: int, k: int, sms: int,
                   rows: str = "int8",
                   bq: Optional[int] = None,
                   planes: Optional[int] = None) -> Tuple[int, int]:
    """K1/K2's tau pass: (splits, rows per split) over the rows 0, 64,
    128, ...; each split a whole number of tiles of TN subsample rows,
    so every split starts on a multiple of TAU_STRIDE. ``bq``: the main
    pass's query block (default: the plan's own)."""
    if bq is None:
        bq = query_block(b, d, k, rows, planes)
    return doc_splits(n, b, bq, ctas_per_sm(bq, d, k, rows, planes), sms,
                      TN * TAU_STRIDE)


def ivf_plan(max_tiles: int, tile_n: int, b: int, d: int, k: int,
             sms: int, rows: str = "int8") -> IvfPlan:
    """K3/K4: a walker per CTA the SMs hold and query block, at most one
    per item."""
    bq = query_block(b, d, k, rows)
    q_blocks = -(-b // bq)
    spt = -(-tile_n // TN)
    walkers = min(max(1, ctas_per_sm(bq, d, k, rows) * sms // q_blocks),
                  max_tiles * spt)
    return IvfPlan(bq, walkers, spt)


def tau_ivf_walkers(max_tiles: int, tile_n: int, b: int, d: int, k: int,
                    sms: int, rows: str = "int8") -> int:
    """K3/K4's tau pass: walkers over items of TN rows taken every
    TAU_STRIDE-th within each tabled tile."""
    bq = query_block(b, d, k, rows)
    q_blocks = -(-b // bq)
    spt = -(-tile_n // (TN * TAU_STRIDE))
    return min(max(1, ctas_per_sm(bq, d, k, rows) * sms // q_blocks),
               max_tiles * spt)


def workspace_bytes(b: int, k: int, walkers: int, tau_walkers: int, d: int,
                    pieces: bool) -> int:
    """The scratch of one call, laid out as ``carve_workspace`` in
    ``csrc/split_topk.cuh``: the main and tau passes' partial lists
    ([B][walkers][k] f32 and int32 each), tau [B], and (``pieces``: bf16
    rows) the query's three bf16 planes [3][B][D]; each piece on a
    256-byte boundary."""
    def up(n: int) -> int:
        return -(-n // 256) * 256

    main, sub = 4 * b * walkers * k, 4 * b * tau_walkers * k
    return (2 * up(main) + 2 * up(sub) + up(4 * b)
            + up(6 * b * d if pieces else 0))


def ivf_items(table: Sequence[int], max_tiles: int, tile_n: int, rows: int,
              walkers: int, spt: int,
              stride: int = 1) -> List[List[Tuple[int, int]]]:
    """K3/K4's walk, as each walker takes it: walker w scores items w, w +
    walkers, ... (item i: sub-tile i % spt of table slot i // spt) until
    the slots run out or reach a -1; item rows r0, r0 + stride, ... below
    r1, clipped to the tile and to ``rows`` (r1 == r0 for a sub-tile past
    the real rows). ``stride`` = TAU_STRIDE is the tau pass's walk, with
    spt = ceil(tile_n / (TN * stride))."""
    out = []
    span = TN * stride
    for w in range(walkers):
        items = []
        item = w
        while item // spt < max_tiles and table[item // spt] >= 0:
            base = table[item // spt] * tile_n
            r0 = base + (item % spt) * span
            r1 = min(base + tile_n, r0 + span, rows)
            items.append((r0, max(r0, r1)))
            item += walkers
        out.append(items)
    return out
