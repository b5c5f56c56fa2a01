"""Reading the device trace of a window, and what per-layer readers see.

The traced run wraps its window in ``torch.profiler`` (CPU and CUDA
activity) and exports a Chrome trace, read back here: device operations
are the events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``;
host operations those of ``cpu_op``. A device operation's card is its
event's ``args.device``. A card's busy time is the union of its device
operations' intervals; the device's busy time (``busy_s``) the mean of
its cards'.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
# The longest idle gaps labelled by the host operation running in them.
GAPS_LABELLED = 1000
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, float, float]]  # (name, start us, duration us)
    host: List[Tuple[str, float, float]]
    # The card of each device operation (None where the trace names none).
    cards: List[Optional[int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Window:
    """What a per-layer metric's ``read`` gets, by feed (a metric's
    ``READS``, a driver's ``FEEDS``): ``device``, which every driver
    feeds, is the trace (``device_ops``, ``busy_s``, ``window_s``,
    ``chips``, the cards' spans); ``batches`` (retrieval) is
    ``batch_rows`` and ``stats``' batches_run and queries_served;
    ``server`` (generation) is ``stats``' ticks, tokens_emitted,
    prefix_cache_hits and prompt_tokens."""

    device_ops: List[Tuple[str, float, float]]
    busy_s: float
    window_s: float
    batch_rows: List[int]       # padded rows of every batch in the window
    stats: Dict[str, int]       # the driver's counters over the window
    config: dict
    chips: int = 1              # the cards the cell runs on
    # Each card's busy intervals (us, ascending, disjoint), and their
    # seconds; every card of the cell, busy or not.
    card_spans: Dict[int, List[Tuple[float, float]]] = dataclasses.field(
        default_factory=dict)
    card_busy_s: Dict[int, float] = dataclasses.field(default_factory=dict)


def parse(events: list) -> Trace:
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        item = (str(e.get("name", "")), float(e["ts"]), float(e["dur"]))
        if cat in DEVICE_CATS:
            card = (e.get("args") or {}).get("device")
            dev.append((item, None if card is None else int(card)))
        elif cat in HOST_CATS:
            host.append(item)
    dev.sort(key=lambda x: x[0][1])
    return Trace(device=[op for op, _ in dev], host=host,
                 cards=[card for _, card in dev])


def load(path: str) -> Trace:
    with open(path) as f:
        doc = json.load(f)
    return parse(doc["traceEvents"] if isinstance(doc, dict) else doc)


def export(prof) -> Trace:
    """The profiler's trace through a temporary file (removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load(path)
    finally:
        os.remove(path)


def _union(ops) -> List[Tuple[float, float]]:
    spans: List[List[float]] = []
    for _, ts, dur in ops:
        end = ts + dur
        if spans and ts <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], end)
        else:
            spans.append([ts, end])
    return [(a, b) for a, b in spans]


def busy_s(ops) -> float:
    """Seconds in which some device operation ran (``ops`` by start)."""
    return spans_s(_union(ops))


def spans_s(spans) -> float:
    return sum(b - a for a, b in spans) / 1e6


def card_spans(tr: Trace, chips: int) -> Dict[int, List[Tuple[float, float]]]:
    """Each card's busy intervals, for cards 0 .. chips - 1. On one card
    every device operation is that card's; on more, the trace's card
    numbers are the CUDA ordinals the run used."""
    if chips == 1:
        return {0: _union(tr.device)}
    ops: Dict[int, list] = {c: [] for c in range(chips)}
    for op, card in zip(tr.device, tr.cards):
        if card in ops:
            ops[card].append(op)
    return {c: _union(o) for c, o in ops.items()}


def mean_busy_s(spans: Dict[int, List[Tuple[float, float]]]) -> float:
    """The cards' busy seconds, averaged over the cards."""
    return sum(spans_s(sp) for sp in spans.values()) / len(spans)


def all_busy_s(spans: Dict[int, List[Tuple[float, float]]]) -> float:
    """Seconds in which every card ran a device operation at once."""
    cards = list(spans.values())
    if not cards:
        return 0.0
    common = cards[0]
    for other in cards[1:]:
        common = _intersect(common, other)
    return spans_s(common)


def _intersect(a, b) -> List[Tuple[float, float]]:
    """The intersection of two ascending lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the innermost host operation running at each gap's
    middle ("no host op" where none ran)."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    for name, _, dur in tr.device:
        by_name[name[:NAME_CHARS]] += dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = _union(tr.device)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:])
            if a1 > b0]
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:GAPS_LABELLED]
    idle: Dict[str, float] = collections.defaultdict(float)
    if gaps:
        h_start = np.array([h[1] for h in tr.host])
        h_end = h_start + np.array([h[2] for h in tr.host])
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            inside = np.flatnonzero((h_start <= mid) & (h_end >= mid)) \
                if len(tr.host) else []
            if len(inside):
                j = inside[np.argmin(h_end[inside] - h_start[inside])]
                label = tr.host[j][0][:NAME_CHARS]
            else:
                label = "no host op"
            idle[label] += (g1 - g0) / 1e6
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps_out]}


def read_metrics(readers: dict, w: Window) -> Dict[str, Optional[float]]:
    """Each per-layer metric's reading; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for name, read in readers.items():
        v = read(w)
        if v is not None:
            out[name] = float(v)
    return out
