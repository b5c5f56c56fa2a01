"""The program's spans in a traced window, and device time and idle gaps
put down to them.

The port names its served path's host work with
``a_nice_rag_tpu_torch.utils.trace.span``: ``sched.batch`` around a
scheduler batch, ``sched.assemble``, ``retriever``, ``retriever.upload``,
``dense``, ``bm25``, ``fusion`` and ``sched.download`` inside it. Under a
profile that records every thread (:func:`all_threads_config`) each span
is a ``user_annotation`` event with the id of the thread that opened it;
the batches run on the event loop's worker threads and on the clients'
threads, never on the thread that opened the profile.

A device operation belongs to span S when the host call that launched it
(a ``cuda_runtime`` or ``cuda_driver`` event with the same
``args.correlation``) lies inside a span named S on the launching thread.
The correlation, not the device-side ``gpu_user_annotation`` ranges,
decides: with two batches in flight on one stream, those ranges take in
the other batch's kernels.

An idle gap is labelled by what the host was doing, at the gap's middle,
on the thread that launched the device operation ending the gap: the
innermost program span there, then the innermost host operation inside it
(``retriever.upload > aten::copy_``). Where that thread has neither,
``trace.breakdown``'s rule applies: the innermost host operation of any
thread, else "no host op".
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.harness import trace

SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def all_threads_config():
    """The profiler's setting that records the host operations and spans
    of every thread. Raises TypeError where this torch lacks it."""
    import torch

    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


@dataclasses.dataclass
class Spans:
    # (name, start us, end us, correlation or None), by start
    device: List[Tuple[str, float, float, Optional[int]]]
    # correlation -> (launching thread, launch time us)
    launches: Dict[int, Tuple[int, float]]
    # thread -> [(name, start us, end us)]: program spans, host operations
    spans: Dict[int, List[Tuple[str, float, float]]]
    ops: Dict[int, List[Tuple[str, float, float]]]


def parse(events: list) -> Spans:
    device, launches = [], {}
    spans: Dict[int, list] = collections.defaultdict(list)
    ops: Dict[int, list] = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        name = str(e.get("name", ""))
        ts, dur = float(e["ts"]), float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in trace.DEVICE_CATS:
            device.append((name, ts, ts + dur,
                           None if corr is None else int(corr)))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[int(corr)] = (int(e.get("tid", 0)), ts)
        elif cat == SPAN_CAT:
            spans[int(e.get("tid", 0))].append((name, ts, ts + dur))
        elif cat in trace.HOST_CATS:
            ops[int(e.get("tid", 0))].append((name, ts, ts + dur))
    device.sort(key=lambda x: x[1])
    return Spans(device=device, launches=launches, spans=dict(spans),
                 ops=dict(ops))


def load(path: str) -> Tuple[trace.Trace, Spans]:
    """The window's trace as ``trace.py`` reads it, and its spans."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return trace.parse(events), parse(events)


class _Intervals:
    """Intervals of one thread, for the ones covering a time."""

    def __init__(self, items):
        self.items = items
        self.start = np.array([i[1] for i in items])
        self.end = np.array([i[2] for i in items])

    def innermost(self, t: float, lo: float = -np.inf,
                  hi: float = np.inf) -> Optional[Tuple[str, float, float]]:
        """The shortest interval covering ``t`` that lies within
        [lo, hi], or None."""
        if not self.items:
            return None
        inside = np.flatnonzero((self.start <= t) & (self.end >= t)
                                & (self.start >= lo) & (self.end <= hi))
        if not len(inside):
            return None
        j = inside[np.argmin(self.end[inside] - self.start[inside])]
        return self.items[j]


def span_device_s(sp: Spans) -> Dict[str, float]:
    """Device seconds of the operations launched inside each span name
    (an operation counts once for each distinct name that encloses its
    launch: ``bm25``'s kernels count to ``retriever`` and ``sched.batch``
    too)."""
    by_thread: Dict[int, Dict[str, np.ndarray]] = {}
    for tid, items in sp.spans.items():
        names: Dict[str, list] = collections.defaultdict(list)
        for name, a, b in items:
            names[name].append((a, b))
        by_thread[tid] = {name: np.array(sorted(v))
                          for name, v in names.items()}
    out: Dict[str, float] = collections.defaultdict(float)
    for _, a, b, corr in sp.device:
        launch = sp.launches.get(corr)
        if launch is None or launch[0] not in by_thread:
            continue
        tid, t = launch
        for name, ab in by_thread[tid].items():
            # Spans of one name on one thread do not overlap: the last
            # one to start at or before t is the only candidate.
            j = np.searchsorted(ab[:, 0], t, side="right") - 1
            if j >= 0 and ab[j, 1] >= t:
                out[name] += (b - a) / 1e6
    return dict(out)


def idle_gaps(sp: Spans) -> List[Tuple[float, float, int]]:
    """Idle gaps between the union of device operations, longest first
    (at most ``trace.GAPS_LABELLED``), each with the index in
    ``sp.device`` of the operation that ends it."""
    out, end = [], None
    for i, (_, a, b, _) in enumerate(sp.device):
        if end is not None and a > end:
            out.append((end, a, i))
        end = b if end is None else max(end, b)
    out.sort(key=lambda g: g[0] - g[1])
    return out[:trace.GAPS_LABELLED]


def label_gaps(tr: trace.Trace,
               sp: Spans) -> List[Tuple[str, float, bool]]:
    """(label, idle seconds, whether the launching thread gave the
    label) of each gap that ``trace.breakdown`` labels (module
    docstring)."""
    spans = {tid: _Intervals(v) for tid, v in sp.spans.items()}
    ops = {tid: _Intervals(v) for tid, v in sp.ops.items()}
    every = _Intervals([(n, ts, ts + dur) for n, ts, dur in tr.host])
    out = []
    for g0, g1, i in idle_gaps(sp):
        mid = 0.5 * (g0 + g1)
        parts = []
        launch = sp.launches.get(sp.device[i][3])
        if launch is not None:
            tid = launch[0]
            s = spans[tid].innermost(mid) if tid in spans else None
            lo, hi = (s[1], s[2]) if s is not None else (-np.inf, np.inf)
            op = ops[tid].innermost(mid, lo, hi) if tid in ops else None
            parts = [x[0] for x in (s, op) if x is not None]
        if parts:
            label = " > ".join(parts)
        else:
            host = every.innermost(mid)
            label = "no host op" if host is None else host[0]
        out.append((label[:trace.NAME_CHARS], (g1 - g0) / 1e6, bool(parts)))
    return out


def gap_labels(tr: trace.Trace, sp: Spans) -> Dict[str, float]:
    """Idle seconds by label: ``trace.breakdown``'s ``idle_gaps`` where
    the trace holds no launch."""
    idle: Dict[str, float] = collections.defaultdict(float)
    for label, s, _ in label_gaps(tr, sp):
        idle[label] += s
    return dict(idle)


def not_begun_s(sp: Spans) -> float:
    """Idle seconds of the gaps whose ending operation was launched in a
    ``sched.batch`` that began after the gap did: the device went idle
    before the next batch had started on any thread."""
    batches = {tid: [(a, b) for n, a, b in v if n == "sched.batch"]
               for tid, v in sp.spans.items()}
    total = 0.0
    for g0, g1, i in idle_gaps(sp):
        launch = sp.launches.get(sp.device[i][3])
        if launch is None:
            continue
        tid, t = launch
        total += sum((g1 - g0) / 1e6 for a, b in batches.get(tid, ())
                     if a <= t <= b and a > g0)
    return total


def queue_ms(stats: Dict[str, float]) -> Optional[float]:
    """The scheduler's mean wait from arrival to a batch slot, in ms:
    ``queue_s`` over ``entries_run`` (None where the counters are
    missing or no entry ran)."""
    if not stats.get("entries_run") or "queue_s" not in stats:
        return None
    return 1e3 * stats["queue_s"] / stats["entries_run"]
