"""Query-level tracing.

The reference records a per-evaluation ChainRun tree via langchain
callbacks (ragas_modified/callbacks.py:80-121) and logs wall-clock
timers around DB load / retrieval / LLM stages (src/query_rag.py:414-415,
:520-523). ``QueryTrace`` unifies both: named spans with durations and a
parent/child run tree, exportable as plain dicts. A ``torch.profiler``
trace of the host and the card can be layered on via
:func:`device_profile`.

Counterpart of ``a_nice_rag_tpu/utils/trace.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import uuid
from typing import Any, Dict, List, Optional

import torch


@dataclasses.dataclass
class TraceRun:
    """One node in a trace tree (a stage, metric, or LLM call)."""

    name: str
    run_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:12]
    )
    parent_id: Optional[str] = None
    inputs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    outputs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    start: float = 0.0
    end: float = 0.0
    children: List["TraceRun"] = dataclasses.field(default_factory=list)

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "run_id": self.run_id,
            "parent_id": self.parent_id,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "duration_s": self.duration,
            "children": [c.to_dict() for c in self.children],
        }


class QueryTrace:
    """Span recorder for one query's trip through the pipeline."""

    def __init__(self, query: str = "", source: str = ""):
        self.root = TraceRun(name="query", inputs={"query": query, "source": source})
        self.root.start = time.time()
        self.durations: Dict[str, float] = {}
        self._stack: List[TraceRun] = [self.root]

    @contextlib.contextmanager
    def span(self, name: str, **inputs):
        run = TraceRun(
            name=name, parent_id=self._stack[-1].run_id, inputs=inputs
        )
        run.start = time.time()
        self._stack[-1].children.append(run)
        self._stack.append(run)
        try:
            yield run
        finally:
            run.end = time.time()
            self._stack.pop()
            self.durations[name] = run.duration

    def to_dict(self) -> Dict[str, Any]:
        self.root.end = time.time()
        return self.root.to_dict()


@contextlib.contextmanager
def device_profile(log_dir: str):
    """``torch.profiler`` trace around a block, the counterpart of
    ``jax.profiler.start_trace``: CPU activity, plus CUDA kernels and
    copies when a card is present, exported as a Chrome trace
    (``trace.json``, readable by chrome://tracing and Perfetto) into
    ``log_dir``. Yields the profiler; the trace's path is its
    ``trace_path`` attribute once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(prof.trace_path)
