"""Spans and the profiler trace.

:func:`span` names a stretch of host work. Under a recording
``torch.profiler`` it is a ``record_function`` range: a
``user_annotation`` event in the same Chrome trace as the kernels and
copies it launched, on the same clock, with the id of the thread that
opened it. With no profiler recording it is one shared null context, so
the served path pays a flag check a span.

``QueryTrace`` times named stages of one query (the reference logs
wall-clock timers around DB load / retrieval / LLM stages,
src/query_rag.py:414-415, :520-523) and opens a :func:`span` for each.
:func:`device_profile` records a ``torch.profiler`` trace of every
thread around a block.

Counterpart of ``a_nice_rag_tpu/utils/trace.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the host work inside it: a
    ``torch.profiler.record_function`` range while a profiler records,
    else a shared null context. The profiler's flag is read at each call
    (it is set for every thread while a profile is open)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class QueryTrace:
    """Stage timer for one query's trip through the pipeline:
    ``durations[name]`` is the last span of that name, in seconds."""

    def __init__(self):
        self.durations: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.durations[name] = time.perf_counter() - start


@contextlib.contextmanager
def device_profile(log_dir: str):
    """``torch.profiler`` trace around a block, the counterpart of
    ``jax.profiler.start_trace``: CPU activity of every thread (a serving
    process's batches run on its worker and caller threads), plus CUDA
    kernels and copies when a card is present, exported as a Chrome trace
    (``trace.json``, readable by chrome://tracing and Perfetto) into
    ``log_dir``. Yields the profiler; the trace's path is its
    ``trace_path`` attribute once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # Without the flag only the thread that opens the profile records
    # host operations and spans.
    prof = profile(activities=activities,
                   experimental_config=torch._C._profiler._ExperimentalConfig(
                       profile_all_threads=True))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(prof.trace_path)
