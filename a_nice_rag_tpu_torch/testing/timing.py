"""Device timing on the card.

Three timers, each of which raises without a GPU (a device metric needs
the device; there is no CPU fallback):

- :func:`cuda_event_ms`: one pair of CUDA events around each call,
  median of ``n`` calls. Device time of one call, enqueue excluded.
- :func:`device_loop_ms`: one pair of CUDA events around ``n_loop``
  back-to-back calls, divided by ``n_loop``; the best of ``trials``.
  Calls too short to time alone amortise the events; the host's enqueue
  is hidden as long as it keeps ahead of the device.
- :func:`chained_ms`: the host clock around ``n`` back-to-back calls
  that end in ``torch.cuda.synchronize()``, divided by ``n``; the best
  of ``trials``. What a caller that issues calls in a row sees, host
  dispatch included.
- :func:`profiled_kernel_ms`: ``torch.profiler``'s device time of the
  kernels whose name holds a given string, per launch, over ``n`` calls:
  the kernel alone, where a call's host work outlasts it.
- :func:`profiled_device_ms`: the device time and the launches of every
  kernel of a call, per call, from the same trace.
- :func:`profiled_top_kernels`: the same trace's kernels grouped by
  name, the costliest first: where a call's device time goes.

A trace that holds no kernel at all is taken again, up to
``TRACE_ATTEMPTS`` times: ``torch.profiler`` has returned one without
the device's activity right after another session on the card.

The JAX package's counterparts (``testing/timing.py``:
``chained_dispatch_ms`` and ``true_device_ms``) force value reads and
de-bias a loop inside one program against a remote backend's round
trip; a local card needs neither.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Tuple

import torch

from a_nice_rag_tpu_torch.device import require_cuda


def _warm(fn: Callable[[], object], warmup: int) -> None:
    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()


def cuda_event_ms(fn: Callable[[], object], n: int = 10,
                  warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` over ``n`` timed calls."""
    _warm(fn, warmup)
    samples = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def device_loop_ms(fn: Callable[[], object], n_loop: int = 20,
                   trials: int = 3, warmup: int = 2) -> float:
    """Device milliseconds per call of ``n_loop`` back-to-back calls
    between one pair of CUDA events; the best of ``trials``."""
    _warm(fn, warmup)
    best = float("inf")
    for _ in range(max(1, trials)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_loop):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n_loop)
    return best


def chained_ms(fn: Callable[[], object], n: int = 10, trials: int = 3,
               warmup: int = 2) -> float:
    """Host milliseconds per call of ``n`` back-to-back calls ending in
    one ``torch.cuda.synchronize()``; the best of ``trials``."""
    _warm(fn, warmup)
    best = float("inf")
    for _ in range(max(1, trials)):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / n * 1e3)
    return best


TRACE_ATTEMPTS = 3


def _traced_kernels(fn: Callable[[], object], n: int, warmup: int,
                    keep: Callable, what: str) -> list:
    """``key_averages`` entries that ``keep`` selects, from a CUDA trace
    of ``n`` calls of ``fn``; a trace without a CUDA kernel is taken
    again (see the module's docstring)."""
    from torch.profiler import ProfilerActivity, profile

    _warm(fn, warmup)
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        entries = prof.key_averages()
        if any(e.device_type.name == "CUDA" for e in entries):
            break
    events = [e for e in entries if keep(e)]
    if not sum(e.count for e in events):
        raise RuntimeError(f"the profiler traced no kernel named {what}")
    return events


def profiled_kernel_ms(fn: Callable[[], object], kernel: str, n: int = 50,
                       warmup: int = 3) -> float:
    """Mean device milliseconds per launch of the kernels whose name holds
    ``kernel``, traced by ``torch.profiler`` over ``n`` calls of ``fn``;
    raises if the trace holds none."""
    events = _traced_kernels(fn, n, warmup, lambda e: kernel in e.key,
                             f"*{kernel}*")
    launches = sum(e.count for e in events)
    return sum(e.device_time_total for e in events) / launches / 1e3


def profiled_device_ms(fn: Callable[[], object], n: int = 5,
                       warmup: int = 1) -> Tuple[float, float]:
    """(device milliseconds, kernel launches) per call of ``fn``: every
    CUDA kernel of ``n`` calls in one ``torch.profiler`` trace; raises if
    the trace holds none."""
    events = _traced_kernels(fn, n, warmup,
                             lambda e: e.device_type.name == "CUDA", "at all")
    return (sum(e.self_device_time_total for e in events) / n / 1e3,
            sum(e.count for e in events) / n)


def profiled_top_kernels(fn: Callable[[], object], n: int = 3,
                         top: int = 6, warmup: int = 1) -> list:
    """The ``top`` kernels of ``fn`` by device time, per call: ``[{"kernel":
    name (its first 80 characters), "ms", "launches"}]``, costliest
    first, from one ``torch.profiler`` trace of ``n`` calls; raises if the
    trace holds none."""
    events = _traced_kernels(fn, n, warmup,
                             lambda e: e.device_type.name == "CUDA", "at all")
    events = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return [{"kernel": e.key[:80],
             "ms": e.self_device_time_total / n / 1e3,
             "launches": e.count / n} for e in events]
