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

The JAX package's counterparts (``testing/timing.py``:
``chained_dispatch_ms`` and ``true_device_ms``) force value reads and
de-bias a loop inside one program against a remote backend's round
trip; a local card needs neither.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

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


def profiled_kernel_ms(fn: Callable[[], object], kernel: str, n: int = 50,
                       warmup: int = 3) -> float:
    """Mean device milliseconds per launch of the kernels whose name holds
    ``kernel``, traced by ``torch.profiler`` over ``n`` calls of ``fn``;
    raises if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    _warm(fn, warmup)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    launches = sum(e.count for e in events)
    if not launches:
        raise RuntimeError(f"the profiler traced no kernel named *{kernel}*")
    return sum(e.device_time_total for e in events) / launches / 1e3
