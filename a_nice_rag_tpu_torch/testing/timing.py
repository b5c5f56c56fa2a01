"""Device timing with CUDA events.

Each sample brackets one call with a pair of CUDA events on the current
stream, so it measures device time from the first enqueued kernel to the
last, not the host's enqueue. The result is the median of ``n`` samples
after ``warmup`` untimed calls. There is no CPU fallback: timing a device
metric needs the device.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

from a_nice_rag_tpu_torch.device import require_cuda


def cuda_event_ms(fn: Callable[[], object], n: int = 10,
                  warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` over ``n`` timed calls."""
    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
