"""The kernel wrappers' launch counts, bumped under one lock: the served
fronts call the kernels from several dispatch threads at once, and a
bare ``fn.launches += 1`` from two threads can lose one."""

import threading

_LOCK = threading.Lock()


def count_launch(fn, counter: str = "launches") -> None:
    """One more launch of ``fn``'s kernel (``counter``: another count the
    wrapper keeps, of one of its routes)."""
    with _LOCK:
        setattr(fn, counter, getattr(fn, counter) + 1)
