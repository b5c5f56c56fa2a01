"""Rows a device batch carried over the window: the scheduler's own
counters (``SchedulerPool.stats``: queries_served / batches_run)."""

READS = ("batches",)


def read(w):
    if not w.stats.get("batches_run"):
        return None
    return w.stats["queries_served"] / w.stats["batches_run"]
