"""Device milliseconds a batch: every device operation's time in the
traced window (kernels, copies, sets) over the batches the pool ran."""

READS = ("device", "batches")


def read(w):
    if not w.device_ops or not w.stats.get("batches_run"):
        return None
    total_us = sum(dur for _, _, dur in w.device_ops)
    return total_us / 1e3 / w.stats["batches_run"]
