"""Share of the traced window in which no device operation ran: each
card's idle share, averaged over the cell's cards (on one card, that
card's share)."""

READS = ("device",)


def read(w):
    if not w.device_ops or w.window_s <= 0:
        return None
    busy = w.card_busy_s or {0: w.busy_s}
    idle = [1.0 - busy.get(c, 0.0) / w.window_s for c in range(w.chips)]
    return 100.0 * sum(idle) / w.chips
