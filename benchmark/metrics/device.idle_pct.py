"""Share of the traced window in which no device operation ran."""


def read(w):
    if not w.device_ops or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
