"""Share of the traced window in which every card of the cell ran a
device operation at once: whether the host, which dispatches a sharded
batch shard by shard, lets the cards work side by side. A cell of one
card has nothing to read."""

from benchmark.harness.trace import all_busy_s

READS = ("device",)


def read(w):
    if w.chips < 2 or not w.card_spans or w.window_s <= 0:
        return None
    return 100.0 * all_busy_s(w.card_spans) / w.window_s
