"""K2's share of its roofline: the bound of every batch's K2 call over
the time of K2's launches in the traced window (its main and tau passes,
``topk_kernel`` over ``Int8RowsT``; its merge). The bound counts int8
rows [N, D] with f32 scales, int8 queries [B, D] with f32 scales and the
k (value, id) pairs of each query once, and 2 B N D int8 operations; B
is the batch's padded row count, as the call computes."""

from benchmark.harness.roofline import k2_bound_s

READS = ("device", "batches")


def _is_k2(name):
    return ("topk_kernel" in name and "Int8Rows" in name) \
        or "merge_kernel" in name


def read(w):
    if not any("topk_kernel" in n and "Int8Rows" in n
               for n, _, _ in w.device_ops):
        return None
    spent_s = sum(dur for n, _, dur in w.device_ops if _is_k2(n)) / 1e6
    c = w.config
    bound = sum(k2_bound_s(b, c["n_docs"], c["dim"],
                           c["retriever"]["similarity_k"])
                for b in w.batch_rows)
    return 100.0 * bound / spent_s
