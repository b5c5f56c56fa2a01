"""K1's share of its roofline: the bound of every batch's K1 call over
the time of K1's launches in the traced window (its main and tau passes,
``topk_kernel`` over ``FloatRows``; its query split; its merge). The
bound counts bf16 rows [N, D], f32 queries [B, D] and the k (value, id)
pairs of each query once, and 2 B N D bf16 operations; B is the batch's
padded row count, as the call computes."""

from benchmark.harness.roofline import k1_bound_s

READS = ("device", "batches")


def _is_k1(name):
    return (("topk_kernel" in name and "FloatRows" in name)
            or "split_query_kernel" in name or "merge_kernel" in name)


def read(w):
    if not any("topk_kernel" in n and "FloatRows" in n
               for n, _, _ in w.device_ops):
        return None
    spent_s = sum(dur for n, _, dur in w.device_ops if _is_k1(n)) / 1e6
    c = w.config
    bound = sum(k1_bound_s(b, c["n_docs"], c["dim"],
                           c["retriever"]["similarity_k"])
                for b in w.batch_rows)
    return 100.0 * bound / spent_s
