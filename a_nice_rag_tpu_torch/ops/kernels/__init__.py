"""Hand-written CUDA kernels for the retrieval hot path, the stream floor
and the probes of the fused top-k, with their plain PyTorch versions
(used for CPU tensors and as the on-card reference)."""

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels.anatomy import (  # noqa: F401
    anatomy_top_k,
    anatomy_top_k_cluster,
    anatomy_top_k_cluster_torch,
    anatomy_top_k_int8,
    anatomy_top_k_int8_cluster,
    anatomy_top_k_int8_cluster_torch,
    anatomy_top_k_int8_torch,
    anatomy_top_k_torch,
    fused_top_k_counted,
    fused_top_k_counted_cluster,
    fused_top_k_counted_cluster_torch,
    fused_top_k_counted_int8,
    fused_top_k_counted_int8_cluster,
    fused_top_k_counted_int8_cluster_torch,
    fused_top_k_counted_int8_torch,
    fused_top_k_counted_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.bm25_sparse import (  # noqa: F401
    bm25_sparse_top_k,
    bm25_sparse_top_k_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (  # noqa: F401
    fused_dense_top_k,
    fused_dense_top_k_bf16_compare,
    fused_dense_top_k_bf16_compare_torch,
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_rounded,
    fused_dense_top_k_int8_torch,
    fused_dense_top_k_rounded,
    fused_dense_top_k_torch,
    split_query,
    subsample_tau,
    subsample_tau_int8,
    subsample_tau_int8_torch,
    subsample_tau_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.int4 import (  # noqa: F401
    int4_fold_max,
    int4_fold_max_torch,
    int4_scores,
    int4_scores_torch,
    int8_fold_max,
    int8_fold_max_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.ivf_topk import (  # noqa: F401
    ivf_dense_top_k,
    ivf_dense_top_k_int8,
    ivf_dense_top_k_int8_torch,
    ivf_dense_top_k_torch,
    ivf_subsample_tau_int8_torch,
    ivf_subsample_tau_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.keys import (  # noqa: F401
    bf16_row_reduce,
    bf16_row_reduce_torch,
    xpack_keys,
    xpack_keys_torch,
    xpack_values,
    xpack_values_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.stream import (  # noqa: F401
    stream_sum,
    stream_sum_busy,
    stream_sum_busy_torch,
    stream_sum_torch,
)

# csrc/<name>.cu
SOURCES = ("fused_topk", "ivf_topk", "stream_sum", "anatomy", "keys", "int4",
           "cluster_topk", "cluster_probe", "bm25_sparse")
WRAPPERS = (fused_dense_top_k, fused_dense_top_k_int8,
            fused_dense_top_k_rounded, fused_dense_top_k_int8_rounded,
            ivf_dense_top_k,
            ivf_dense_top_k_int8, stream_sum, stream_sum_busy,
            anatomy_top_k, anatomy_top_k_int8, fused_top_k_counted,
            fused_top_k_counted_int8, anatomy_top_k_cluster,
            anatomy_top_k_int8_cluster, fused_top_k_counted_cluster,
            fused_top_k_counted_int8_cluster, xpack_keys, xpack_values,
            bf16_row_reduce, int4_scores, int8_fold_max, int4_fold_max,
            fused_dense_top_k_bf16_compare, bm25_sparse_top_k)


def build_kernels() -> None:
    """Compile (one nvcc per source, all at once) and load the kernels
    now instead of at first launch."""
    _build.load_all(SOURCES)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in (fused_dense_top_k_rounded, fused_dense_top_k_int8_rounded,
               fused_dense_top_k_bf16_compare):
        fn.split_launches = 0
    bm25_sparse_top_k.torch_route = 0
