"""Hand-written CUDA kernels for the retrieval hot path and the stream
floor, with their plain PyTorch versions (used for CPU tensors and as
the on-card reference)."""

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (  # noqa: F401
    fused_dense_top_k,
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_torch,
    fused_dense_top_k_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.ivf_topk import (  # noqa: F401
    ivf_dense_top_k,
    ivf_dense_top_k_int8,
    ivf_dense_top_k_int8_torch,
    ivf_dense_top_k_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.stream import (  # noqa: F401
    stream_sum,
    stream_sum_busy,
    stream_sum_busy_torch,
    stream_sum_torch,
)

SOURCES = ("fused_topk", "ivf_topk", "stream_sum")  # csrc/<name>.cu
WRAPPERS = (fused_dense_top_k, fused_dense_top_k_int8, ivf_dense_top_k,
            ivf_dense_top_k_int8, stream_sum, stream_sum_busy)


def build_kernels() -> None:
    """Compile (one nvcc per source, all at once) and load the kernels
    now instead of at first launch."""
    _build.load_all(SOURCES)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
