"""Hand-written CUDA kernels for the retrieval hot path, with their plain
PyTorch versions (used for CPU tensors and as the on-card reference)."""

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

SOURCES = ("fused_topk", "ivf_topk")  # csrc/<name>.cu
WRAPPERS = (fused_dense_top_k, fused_dense_top_k_int8, ivf_dense_top_k,
            ivf_dense_top_k_int8)


def build_kernels() -> None:
    """Compile (one nvcc per source, all at once) and load the kernels
    now instead of at first launch."""
    _build.load_all(SOURCES)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
