"""Hand-written CUDA kernels for the retrieval hot path, with their plain
PyTorch versions (used for CPU tensors and as the on-card reference)."""

from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (  # noqa: F401
    build_kernels,
    fused_dense_top_k,
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_torch,
    fused_dense_top_k_torch,
    reset_launch_counts,
)
