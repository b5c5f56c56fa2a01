"""Retrieval compute ops on torch tensors: top-k, dense and int8 scoring,
BM25 and WRRF fusion (counterparts of ``a_nice_rag_tpu.ops``)."""

from a_nice_rag_tpu_torch.ops.topk import (  # noqa: F401
    masked_top_k,
    hierarchical_top_k,
    merge_top_k,
)
from a_nice_rag_tpu_torch.ops.dense import dense_scores, dense_top_k  # noqa: F401
from a_nice_rag_tpu_torch.ops.bm25 import (  # noqa: F401
    Bm25Arrays,
    bm25_scores,
    bm25_top_k,
)
from a_nice_rag_tpu_torch.ops.fusion import (  # noqa: F401
    wrrf_scores,
    wrrf_top_n,
    wrrf_top_n_sparse,
)
