"""Device-resident array index: dense matrices, CSR BM25 postings and
host-side metadata (counterpart of ``a_nice_rag_tpu.index``)."""

from a_nice_rag_tpu_torch.index.array_index import (  # noqa: F401
    ArrayIndex,
    CorpusMeta,
    build_bm25_arrays,
    build_index,
)
from a_nice_rag_tpu_torch.index.convert import from_reference_index  # noqa: F401
from a_nice_rag_tpu_torch.index.io import load_index, save_index  # noqa: F401
