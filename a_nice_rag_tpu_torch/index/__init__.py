"""Device-resident array index: dense matrices, CSR BM25 postings, IVF
structures and host-side metadata (counterpart of ``a_nice_rag_tpu.index``)."""

from a_nice_rag_tpu_torch.index.array_index import (  # noqa: F401
    ArrayIndex,
    CorpusMeta,
    build_bm25_arrays,
    build_index,
)
from a_nice_rag_tpu_torch.index.convert import from_reference_index  # noqa: F401
from a_nice_rag_tpu_torch.index.io import (  # noqa: F401
    load_index,
    load_reference_chunk_db,
    load_reference_query_db,
    save_index,
)
from a_nice_rag_tpu_torch.index.updates import (  # noqa: F401
    append_documents,
    delete_documents,
    undelete_documents,
)
from a_nice_rag_tpu_torch.index.ivf import (  # noqa: F401
    IVFDense,
    attach_ivf,
    build_ivf_dense,
    build_ivf_quantized,
    ivf_search,
    load_ivf,
    save_ivf,
)
