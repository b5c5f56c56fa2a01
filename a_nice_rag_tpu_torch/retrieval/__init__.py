"""Retrieval over the array index (counterpart of
``a_nice_rag_tpu.retrieval``): ``SearchEngine``, the reference-parity
per-method API, and ``FusedRetriever``, every ranker, fusion and top-n
in one call; the embedding and rerank clients."""

from a_nice_rag_tpu_torch.retrieval.embed import (  # noqa: F401
    Embedder,
    OpenAIEmbedder,
    PrecomputedEmbedder,
    VoyageEmbedder,
)
from a_nice_rag_tpu_torch.retrieval.engine import (  # noqa: F401
    FusedRetriever,
    SearchEngine,
)
from a_nice_rag_tpu_torch.retrieval.rerank import (  # noqa: F401
    IdentityReranker,
    MultiModelReranker,
    Reranker,
    VoyageReranker,
)
