"""Offline ingestion pipeline (L0), counterpart of ``a_nice_rag_tpu.ingest``:
API -> XML -> markdown -> chunks -> embeddings + BM25 artifacts.

The stages of the reference's processing chain (src/processing/:
nice_api_script -> convert_xml_to_md -> chunk_mds -> create_database +
preprocess_bm25 -> bm25_search): the NICE download (``nice_api``), XML to
markdown (``xml_to_md``), heading-aware chunking (``chunker``, sized by
``tokens``), BM25 preprocessing and build (``bm25_build``) and its tuner
(``bm25_tune``), embedding into chunk DBs and the index artifact
(``embed_db``), all driven by ``run_pipeline``; plus query-set
preparation (``query_prep``) and the migration of the reference
deployment's SQLite and pickle into an index (``import_reference``).
"""

from a_nice_rag_tpu_torch.ingest.tokens import TokenCounter  # noqa: F401
from a_nice_rag_tpu_torch.ingest.chunker import (  # noqa: F401
    Chunk,
    MarkdownChunker,
)
from a_nice_rag_tpu_torch.ingest.xml_to_md import (  # noqa: F401
    convert_xml_to_markdown,
)
