"""Offline ingestion (counterpart of ``a_nice_rag_tpu.ingest``): BM25
corpus preprocessing and build (``bm25_build``), its tuner
(``bm25_tune``), query-set preparation (``query_prep``) and the
migration of the reference deployment's artifacts into an index
(``import_reference``). The chunking, XML and embedding stages of the
JAX package's pipeline are not ported yet."""
