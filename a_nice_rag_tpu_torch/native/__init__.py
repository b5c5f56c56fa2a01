"""Native (C++) host-runtime components, loaded through ctypes: the binary
serving front (``anr_serve.cpp``) and the BM25 text preprocessing
(``anr_text.cpp``)."""

from a_nice_rag_tpu_torch.native.build import (  # noqa: F401
    load_serve_lib,
    load_text_lib,
    native_preprocess,
)
