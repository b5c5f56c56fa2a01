"""Native (C++) host-runtime components, loaded through ctypes: the binary
serving front (``anr_serve.cpp``)."""

from a_nice_rag_tpu_torch.native.build import load_serve_lib  # noqa: F401
