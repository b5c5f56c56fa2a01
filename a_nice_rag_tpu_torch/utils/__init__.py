"""Cross-cutting utilities: tracing and profiling (counterpart of
``a_nice_rag_tpu.utils``)."""

from a_nice_rag_tpu_torch.utils.trace import QueryTrace, TraceRun  # noqa: F401
