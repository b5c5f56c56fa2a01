"""Measurement helpers for the port."""

from a_nice_rag_tpu_torch.testing.timing import cuda_event_ms  # noqa: F401
