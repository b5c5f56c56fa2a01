"""Serving layer (counterpart of ``a_nice_rag_tpu.serving``): the
micro-batching scheduler that coalesces concurrent queries into one
device call, the native binary front, the HTTP surface (``http_api``,
``serve_cli``), the chat app and the feedback log."""

from a_nice_rag_tpu_torch.serving.scheduler import (  # noqa: F401
    BatchScheduler,
    SchedulerPool,
)
from a_nice_rag_tpu_torch.serving.feedback import FeedbackLog  # noqa: F401
from a_nice_rag_tpu_torch.serving.native_front import (  # noqa: F401
    NativeFrontClient,
    NativeFrontUnavailable,
    NativeRetrievalFront,
)
