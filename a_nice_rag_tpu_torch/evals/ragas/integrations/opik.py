"""Opik tracing adapter (import-gated).

Equivalent of ragas_modified/integrations/opik.py, which re-exports
Opik's own langchain tracer. Requires the ``opik`` package; absent
here, so the accessor raises an actionable ImportError at call time.
"""

from __future__ import annotations


def OpikTracer(*args, **kwargs):  # noqa: N802 - upstream-compatible name
    try:
        from opik.integrations.langchain import (  # type: ignore
            OpikTracer as _OpikTracer,
        )
    except ImportError as e:
        raise ImportError("opik is required: pip install opik") from e
    return _OpikTracer(*args, **kwargs)
