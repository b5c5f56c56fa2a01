"""Griptape RagContext adapter.

Equivalent of ragas_modified/integrations/griptape.py: converts Griptape
``RagContext`` objects into an EvaluationDataset. Duck-typed on the
RagContext shape (``.query``, ``.outputs[*].to_text()``, and text
chunks under ``.text_chunks`` or module params) — no griptape import.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from a_nice_rag_tpu_torch.evals.ragas.dataset import (
    EvaluationDataset,
    SingleTurnSample,
)


def _to_text(x: Any) -> str:
    if hasattr(x, "to_text"):
        return x.to_text()
    return getattr(x, "value", None) or getattr(x, "text", None) or str(x)


def rag_context_to_dataset(
    contexts: Sequence[Any],
    references: Optional[Sequence[str]] = None,
) -> EvaluationDataset:
    samples: List[SingleTurnSample] = []
    for i, ctx in enumerate(contexts):
        outputs = [_to_text(o) for o in getattr(ctx, "outputs", [])]
        chunks = [
            _to_text(c)
            for c in getattr(ctx, "text_chunks", [])
        ]
        samples.append(
            SingleTurnSample(
                user_input=_to_text(getattr(ctx, "query", "")),
                response=outputs[-1] if outputs else None,
                retrieved_contexts=chunks or None,
                reference=references[i] if references else None,
            )
        )
    return EvaluationDataset(samples=samples)
