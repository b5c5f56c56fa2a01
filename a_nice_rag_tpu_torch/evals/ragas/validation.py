"""Dataset column validation/remapping (ragas_modified/validation.py)."""

from __future__ import annotations

from typing import Dict, List, Sequence

from a_nice_rag_tpu_torch.evals.ragas.dataset import EvaluationDataset

# Common legacy column spellings -> canonical sample fields.
DEFAULT_COLUMN_MAP: Dict[str, str] = {
    "question": "user_input",
    "answer": "response",
    "contexts": "retrieved_contexts",
    "ground_truth": "reference",
    "ground_truths": "reference",
}


def remap_column_names(
    rows: Sequence[Dict], column_map: Dict[str, str] = None
) -> List[Dict]:
    column_map = {**DEFAULT_COLUMN_MAP, **(column_map or {})}
    out = []
    for row in rows:
        mapped = {}
        for key, value in row.items():
            mapped[column_map.get(key, key)] = value
        out.append(mapped)
    return out


def validate_required_columns(
    dataset: EvaluationDataset, metrics
) -> None:
    """Fail fast when any metric's required columns are missing."""
    features = set(dataset.samples[0].get_features())
    for metric in metrics:
        missing = set(metric.required_columns) - features
        if missing:
            raise ValueError(
                f"Metric {metric.name} requires {sorted(missing)}; dataset "
                f"provides {sorted(features)}"
            )
