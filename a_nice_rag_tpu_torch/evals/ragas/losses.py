"""Loss functions for prompt optimization (ragas_modified/losses.py):
objectives the instruction optimizer minimizes between metric outputs
and human labels."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

import numpy as np


class Loss(ABC):
    @abstractmethod
    def __call__(self, predicted: List[float], actual: List[float]) -> float:
        ...


class MSELoss(Loss):
    reduction: str = "mean"

    def __init__(self, reduction: str = "mean"):
        assert reduction in ("mean", "sum")
        self.reduction = reduction

    def __call__(self, predicted, actual):
        err = (np.asarray(predicted) - np.asarray(actual)) ** 2
        return float(err.mean() if self.reduction == "mean" else err.sum())


class BinaryMetricLoss(Loss):
    """0/1 agreement loss (fraction of mismatches)."""

    def __call__(self, predicted, actual):
        p = np.asarray(predicted).round().astype(int)
        a = np.asarray(actual).round().astype(int)
        if p.size == 0:
            return 0.0
        return float((p != a).mean())
