"""evaluate(): the framework entrypoint.

Reference semantics (ragas_modified/evaluation.py:57-333): inject the
judge LLM/embeddings into metrics that need them, initialize each metric
with the run config, submit one async job per (sample, metric) to the
bounded executor, and collect ordered scores into an EvaluationResult.
Per-job failures become NaN unless raise_exceptions=True.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from a_nice_rag_tpu_torch.evals.ragas.dataset import (
    EvaluationDataset,
    EvaluationResult,
)
from a_nice_rag_tpu_torch.evals.ragas.executor import Executor
from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (
    Metric,
    MetricWithEmbeddings,
    MetricWithLLM,
    MultiTurnMetric,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.run_config import RunConfig
from a_nice_rag_tpu_torch.utils.trace import QueryTrace

logger = logging.getLogger(__name__)


def evaluate(
    dataset: EvaluationDataset,
    metrics: Sequence[Metric],
    llm=None,
    embeddings=None,
    run_config: Optional[RunConfig] = None,
    batch_size: Optional[int] = None,
    raise_exceptions: bool = False,
    show_progress: bool = True,
) -> EvaluationResult:
    if dataset is None or len(dataset) == 0:
        raise ValueError("Provide a non-empty dataset")
    run_config = run_config or RunConfig()

    # Inject judge models into metrics lacking them, then init.
    injected = []
    for metric in metrics:
        if isinstance(metric, MetricWithLLM) and metric.llm is None:
            metric.llm = llm
            injected.append((metric, "llm"))
        if (
            isinstance(metric, MetricWithEmbeddings)
            and metric.embeddings is None
        ):
            metric.embeddings = embeddings
            injected.append((metric, "embeddings"))
        metric.init(run_config)

    executor = Executor(
        desc="Evaluating",
        raise_exceptions=raise_exceptions,
        run_config=run_config,
        show_progress=show_progress,
        batch_size=batch_size,
    )
    trace = QueryTrace()
    multi = dataset.is_multi_turn()
    for sample in dataset.samples:
        for metric in metrics:
            if multi:
                if not isinstance(metric, MultiTurnMetric):
                    raise ValueError(
                        f"{metric.name} is not a multi-turn metric but the "
                        "dataset holds MultiTurnSamples"
                    )
                executor.submit(metric.multi_turn_ascore, sample)
            else:
                if not isinstance(metric, SingleTurnMetric):
                    raise ValueError(
                        f"{metric.name} is not a single-turn metric but "
                        "the dataset holds SingleTurnSamples"
                    )
                executor.submit(metric.single_turn_ascore, sample)

    with trace.span("run"):
        flat = executor.results()

    # Un-inject so metric objects can be reused with other judges.
    for metric, attr in injected:
        setattr(metric, attr, None)

    n_metrics = len(metrics)
    scores = [
        {
            metrics[m].name: flat[s * n_metrics + m]
            for m in range(n_metrics)
        }
        for s in range(len(dataset))
    ]
    return EvaluationResult(
        scores=scores, dataset=dataset, traces=[dict(trace.durations)]
    )
