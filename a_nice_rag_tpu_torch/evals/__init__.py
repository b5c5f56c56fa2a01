"""Evaluation harnesses (counterpart of ``a_nice_rag_tpu.evals``).

* ``a_nice_rag_tpu_torch.evals.retrieval_eval`` — IR regression gate:
  gold-chunk ranking over synthetic query sets, the reference's 9
  retrieval configurations, MRR/Recall@k metrics, seed-42 split, CSV
  sinks (reference src/retrieval_eval.py).
* ``a_nice_rag_tpu_torch.evals.ragas`` — LLM-judged generation-quality
  framework (the reference's vendored ragas_modified, rebuilt), on a
  pydantic-free model base (``ragas/_model.py``); ``run_ragas_eval`` and
  ``question_gen`` are its runner and synthetic-query generator.
"""

from a_nice_rag_tpu_torch.evals.metrics import calculate_metrics  # noqa: F401
from a_nice_rag_tpu_torch.evals.retrieval_eval import (  # noqa: F401
    EvalConfig,
    RetrievalEvaluator,
    STANDARD_CONFIGURATIONS,
)
