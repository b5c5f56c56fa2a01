"""Evaluation harnesses (counterpart of ``a_nice_rag_tpu.evals``).

* ``a_nice_rag_tpu_torch.evals.retrieval_eval`` — IR regression gate:
  gold-chunk ranking over synthetic query sets, the reference's 9
  retrieval configurations, MRR/Recall@k metrics, seed-42 split, CSV
  sinks (reference src/retrieval_eval.py).

The JAX package's LLM-judged generation-quality framework (``ragas``)
is not ported yet.
"""

from a_nice_rag_tpu_torch.evals.metrics import calculate_metrics  # noqa: F401
from a_nice_rag_tpu_torch.evals.retrieval_eval import (  # noqa: F401
    EvalConfig,
    RetrievalEvaluator,
    STANDARD_CONFIGURATIONS,
)
