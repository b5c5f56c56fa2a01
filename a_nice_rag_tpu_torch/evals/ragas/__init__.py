"""LLM-judged evaluation framework.

Native rebuild of the reference's vendored, domain-modified Ragas fork
(ragas_modified/, SURVEY.md §2.3): dataset schema, bounded async
executor with retry/NaN isolation, structured-output prompt engine with
a JSON repair loop, judge LLM/embedding wrappers, tracing, caching, cost
accounting, and the metric library — with the reference's medical-domain
behavioral modifications preserved (clinical faithfulness prompts,
answer-relevancy strictness 1 + plain-dot-product similarity + the
"No relevant NICE guidelines were found" noncommittal rule).
"""

from a_nice_rag_tpu_torch.evals.ragas.dataset import (  # noqa: F401
    AIMessage,
    EvaluationDataset,
    EvaluationResult,
    HumanMessage,
    Message,
    MultiTurnSample,
    SingleTurnSample,
    ToolCall,
    ToolMessage,
)
from a_nice_rag_tpu_torch.evals.ragas.evaluation import evaluate  # noqa: F401
from a_nice_rag_tpu_torch.evals.ragas.run_config import RunConfig  # noqa: F401
from a_nice_rag_tpu_torch.evals.ragas.llm import (  # noqa: F401
    BaseJudgeLLM,
    FakeJudgeLLM,
    MultimodalJudgeLLM,
    OpenAICompatJudgeLLM,
)
from a_nice_rag_tpu_torch.evals.ragas.embeddings import (  # noqa: F401
    BaseJudgeEmbeddings,
    FakeJudgeEmbeddings,
)
