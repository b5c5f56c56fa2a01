"""Metric library (reference ragas_modified/metrics surface)."""

from a_nice_rag_tpu_torch.evals.ragas.metrics.base import (  # noqa: F401
    Ensembler,
    Metric,
    MetricWithEmbeddings,
    MetricWithLLM,
    MultiTurnMetric,
    SingleTurnMetric,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.faithfulness import Faithfulness  # noqa: F401
from a_nice_rag_tpu_torch.evals.ragas.metrics.answer_relevance import (  # noqa: F401
    AnswerRelevancy,
    ResponseRelevancy,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.context_precision import (  # noqa: F401
    ContextPrecision,
    ContextUtilization,
    LLMContextPrecisionWithReference,
    LLMContextPrecisionWithoutReference,
    NonLLMContextPrecisionWithReference,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.context_recall import (  # noqa: F401
    ContextRecall,
    LLMContextRecall,
    NonLLMContextRecall,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.string_metrics import (  # noqa: F401
    BleuScore,
    ExactMatch,
    NonLLMStringSimilarity,
    RougeScore,
    StringPresence,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.semantic_similarity import (  # noqa: F401
    SemanticSimilarity,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.aspect_critic import AspectCritic  # noqa: F401
from a_nice_rag_tpu_torch.evals.ragas.metrics.rubrics import (  # noqa: F401
    RubricsScore,
    SimpleCriteriaScore,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.answer_correctness import (  # noqa: F401
    AnswerCorrectness,
    FactualCorrectness,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.entities_noise import (  # noqa: F401
    ContextEntityRecall,
    NoiseSensitivity,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.nv_metrics import (  # noqa: F401
    AnswerAccuracy,
    ContextRelevance,
    ResponseGroundedness,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.agentic import (  # noqa: F401
    AgentGoalAccuracyWithReference,
    AgentGoalAccuracyWithoutReference,
    ToolCallAccuracy,
    TopicAdherenceScore,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.summarization import (  # noqa: F401
    SummarizationScore,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.misc import (  # noqa: F401
    DataCompyScore,
    InstanceRubrics,
    LLMSQLEquivalence,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.semantic_similarity import (  # noqa: F401
    AnswerSimilarity,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics.multimodal import (  # noqa: F401
    FaithfulnesswithHHEM,
    MultiModalFaithfulness,
    MultiModalRelevance,
)
