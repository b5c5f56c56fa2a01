"""Third-party framework adapters for the evaluation framework.

Covers the reference's ``ragas_modified/integrations/`` surface
(12 files, SURVEY.md §2.3) with compact equivalents. Converters that
only reshape data (swarm, langgraph, amazon_bedrock, r2r, griptape,
llama_index, langchain's evaluator) are implemented dependency-free via
duck typing — they accept the third-party objects' documented shapes
without importing the packages. Adapters that genuinely require a
third-party client (langsmith upload, opik tracer, helicone proxy
config) are import-gated with actionable errors.
"""

from a_nice_rag_tpu_torch.evals.ragas.integrations.swarm import (  # noqa: F401
    convert_to_ragas_messages as swarm_to_messages,
)
from a_nice_rag_tpu_torch.evals.ragas.integrations.langgraph import (  # noqa: F401
    convert_to_ragas_messages as langgraph_to_messages,
)
from a_nice_rag_tpu_torch.evals.ragas.integrations.r2r import (  # noqa: F401
    transform_to_ragas_dataset,
)
from a_nice_rag_tpu_torch.evals.ragas.integrations.langchain import (  # noqa: F401
    EvaluatorChain,
)
from a_nice_rag_tpu_torch.evals.ragas.integrations.llama_index import (  # noqa: F401
    evaluate_query_engine,
)
from a_nice_rag_tpu_torch.evals.ragas.integrations.griptape import (  # noqa: F401
    rag_context_to_dataset,
)
from a_nice_rag_tpu_torch.evals.ragas.integrations.amazon_bedrock import (  # noqa: F401
    convert_to_ragas_messages as bedrock_to_messages,
)
