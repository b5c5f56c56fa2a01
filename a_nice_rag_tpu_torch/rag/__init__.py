"""RAG orchestration (L4): query -> retrieve -> prompt -> streamed answer.

Behavioral surface of the reference's ``RAGSystem.query_rag_stream``
(src/query_rag.py:263-527): input validation, hybrid retrieval, WRRF
fusion, rerank, context assembly with source headers, a context-only
medical system prompt, substring-routed LLM streaming, and the
(chunk, sources, raw_sections, sources_data) stream tuple contract.
Counterpart of ``a_nice_rag_tpu.rag``.
"""

from a_nice_rag_tpu_torch.rag.system import RAGSystem  # noqa: F401
from a_nice_rag_tpu_torch.rag.providers import (  # noqa: F401
    ChatClient,
    OpenAICompatClient,
    FakeLLMClient,
    build_default_clients,
    route_model,
)
from a_nice_rag_tpu_torch.rag.prompts import (  # noqa: F401
    build_chat_messages,
    build_context_text,
    clean_section_id,
)
