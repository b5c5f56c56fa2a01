"""RAGSystem: the serve path (reference call stack SURVEY.md §3.2).

Flow per query: validate -> dense search (weighted models) -> optional
BM25 -> WRRF fuse -> top common_sections_n docs -> optional rerank ->
context assembly + system prompt -> substring-routed LLM streaming,
yielding (chunk, sources_string, raw_sections, sources_data) tuples
(contract of src/query_rag.py:263-527).

Differences from the reference are architectural, not behavioral:
retrieval runs through the array-index engine on the index's device
instead of pandas/NumPy loops, and the index is loaded once from the
artifact directory instead of per-model SQLite files.

Counterpart of ``a_nice_rag_tpu/rag/system.py``; artifacts load onto the
card unless the caller names another device.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from a_nice_rag_tpu_torch.config import Config, InfoSource
from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device
from a_nice_rag_tpu_torch.index import load_index
from a_nice_rag_tpu_torch.index.array_index import ArrayIndex
from a_nice_rag_tpu_torch.rag import prompts
from a_nice_rag_tpu_torch.rag.providers import (
    ChatClient,
    build_default_clients,
    route_model,
)
from a_nice_rag_tpu_torch.retrieval.engine import MODEL_ORDER, SearchEngine
from a_nice_rag_tpu_torch.retrieval.rerank import Reranker
from a_nice_rag_tpu_torch.utils.trace import QueryTrace

logger = logging.getLogger(__name__)


class RAGSystem:
    """End-to-end RAG orchestration over one or more sources.

    ``device`` is where ``_load_from_artifacts`` loads each source's
    index; it is checked to exist even when ``indexes`` are given.
    """

    def __init__(
        self,
        indexes: Optional[Dict[InfoSource, ArrayIndex]] = None,
        embedder=None,
        reranker: Optional[Reranker] = None,
        llm_clients: Optional[Dict[str, ChatClient]] = None,
        embedder_model: Optional[str] = None,
        device: DeviceLike = "cuda",
    ):
        self.config = Config()
        self.device = resolve_device(device)
        self.embedder = embedder
        # The single online embedder serves ONE embedding space; queries
        # for other active dense models must arrive precomputed (the
        # reference's per-model query_embeddings contract,
        # src/query_rag_retrieval.py:149).
        inferred = getattr(embedder, "model", None)
        self.embedder_model = embedder_model or (
            inferred if isinstance(inferred, str) else "voyage-3-large"
        )
        self.reranker = reranker
        self.llm_clients = (
            llm_clients if llm_clients is not None else build_default_clients()
        )
        self.indexes: Dict[InfoSource, ArrayIndex] = {}
        self.engines: Dict[InfoSource, SearchEngine] = {}
        if indexes is not None:
            for source, idx in indexes.items():
                self.attach_index(source, idx)
        else:
            self._load_from_artifacts()

    def attach_index(
        self, source: InfoSource, index: ArrayIndex, engine=None
    ) -> None:
        """``engine`` overrides the default single-chip SearchEngine
        with any object honoring its ``retrieve()`` contract."""
        self.indexes[source] = index
        self.engines[source] = engine or SearchEngine(
            index, embedder=self.embedder, reranker=self.reranker
        )

    def _load_from_artifacts(self) -> None:
        start = time.time()
        for source in InfoSource:
            cfg = self.config.SOURCE_CONFIGS[source]
            try:
                self.attach_index(
                    source, load_index(cfg.index_path, device=self.device))
                logger.info(
                    "Loaded %s index: %d documents",
                    source.value,
                    self.indexes[source].n_docs,
                )
            except Exception as e:  # noqa: BLE001 — degrade per source
                logger.error("Failed to load %s index: %s", source.value, e)
        logger.info("Index loading completed in %.2f seconds", time.time() - start)

    # ------------------------------------------------------------------

    def _validate_inputs(
        self,
        query_text: str,
        similarity_k: int,
        common_sections_n: int,
        info_source: str,
    ) -> None:
        if not query_text or not query_text.strip():
            raise ValueError("Query text cannot be empty")
        if similarity_k <= 0:
            raise ValueError("similarity_k must be a positive integer")
        if common_sections_n <= 0:
            raise ValueError("common_sections_n must be a positive integer")
        try:
            InfoSource(info_source.lower())
        except ValueError:
            valid = [s.value for s in InfoSource]
            raise ValueError(
                f"Invalid info_source '{info_source}'. Must be one of: {valid}"
            )

    def retrieve_for_query(
        self,
        query_text: str,
        source: InfoSource,
        similarity_k: int,
        common_sections_n: int,
        wrrf_k: float,
        model_weights: Dict[str, float],
        filename_type_filter: Optional[str],
        use_hybrid_search: bool,
        use_reranker: bool,
        reranker_model: str,
        reranker_top_k: Optional[int],
        query_embedding=None,
    ) -> List[Dict]:
        """The retrieval sandwich for one query; returns doc dicts.

        ``query_embedding`` is either a Dict[model_name, np.ndarray] of
        per-model query embeddings (the reference's query_embeddings
        contract — models live in different embedding spaces) or, for
        back-compat, a single array valid only when exactly one dense
        model is active.
        """
        engine = self.engines[source]
        index = self.indexes[source]
        active = [
            m for m in MODEL_ORDER
            if m in index.dense_model_names and model_weights.get(m, 0) > 0
        ]
        if (
            query_embedding is not None
            and not isinstance(query_embedding, dict)
            and len(active) > 1
        ):
            raise ValueError(
                "A single query_embedding array cannot serve "
                f"{len(active)} active dense models {active} — they live "
                "in different embedding spaces. Pass a "
                "Dict[model_name, np.ndarray]."
            )
        q_embs: Dict[str, np.ndarray] = {}
        for m in active:
            if isinstance(query_embedding, dict):
                if m in query_embedding:
                    q_embs[m] = np.atleast_2d(
                        np.asarray(query_embedding[m])
                    )
                elif self.embedder is not None and m == self.embedder_model:
                    q_embs[m] = self.embedder.embed_queries([query_text])
                else:
                    logger.warning(
                        "No query embedding for model %s - skipping", m
                    )
            elif query_embedding is not None:
                q_embs[m] = np.atleast_2d(np.asarray(query_embedding))
            elif self.embedder is not None and m == self.embedder_model:
                q_embs[m] = self.embedder.embed_queries([query_text])
            else:
                logger.warning("No embedder for model %s - skipping", m)
        if not q_embs and not use_hybrid_search:
            return []
        if not q_embs:
            # BM25-only path still needs the dict non-empty for validation;
            # retrieve() accepts embeddings dict with no active model.
            q_embs = {"__none__": np.zeros((1, 1), np.float32)}
        docs = engine.retrieve(
            query_embeddings=q_embs,
            query_texts=[query_text],
            similarity_k=similarity_k,
            common_sections_n=common_sections_n,
            wrrf_k=wrrf_k,
            model_weights=model_weights,
            filename_type_filter=filename_type_filter,
            use_hybrid_search=use_hybrid_search,
            use_reranker=use_reranker,
            reranker_model=reranker_model,
            reranker_top_k=reranker_top_k,
            return_docs=True,
        )
        return docs[0]

    def query_rag_stream(
        self,
        query_text: str,
        llm_model: str,
        similarity_k: int = 25,
        common_sections_n: int = 15,
        wrrf_k: float = 40.0,
        info_source: str = "NICE",
        model_weights: Optional[Dict[str, float]] = None,
        filename_type_filter: Optional[str] = None,
        use_hybrid_search: bool = False,
        use_reranker: bool = True,
        reranker_model: str = "rerank-2",
        reranker_top_k: Optional[int] = 10,
        query_embedding=None,  # np.ndarray | Dict[model, np.ndarray]
    ) -> Generator[Tuple[str, str, str, List[Dict]], None, None]:
        """Stream the answer; yields (chunk, sources, raw_sections,
        sources_data) tuples."""
        self._validate_inputs(
            query_text, similarity_k, common_sections_n, info_source
        )
        if model_weights is None:
            model_weights = self.config.DEFAULT_MODEL_WEIGHTS.copy()
        source = InfoSource(info_source.lower())
        trace = QueryTrace()

        if source not in self.engines:
            yield f"Error: No data available for source {info_source}", "", "", []
            return

        try:
            with trace.span("retrieval"):
                docs = self.retrieve_for_query(
                    query_text,
                    source,
                    similarity_k,
                    common_sections_n,
                    wrrf_k,
                    model_weights,
                    filename_type_filter,
                    use_hybrid_search,
                    use_reranker,
                    reranker_model,
                    reranker_top_k,
                    query_embedding=query_embedding,
                )
        except Exception as e:  # noqa: BLE001 — stream an error, don't raise
            logger.error("Error in query processing: %s", e)
            yield f"Error processing query: {e}", "", "", []
            return

        cfg = self.config.SOURCE_CONFIGS[source]
        context_text, raw_sections = prompts.build_context_text(docs)
        messages = prompts.build_chat_messages(
            context_text,
            query_text,
            context_description=cfg.context_description,
        )
        srcs = prompts.sources_string(docs)
        s_data = prompts.sources_data(docs)
        logger.info(
            "Retrieval done in %.4fs, %d sections in context",
            trace.durations.get("retrieval", 0.0),
            len(docs),
        )

        routed = route_model(llm_model, self.llm_clients)
        if routed is None:
            msg = f"Unsupported LLM model or client not available: {llm_model}"
            logger.error(msg)
            yield msg, "", "", []
            return
        client, params = routed

        try:
            with trace.span("llm"):
                for delta in client.stream_chat(llm_model, messages, **params):
                    yield delta, srcs, raw_sections, s_data
        except Exception as e:  # noqa: BLE001
            logger.error("Error in LLM completion: %s", e)
            yield f"Error generating response: {e}", "", "", []
        finally:
            logger.info(
                "LLM completion time: %.4fs", trace.durations.get("llm", 0.0)
            )
            self.last_trace = trace


def main(argv=None) -> None:
    """CLI demo (reference src/query_rag.py:530-581): stream one query
    end to end and print the answer + sources. Uses real providers when
    API keys are set; otherwise answers with the offline fake client."""
    import argparse

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
    )
    p = argparse.ArgumentParser()
    p.add_argument(
        "--query",
        default="What are the recommended interventions for smoking "
        "cessation in adults?",
    )
    p.add_argument("--llm-model", default="gpt-4.1-mini")
    p.add_argument("--filter", default="CG,NG")
    p.add_argument("--hybrid", action="store_true")
    p.add_argument("--no-rerank", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device the index artifacts load onto")
    args = p.parse_args(argv)

    system = RAGSystem(device=args.device)
    if not system.llm_clients:
        from a_nice_rag_tpu_torch.rag.providers import FakeLLMClient

        logger.warning("no provider API keys set; using the offline fake LLM")
        system.llm_clients = {"fake": FakeLLMClient()}
        args.llm_model = "fake-llm"

    print(f"=== Query: {args.query} ===\n")
    sources = ""
    for chunk, sources, _, _ in system.query_rag_stream(
        args.query,
        args.llm_model,
        filename_type_filter=args.filter or None,
        use_hybrid_search=args.hybrid,
        use_reranker=not args.no_rerank,
    ):
        print(chunk, end="", flush=True)
    print("\n\n=== Sources ===")
    print(sources)


if __name__ == "__main__":
    main()
