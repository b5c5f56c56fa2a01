"""HTTP serving API (dependency-free, stdlib http.server).

Counterpart of ``a_nice_rag_tpu/serving/http_api.py``: the retrieval and
RAG surface over the port's ``RAGSystem``.

* ``POST /v1/search``  — {"query": str, ...knobs} -> ranked sections
  (runs the SearchEngine.retrieve pipeline; takes a precomputed
  "query_embedding" for offline-embedding deployments)
* ``POST /v1/rag``     — {"query": str, "llm_model": str, ...} -> full
  answer + sources (non-streaming aggregation of query_rag_stream)
* ``POST /v1/rag/stream`` (or ``/v1/rag`` with ``"stream": true``) —
  Server-Sent Events: one ``sources`` event after retrieval, then a
  ``data: {"delta": ...}`` event per LLM chunk as it is generated,
  terminated by ``data: [DONE]``. Mirrors the reference's incremental
  delta streaming to its UI (reference src/query_rag.py:434-513);
  client disconnects abort the upstream generation (generator close).
* ``POST /v1/embeddings`` — OpenAI-compatible embeddings over the
  deployment's embedder (any object with ``embed_queries``)
* ``POST /v1/feedback`` — thumbs up/down per answer appended to the
  JSON feedback log (reference src/app.py:36-58)
* ``POST /v1/generate`` and ``/v1/chat/completions`` keep their routes
  and answer 400 "no generation server attached": the port has no local
  decoder yet (ROADMAP queue 1, item 8).
* ``GET  /v1/health``  — liveness + index stats; ``GET /v1/stats``
* ``GET  /`` (or ``/ui``) — self-contained browser chat UI
  (serving/webui.py), the reference Streamlit app's surface rendered
  dependency-free against the endpoints above
"""

from __future__ import annotations

import itertools
import json
import logging
import select
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from a_nice_rag_tpu_torch.config import InfoSource

logger = logging.getLogger(__name__)

NO_GENERATION = "no generation server attached"


def _make_handler(api: "ServingAPI"):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            logger.debug(fmt, *args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/health":
                self._reply(200, api.health())
            elif self.path == "/v1/stats":
                self._reply(200, api.stats())
            elif self.path in ("/", "/ui", "/index.html"):
                body = api.ui_page().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "unknown endpoint"})

        def _stream_rag(self, payload: dict) -> None:
            """SSE: flush each LLM delta to the client as it arrives.

            HTTP/1.0 close-delimited body (no Content-Length); a broken
            pipe (client abandoned the stream) closes the upstream
            generator so the LLM call is not run to completion."""
            gen = api.rag_stream(payload)
            # Pull the first tuple BEFORE committing the 200/SSE headers
            # so validation/retrieval errors still surface as clean JSON
            # error responses (the outer handler catches them).
            first = next(gen, None)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def emit(event: Optional[str], data: str) -> None:
                # Small writes into a closed socket land in the OS buffer
                # without error, so a vanished client would otherwise
                # keep the LLM generating. The client sends nothing after
                # the request, so a readable socket means EOF (or RST):
                # peek and abort the stream.
                readable, _, _ = select.select([self.connection], [], [], 0)
                if readable:
                    try:
                        if not self.connection.recv(1, socket.MSG_PEEK):
                            raise BrokenPipeError("SSE client closed")
                    except OSError:
                        raise BrokenPipeError("SSE client reset")
                buf = b""
                if event:
                    buf += f"event: {event}\n".encode("utf-8")
                buf += f"data: {data}\n\n".encode("utf-8")
                self.wfile.write(buf)
                self.wfile.flush()

            sent_sources = False
            try:
                for chunk, _, _, sources_data in itertools.chain(
                    [first] if first is not None else [], gen
                ):
                    if not sent_sources:
                        emit("sources", json.dumps({"sources": sources_data}))
                        sent_sources = True
                    emit(None, json.dumps({"delta": chunk}))
                emit(None, "[DONE]")
            except (BrokenPipeError, ConnectionResetError, OSError):
                logger.debug("SSE client disconnected; aborting generation")
            finally:
                gen.close()

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad JSON: {e}"})
                return
            try:
                if self.path == "/v1/search":
                    self._reply(200, api.search(payload))
                elif self.path == "/v1/rag/stream" or (
                    self.path == "/v1/rag" and payload.get("stream")
                ):
                    self._stream_rag(payload)
                elif self.path == "/v1/rag":
                    self._reply(200, api.rag(payload))
                elif self.path.startswith(("/v1/generate",
                                           "/v1/chat/completions")):
                    raise ValueError(NO_GENERATION)
                elif self.path == "/v1/feedback":
                    self._reply(200, api.feedback(payload))
                elif self.path == "/v1/embeddings":
                    self._reply(200, api.embeddings(payload))
                else:
                    self._reply(404, {"error": "unknown endpoint"})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serving boundary
                logger.exception("request failed")
                self._reply(500, {"error": str(e)})

    return Handler


class ServingAPI:
    def __init__(
        self,
        rag_system,
        info_source: str = "NICE",
        feedback_log=None,
        llm_options=None,
        suggested_queries=None,
        ui_defaults: Optional[dict] = None,
    ):
        self.rag_system = rag_system
        self.info_source = info_source
        self.feedback_log = feedback_log
        self.llm_options = llm_options
        self.suggested_queries = suggested_queries
        self.ui_defaults = ui_defaults

    def ui_page(self) -> str:
        from a_nice_rag_tpu_torch.serving.webui import render_page

        llm_options = self.llm_options
        if llm_options is None and self.rag_system.llm_clients:
            # Surface only models this deployment can actually route
            # (rag/providers.py route_model's provider -> model map).
            by_provider = {
                "openai": ["gpt-4.1-mini", "gpt-4.1-nano", "gpt-4.1", "o4-mini"],
                "gemini": ["gemini-2.5-flash"],
                "openrouter": ["claude-sonnet-4"],
                "fake": ["fake-llm"],
            }
            llm_options = [
                m
                for provider, models in by_provider.items()
                if provider in self.rag_system.llm_clients
                for m in models
            ]
        return render_page(
            llm_options=llm_options,
            suggested_queries=self.suggested_queries,
            defaults=self.ui_defaults,
        )

    def feedback(self, payload: dict) -> dict:
        from a_nice_rag_tpu_torch.serving.feedback import FeedbackLog

        if not payload.get("query") or payload.get("rating") not in (
            "up",
            "down",
        ):
            raise ValueError("'query' and rating in {'up','down'} required")
        if self.feedback_log is None:
            self.feedback_log = FeedbackLog()
        entry = self.feedback_log.record(
            query=payload["query"],
            response=payload.get("response", ""),
            rating=payload["rating"],
            llm_model=payload.get("llm_model"),
            sources=payload.get("sources"),
        )
        return {"status": "recorded", "timestamp": entry["timestamp"]}

    # ------------------------------------------------------------------

    def health(self) -> dict:
        sources = {}
        for source, idx in self.rag_system.indexes.items():
            sources[source.value] = {
                "n_docs": idx.n_docs,
                "dense_models": list(idx.dense_model_names),
                "bm25": idx.bm25 is not None,
            }
        return {"status": "ok", "sources": sources}

    def stats(self) -> dict:
        """Serving counters: the status alone (no generation server)."""
        return {"status": "ok"}

    def search(self, payload: dict) -> dict:
        query = payload.get("query")
        if not query:
            raise ValueError("'query' is required")
        source = InfoSource(payload.get("info_source", self.info_source).lower())
        engine = self.rag_system.engines[source]
        if "query_embedding" in payload:
            q_emb = np.asarray(payload["query_embedding"], np.float32)[None]
        elif self.rag_system.embedder is not None:
            q_emb = self.rag_system.embedder.embed_queries([query])
        else:
            raise ValueError("no embedder configured; pass 'query_embedding'")
        model = payload.get("model", "voyage-3-large")
        docs = engine.retrieve(
            query_embeddings={model: q_emb},
            query_texts=[query],
            similarity_k=int(payload.get("similarity_k", 25)),
            common_sections_n=int(payload.get("common_sections_n", 15)),
            wrrf_k=float(payload.get("wrrf_k", 40.0)),
            model_weights=payload.get("model_weights"),
            filename_type_filter=payload.get("filename_type_filter"),
            use_hybrid_search=bool(payload.get("use_hybrid_search", False)),
            use_reranker=bool(payload.get("use_reranker", False)),
            return_docs=True,
        )[0]
        return {
            "results": [
                {
                    "id": d["id"],
                    "source": d["source"],
                    "url": d.get("url"),
                    "similarity": d.get("similarity"),
                    "rerank_score": d.get("rerank_score"),
                    "document": d["document"],
                }
                for d in docs
            ]
        }

    def rag_stream(self, payload: dict):
        """Validated query_rag_stream generator for the given payload."""
        query = payload.get("query")
        llm_model = payload.get("llm_model", "gpt-4.1-mini")
        if not query:
            raise ValueError("'query' is required")
        return self.rag_system.query_rag_stream(
            query,
            llm_model,
            similarity_k=int(payload.get("similarity_k", 25)),
            common_sections_n=int(payload.get("common_sections_n", 15)),
            model_weights=payload.get("model_weights"),
            use_hybrid_search=bool(payload.get("use_hybrid_search", False)),
            use_reranker=bool(payload.get("use_reranker", True)),
        )

    def rag(self, payload: dict) -> dict:
        chunks = []
        sources_data = []
        for chunk, _, _, sources_data in self.rag_stream(payload):
            chunks.append(chunk)
        return {"answer": "".join(chunks), "sources": sources_data}

    def embeddings(self, payload: dict) -> dict:
        """OpenAI-compatible embeddings endpoint over the deployment's
        embedder: the serving form of the hop the reference outsources to
        the Voyage/OpenAI embedding APIs (reference
        src/search_engine.py:148). ``input`` is one string or a list;
        vectors are float32 rows from ``embedder.embed_queries`` (the
        path /v1/search uses, so retrieval with client-side embeddings
        is consistent)."""
        if self.rag_system is None or self.rag_system.embedder is None:
            raise ValueError("no embedder configured")
        raw = payload.get("input")
        if raw is None or raw == [] or raw == "":
            raise ValueError("'input' is required")
        texts = [raw] if isinstance(raw, str) else [str(t) for t in raw]
        embs = np.asarray(
            self.rag_system.embedder.embed_queries(texts), np.float32
        )
        return {
            "object": "list",
            "model": payload.get("model", "local"),
            "data": [
                {
                    "object": "embedding",
                    "index": i,
                    "embedding": embs[i].tolist(),
                }
                for i in range(len(texts))
            ],
            "usage": {
                "prompt_tokens": sum(len(t.split()) for t in texts),
                "total_tokens": sum(len(t.split()) for t in texts),
            },
        }


def render_chat_messages(messages) -> str:
    """Chat messages -> a completion prompt in the plain role-prefix
    template (the JAX package's for a tokenizer without ChatML markers).
    Raises ValueError on a malformed list."""
    if not isinstance(messages, list) or not messages:
        raise ValueError("'messages' must be a non-empty list")
    for m in messages:
        if not isinstance(m, dict) or "content" not in m:
            raise ValueError("each message needs 'role' and 'content'")
    return "\n\n".join(
        f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages
    ) + "\n\nassistant: "


def serve(
    rag_system,
    host: str = "127.0.0.1",
    port: int = 8800,
    background: bool = False,
    feedback_log=None,
    llm_options=None,
) -> Optional[ThreadingHTTPServer]:
    """Start the HTTP API; returns the server when ``background``."""
    api = ServingAPI(
        rag_system, feedback_log=feedback_log, llm_options=llm_options,
    )
    server = ThreadingHTTPServer((host, port), _make_handler(api))
    if background:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server
    logger.info("serving on http://%s:%d", host, port)
    server.serve_forever()
    return None
