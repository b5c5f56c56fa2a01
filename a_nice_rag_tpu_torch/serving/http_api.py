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
* ``POST /v1/generate`` (``/v1/generate/stream`` or ``"stream": true``
  for SSE) — raw LM completion over the continuous-batching
  GenerationServer (serving/genserver.py): concurrent requests share one
  batched decode on the device. 429 when its pending queue is full.
* ``POST /v1/chat/completions`` — OpenAI chat API over the same
  GenerationServer (``"stream": true`` for ``chat.completion.chunk``
  SSE; ``response_format`` JSON modes through guided decoding).
  Wire-compatible with ``rag/providers.OpenAICompatClient``. Both answer
  400 "no generation server attached" when none is.
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
from a_nice_rag_tpu_torch.serving.genserver import ServerBusy

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

        def _stream_chat(self, payload: dict) -> None:
            """SSE in the OpenAI chat.completion.chunk shape: a role
            prelude chunk, one content-delta chunk per decoded piece, a
            finish_reason chunk, then ``data: [DONE]``."""
            gen = api.chat_stream(payload)
            first = next(gen, None)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for chunk in itertools.chain(
                    [first] if first is not None else [], gen
                ):
                    readable, _, _ = select.select(
                        [self.connection], [], [], 0
                    )
                    if readable and not self.connection.recv(
                        1, socket.MSG_PEEK
                    ):
                        raise BrokenPipeError("SSE client closed")
                    self.wfile.write(
                        f"data: {json.dumps(chunk)}\n\n".encode("utf-8")
                    )
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                logger.debug("SSE client disconnected; dropping stream")
            finally:
                gen.close()

        def _stream_gen(self, payload: dict) -> None:
            """SSE for raw LM completion (/v1/generate stream mode):
            one {"delta": ...} event per decoded text piece."""
            gen = api.generate_stream(payload)
            first = next(gen, None)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for piece in itertools.chain(
                    [first] if first is not None else [], gen
                ):
                    readable, _, _ = select.select(
                        [self.connection], [], [], 0
                    )
                    if readable and not self.connection.recv(
                        1, socket.MSG_PEEK
                    ):
                        raise BrokenPipeError("SSE client closed")
                    self.wfile.write(
                        f"data: {json.dumps({'delta': piece})}\n\n"
                        .encode("utf-8")
                    )
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                logger.debug("SSE client disconnected; dropping stream")
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
                elif self.path == "/v1/generate/stream" or (
                    self.path == "/v1/generate" and payload.get("stream")
                ):
                    self._stream_gen(payload)
                elif self.path == "/v1/generate":
                    self._reply(200, api.generate(payload))
                elif self.path == "/v1/chat/completions" and payload.get(
                    "stream"
                ):
                    self._stream_chat(payload)
                elif self.path == "/v1/chat/completions":
                    self._reply(200, api.chat(payload))
                elif self.path == "/v1/feedback":
                    self._reply(200, api.feedback(payload))
                elif self.path == "/v1/embeddings":
                    self._reply(200, api.embeddings(payload))
                else:
                    self._reply(404, {"error": "unknown endpoint"})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except ServerBusy as e:
                self._reply(429, {"error": str(e)})
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
        gen_server=None,
        tokenizer=None,
    ):
        self.rag_system = rag_system
        self.info_source = info_source
        self.feedback_log = feedback_log
        self.llm_options = llm_options
        self.suggested_queries = suggested_queries
        self.ui_defaults = ui_defaults
        # Optional serving.genserver.GenerationServer: the generation
        # endpoints (/v1/generate, /v1/chat/completions).
        self.gen_server = gen_server
        # Tokenizer for the generation endpoints: the demo byte tokenizer
        # by default; a real checkpoint's models/hf_tokenizer.HFTokenizer
        # when one is mounted (serve_cli --llm-ckpt).
        self.tokenizer = tokenizer

    def _tok(self):
        if self.tokenizer is None:
            from a_nice_rag_tpu_torch.models.decoder import ByteTokenizer

            self.tokenizer = ByteTokenizer()
        return self.tokenizer

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
        """Serving counters: the generation server's slot/queue/token
        totals (genserver.stats()) when one is mounted, else the status
        alone."""
        out = {"status": "ok"}
        if self.gen_server is not None:
            out["generation"] = self.gen_server.stats()
        return out

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


    def generate_stream(self, payload: dict):
        """Raw LM completion through the continuous-batching server:
        concurrent requests share one batched decode program."""
        if self.gen_server is None:
            raise ValueError(NO_GENERATION)
        prompt = payload.get("prompt")
        if not prompt:
            raise ValueError("'prompt' is required")
        kw = {}
        if payload.get("temperature") is not None:
            kw["temperature"] = float(payload["temperature"])
        if payload.get("top_k") is not None:
            kw["top_k"] = int(payload["top_k"])
        if payload.get("top_p") is not None:
            kw["top_p"] = float(payload["top_p"])
        stop = payload.get("stop")
        if stop:
            kw["stop"] = [stop] if isinstance(stop, str) else [
                str(s) for s in stop
            ]
        if payload.get("stop_token_ids"):
            kw["stop_token_ids"] = [
                int(i) for i in payload["stop_token_ids"]
            ]
        con = self._constraint_name(payload)
        if con is not None:
            kw["constraint"] = con
        return self.gen_server.stream_text(
            str(prompt),
            max_new_tokens=int(payload.get("max_tokens", 64)),
            tokenizer=self.tokenizer,
            **kw,
        )

    @staticmethod
    def _constraint_name(payload: dict):
        """Guided decoding: ``"constraint": "<registered name>"``, or
        the OpenAI-style ``"response_format": {"type": "json_object"}``
        alias (requires a constraint of that name to be registered on
        the server — serve_cli --json-mode does so)."""
        con = payload.get("constraint")
        rf = payload.get("response_format")
        if con is None and isinstance(rf, dict):
            t = rf.get("type")
            if t in ("json_object", "json_array", "json"):
                con = t
        return str(con) if con is not None else None

    def generate(self, payload: dict) -> dict:
        if not payload.get("logprobs"):
            return {"text": "".join(self.generate_stream(payload))}
        # Token-level response: text + tokens + per-token logprobs +
        # finish_reason (string 'stop' sequences are text-level and do
        # not compose with token-level accounting).
        if self.gen_server is None:
            raise ValueError(NO_GENERATION)
        if payload.get("stop"):
            raise ValueError(
                "'logprobs' does not compose with string 'stop' "
                "sequences; use 'stop_token_ids'"
            )
        prompt = payload.get("prompt")
        if not prompt:
            raise ValueError("'prompt' is required")
        kw = {}
        for key, cast in (("temperature", float), ("top_k", int),
                          ("top_p", float)):
            if payload.get(key) is not None:
                kw[key] = cast(payload[key])
        if payload.get("stop_token_ids"):
            kw["stop_token_ids"] = [
                int(i) for i in payload["stop_token_ids"]
            ]
        con = self._constraint_name(payload)
        if con is not None:
            kw["constraint"] = con
        n_top = int(payload.get("top_logprobs", 0) or 0)
        if n_top and not self.gen_server.lp_k:
            raise ValueError(
                "'top_logprobs' requires a server built with "
                "logprob_topk=K (serve_cli --logprob-topk)"
            )
        tok = self._tok()
        out = self.gen_server.complete(
            tok.encode(str(prompt)),
            max_new_tokens=int(payload.get("max_tokens", 64)), **kw,
        )
        dec = tok.stream_decoder()
        text = "".join(filter(None, map(dec.feed, out["tokens"])))
        text += dec.flush()
        resp = {"text": text, "tokens": out["tokens"],
                "token_logprobs": out["logprobs"],
                "finish_reason": out["finish_reason"]}
        if n_top:
            resp["top_logprobs"] = [
                [{"token": int(t), "logprob": float(v)}
                 for t, v in pairs[:n_top]]
                for pairs in out.get("top_logprobs", [])
            ]
        return resp

    # -- OpenAI chat API over the generation server ---------------------

    _chat_ids = itertools.count(1)

    def _chat_request(self, payload: dict):
        """Validate an OpenAI chat payload -> (prompt, model, max_new,
        submit kwargs). Supported params: temperature, top_p,
        max_tokens / max_completion_tokens, stop (string or list),
        response_format json modes (guided decoding via the server's
        constraint registry)."""
        if self.gen_server is None:
            raise ValueError(NO_GENERATION)
        prompt = render_chat_messages(
            payload.get("messages"), tokenizer=self._tok()
        )
        model = str(payload.get("model", "local"))
        max_new = int(
            payload.get("max_completion_tokens")
            or payload.get("max_tokens")
            or 64
        )
        kw = {}
        if payload.get("temperature") is not None:
            kw["temperature"] = float(payload["temperature"])
        if payload.get("top_p") is not None:
            kw["top_p"] = float(payload["top_p"])
        stop = payload.get("stop")
        if stop:
            kw["stop"] = [stop] if isinstance(stop, str) else [
                str(s) for s in stop
            ]
        con = self._constraint_name(payload)
        if con is not None:
            kw["constraint"] = con
        return prompt, model, max_new, kw

    def _chat_meta(self, model: str) -> dict:
        import time as _time

        return {
            "id": f"chatcmpl-local-{next(self._chat_ids)}",
            "created": int(_time.time()),
            "model": model,
        }

    def chat(self, payload: dict) -> dict:
        """Non-streaming /v1/chat/completions. Without string stop
        sequences this runs the token-level complete() path (true
        finish_reason + exact usage counts); with them it aggregates the
        text stream (the stop cut is text-level)."""
        prompt, model, max_new, kw = self._chat_request(payload)
        tok = self._tok()
        if "stop" in kw:
            info: dict = {}
            text = "".join(
                self.gen_server.stream_text(
                    prompt, max_new_tokens=max_new, tokenizer=tok,
                    info=info, **kw
                )
            )
            finish = info.get("finish_reason")
            finish = finish if finish in ("stop", "length") else "stop"
            n_out = len(tok.encode(text, add_bos=False))
        else:
            out = self.gen_server.complete(
                tok.encode(prompt), max_new_tokens=max_new, **kw
            )
            dec = tok.stream_decoder()
            text = "".join(filter(None, map(dec.feed, out["tokens"])))
            text += dec.flush()
            finish, n_out = out["finish_reason"], len(out["tokens"])
        n_in = len(tok.encode(prompt))
        return {
            **self._chat_meta(model),
            "object": "chat.completion",
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish,
            }],
            "usage": {
                "prompt_tokens": n_in,
                "completion_tokens": n_out,
                "total_tokens": n_in + n_out,
            },
        }

    def chat_stream(self, payload: dict):
        """Streaming /v1/chat/completions: yields chat.completion.chunk
        dicts (role prelude, one content delta per decoded piece, then a
        finish_reason chunk)."""
        prompt, model, max_new, kw = self._chat_request(payload)
        meta = {**self._chat_meta(model), "object": "chat.completion.chunk"}

        def _chunk(delta: dict, finish=None) -> dict:
            return {
                **meta,
                "choices": [{
                    "index": 0, "delta": delta, "finish_reason": finish,
                }],
            }

        info: dict = {}
        gen = self.gen_server.stream_text(
            prompt, max_new_tokens=max_new, tokenizer=self.tokenizer,
            info=info, **kw
        )
        try:
            # Force the submit (and its validation — prompt length,
            # unknown constraint, backpressure) BEFORE the first chunk
            # is yielded, so the HTTP layer can still answer 400/429
            # instead of a committed-200 SSE stream that dies silently.
            first = next(gen, None)
            yield _chunk({"role": "assistant", "content": ""})
            if first is not None:
                yield _chunk({"content": first})
            for piece in gen:
                yield _chunk({"content": piece})
            # OpenAI clients detect truncation via finish_reason ==
            # "length"; surface the request's real reason.
            finish = info.get("finish_reason")
            yield _chunk(
                {}, finish=finish if finish in ("stop", "length")
                else "stop"
            )
        finally:
            gen.close()


def render_chat_messages(messages, tokenizer=None) -> str:
    """Chat messages -> a completion prompt. With a tokenizer that carries
    the ChatML markers as specials (a real instruct checkpoint), renders
    ChatML so the turn structure encodes onto the ids the weights were
    trained on; otherwise the plain role-prefix template
    rag/providers.LocalTpuLLMClient uses for demo weights. Raises
    ValueError on a malformed list."""
    if not isinstance(messages, list) or not messages:
        raise ValueError("'messages' must be a non-empty list")
    for m in messages:
        if not isinstance(m, dict) or "content" not in m:
            raise ValueError("each message needs 'role' and 'content'")
    if tokenizer is not None:
        from a_nice_rag_tpu_torch.models.hf_tokenizer import (
            render_chatml,
            supports_chatml,
        )

        if supports_chatml(tokenizer):
            return render_chatml(messages)
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
    gen_server=None,
    tokenizer=None,
) -> Optional[ThreadingHTTPServer]:
    """Start the HTTP API; returns the server when ``background``."""
    api = ServingAPI(
        rag_system, feedback_log=feedback_log, llm_options=llm_options,
        gen_server=gen_server, tokenizer=tokenizer,
    )
    server = ThreadingHTTPServer((host, port), _make_handler(api))
    if background:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server
    logger.info("serving on http://%s:%d", host, port)
    server.serve_forever()
    return None
