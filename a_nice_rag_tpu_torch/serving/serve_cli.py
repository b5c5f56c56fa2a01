"""One-command serving: index -> scheduler -> HTTP (and the native front).

Counterpart of ``a_nice_rag_tpu/serving/serve_cli.py``. Wires the serving
stack end to end:

* an index artifact (or a synthetic demo corpus) loaded once, on the card
  unless ``--device cpu``;
* a single-device ``FusedRetriever``, its K1 plan optionally tuned on the
  card (``--autotune``), or with ``--shards N`` a ``ShardedRetriever`` over
  an N-slot corpus mesh guarded by a ``DeviceHealthMonitor`` that reshards
  over survivors and swaps the retriever and its pool live;
* a ``SchedulerPool`` micro-batching every configuration;
* the stdlib HTTP surface: ``/v1/search`` (scheduler-batched; a single
  JSON query or a base64 batch in f32 or bf16; HTTP/1.1, a client's
  connection kept), ``/v1/stats`` (scheduler counters + health events),
  ``/v1/health``;
* with ``--native-port``, the binary C++ front beside it.

With ``--embedder hashing``, ``/v1/search`` also takes raw text: the
hashing encoder (``models.OnDeviceEmbedder``) embeds each text request on
the index's device and the index's BM25 vocabulary gives its terms; its
weights are seeded random unless ``--embedder-ckpt`` names a checkpoint
of ``models.trainer.train_encoder`` (the port's format). With ``--llm
local`` the on-device decoder LM is attached on the index's device
(``build_local_llm_api``): ``/v1/rag`` (+SSE) answers from it through a
continuous-batching ``GenerationServer``, and ``/v1/generate`` and
``/v1/chat/completions`` serve it, with JSON guided decoding under
``--json-mode``; ``--lm-tp N`` serves it tensor-parallel over the first N
cards (N slots of the CPU under ``--device cpu``). ``--rounded-fold``
(or ``--pallas-rounded``, the JAX CLI's name for it) serves the one-device
route's dense lists on the rounded fold (K1r / K2r, the JAX CLI's packed
fold: top-k on bf16-rounded scores), or with ``--autotune`` adds its plans
to the tuner's candidates; the sharded route stays on the exact fold, as
in the JAX CLI.

Usage:
    python -m a_nice_rag_tpu_torch.serving.serve_cli --index artifacts/nice \
        [--port 8800] [--autotune] [--rounded-fold] [--shards 4] \
        [--device cuda] \
        [--embedder hashing [--embedder-ckpt DIR]]
        [--llm local [--llm-ckpt DIR] [--json-mode] [--lm-tp N]]
    python -m a_nice_rag_tpu_torch.serving.serve_cli --demo
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.serving.scheduler import (
    DEFAULT_MAX_BATCH,
    SchedulerPool,
)

logger = logging.getLogger(__name__)


class ServeState:
    """Mutable serving state; the health monitor swaps retrievers."""

    def __init__(self, index, retriever, pool, monitor=None, t_max=16,
                 embedder=None):
        self.index = index
        self.retriever = retriever
        self.pool = pool
        self.monitor = monitor
        self.t_max = t_max
        # Optional query embedder (``embed_queries``; models.embedder's
        # on-device one with --embedder): lets /v1/search take raw text.
        self.embedder = embedder
        self.loop: Optional[asyncio.AbstractEventLoop] = None

    def encode_text_query(self, text: str):
        """Raw text -> (query embedding [D] f32, padded term ids [t_max]
        i32) via the embedder + the index's BM25 vocabulary (the corpus
        side's preprocessing)."""
        if self.embedder is None:
            raise ValueError(
                "server has no embedder; pass 'query_embedding' or "
                "start with --embedder"
            )
        from a_nice_rag_tpu_torch.text.preprocess import preprocess_text

        q_vec = np.asarray(
            self.embedder.embed_queries([text]), np.float32
        )[0]
        toks = preprocess_text(text, use_lemmatization=True)
        terms = self.index.pad_term_ids([toks], self.t_max)[0]
        return q_vec, terms

    def submit_sync(self, q_emb: Dict[str, np.ndarray], q_terms, weights,
                    filt, wrrf_k, timeout_s: float = 30.0):
        fut = self.pool.submit_threadsafe(
            self.loop, q_emb, q_terms, weights=weights,
            filename_type_filter=filt, wrrf_k=wrrf_k)
        return fut.result(timeout=timeout_s)

    def submit_batch_sync(self, model: str, q_mat: np.ndarray, terms,
                          weights, filt, wrrf_k,
                          timeout_s: float = 60.0):
        """Submit a CLIENT-SIDE batch: the row block rides one scheduler
        entry + one future (BatchScheduler.submit_many) and still
        coalesces with other pending traffic up to max_batch rows.
        ``q_mat``: f32 rows, or bf16 bits as uint16, which the scheduler
        uploads at half width. Returns (rows [B, n], scores [B, n])."""
        q_arr = np.asarray(q_mat)
        if q_arr.dtype != np.uint16:
            q_arr = q_arr.astype(np.float32, copy=False)
        fut = self.pool.submit_threadsafe(
            self.loop, {model: q_arr},
            None if terms is None else np.asarray(terms, np.int32),
            weights=weights, filename_type_filter=filt, wrrf_k=wrrf_k,
            batched=True)
        rows, scores = fut.result(timeout=timeout_s)
        return np.asarray(rows), np.asarray(scores)


def _load_kernels(retriever, ivf: bool) -> None:
    """Build and bind the kernel libraries of the retriever's route now,
    so no served request pays for a compile and no two dispatch threads
    build one at once."""
    from a_nice_rag_tpu_torch.ops.kernels import _build, fused_topk, ivf_topk

    names = ["fused_topk"] + (["ivf_topk"] if ivf else [])
    _build.load_all(names)
    fused_topk._library()
    if ivf:
        ivf_topk._library()


def build_state(
    index,
    model_names,
    use_bm25: bool = True,
    autotune: bool = False,
    shards: int = 0,
    two_tier_common: int = 0,
    scheduler_kwargs: Optional[Dict] = None,
    nprobe: int = 0,
    ivf_clusters: Optional[int] = None,
    ivf_cache: Optional[str] = None,
    ivf_spill: bool = False,
    embedder=None,
    ivf_max_coverage: float = 0.25,
    devices: Optional[Sequence] = None,
    similarity_k: int = 25,
    common_sections_n: int = 15,
    budget: int = 16384,
    rounded_fold: bool = False,
) -> ServeState:
    """Serve ``index`` on its device. ``nprobe > 0`` serves the flagship
    model through the IVF ANN route (building the IVF layout at startup
    if the index does not carry one); filtered queries take the exact
    scan. ``ivf_spill`` stores boundary documents in their two nearest
    clusters on both routes. ``ivf_max_coverage``: the auto routing
    threshold (batches whose expected cluster coverage 1-(1-p/C)^B
    exceeds it take the exact stream).

    ``shards > 1`` lays a corpus mesh over ``devices`` (slots; repeat a
    device for a virtual mesh: ``["cpu"] * 4``, ``[cuda:0] * 4``); with no
    devices it takes the first ``shards`` cards and raises without a GPU.
    ``autotune`` tunes K1's plan on the card for a float flagship matrix
    (``ops.kernels.autotune``) at the scheduler's widest batch; int8
    matrices keep K2's plan. ``rounded_fold`` serves the one-device
    route's dense lists on the rounded fold (``KernelConfig(rounded=True)``:
    K1r / K2r for maskless calls over N % 1024 == 0 rows); with
    ``autotune`` on the card it adds the rounded plans to the tuner's
    candidates instead (``allow_rounded``), as the JAX CLI's flag does.
    The sharded route stays on the exact fold, as in the JAX CLI
    (``ShardedRetriever(kernel_config=KernelConfig(rounded=True))`` takes
    the rounded fold on every shard). On CUDA the route's kernel libraries
    are built before this returns."""
    from a_nice_rag_tpu_torch.ops.kernels.autotune import (
        KernelConfig,
        tune_fused_blocks,
    )

    monitor = None
    retr_kw = dict(use_bm25=use_bm25, similarity_k=similarity_k,
                   common_sections_n=common_sections_n, budget=budget,
                   nprobe=nprobe or None, ivf_max_coverage=ivf_max_coverage)
    if shards > 1:
        from a_nice_rag_tpu_torch.parallel import (
            DeviceHealthMonitor,
            ShardedRetriever,
            load_shard_ivf,
            make_mesh,
            save_shard_ivf,
            shard_index,
            shard_ivf,
        )

        if devices is None:
            require_cuda()
            devices = [f"cuda:{i}" for i in
                       range(min(shards, torch.cuda.device_count()))]
        mesh = make_mesh(shape=(1, len(devices)),
                         axis_names=("dp", "corpus"), devices=devices)
        sidx = shard_index(index, mesh, two_tier_common=two_tier_common)
        if nprobe > 0:
            sidx2 = None
            if ivf_cache and os.path.exists(ivf_cache):
                try:
                    sidx2 = load_shard_ivf(sidx, ivf_cache)
                    logger.info("serve: IVF layout loaded from %s",
                                ivf_cache)
                except ValueError as e:
                    logger.warning("serve: IVF cache unusable (%s); "
                                   "rebuilding", e)
            if sidx2 is None:
                sidx2 = shard_ivf(sidx, model_names[0],
                                  n_clusters=ivf_clusters, spill=ivf_spill)
                logger.info("serve: per-shard IVF built (%d clusters a "
                            "shard)", sidx2.ivf_n_clusters)
                if ivf_cache:
                    save_shard_ivf(sidx2, ivf_cache)
            sidx = sidx2

        def make_retriever(s):
            return ShardedRetriever(s, model_names, **retr_kw)

        if rounded_fold:
            logger.warning("serve: the sharded route stays on the exact "
                           "fold; the rounded fold serves one device")

        retriever = make_retriever(sidx)
        state = ServeState(index, retriever, None)

        def rebuild(new_sidx):
            state.retriever = make_retriever(new_sidx)
            old_pool = state.pool
            state.pool = SchedulerPool(state.retriever,
                                       **(scheduler_kwargs or {}))
            # Stop the replaced pool's scheduler loops: abandoning them
            # leaks pending asyncio tasks on the serving loop.
            if old_pool is not None and state.loop is not None:
                try:
                    asyncio.run_coroutine_threadsafe(
                        old_pool.stop(), state.loop
                    ).result(timeout=10)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    logger.exception("serve: stopping the old pool failed")
            logger.warning("serve: retriever rebuilt over %d shards",
                           new_sidx.n_shards)

        monitor = DeviceHealthMonitor(sidx, rebuild=rebuild)
        state.monitor = monitor
        on_cuda = sidx.lead.type == "cuda"
    else:
        from a_nice_rag_tpu_torch.index.ivf import attach_ivf
        from a_nice_rag_tpu_torch.retrieval import FusedRetriever

        if nprobe > 0 and (index.ivf or {}).get(model_names[0]) is None:
            attach_ivf(index, model_names[0], n_clusters=ivf_clusters,
                       spill=ivf_spill)
            logger.info("serve: IVF built for %s (%d clusters)",
                        model_names[0],
                        index.ivf[model_names[0]].n_clusters)
        kernel_config = KernelConfig(rounded=True) if rounded_fold else None
        m0 = index.dense.get(model_names[0]) if model_names else None
        if autotune and m0 is not None and m0.device.type == "cuda":
            # Random probe queries: an all-zero probe makes every score
            # tie, and the tuner's id-parity guard would then reject
            # every candidate for tie-order differences. Tuned at the
            # scheduler's widest batch, the saturated traffic's.
            probe_b = (scheduler_kwargs or {}).get("max_batch",
                                                   DEFAULT_MAX_BATCH)
            g = torch.Generator(device=m0.device).manual_seed(0)
            q_probe = torch.randn((probe_b, m0.shape[1]), generator=g,
                                  device=m0.device)
            kernel_config = tune_fused_blocks(
                m0, q_probe, min(similarity_k, index.n_docs),
                allow_rounded=rounded_fold)
            logger.info("serve: autotuned K1 plan %s", kernel_config)
        elif rounded_fold:
            logger.info("serve: rounded fold (K1r / K2r) on the dense "
                        "lists")
        retriever = FusedRetriever(index, model_names,
                                   kernel_config=kernel_config, **retr_kw)
        state = ServeState(index, retriever, None)
        on_cuda = index.device.type == "cuda"
    if on_cuda and state.retriever.use_kernel:
        _load_kernels(state.retriever, ivf=nprobe > 0)
    state.pool = SchedulerPool(state.retriever, **(scheduler_kwargs or {}))
    state.embedder = embedder
    return state


def decode_b64_batch(payload: dict):
    """The batched RPC form of /v1/search: (rows, terms or None). Rows
    are f32, or (``"dtype": "bf16"``) bf16 bits as uint16; raises
    ValueError on another dtype."""
    dtype_s = payload.get("dtype", "f32")
    if dtype_s not in ("f32", "bf16"):
        raise ValueError(f"dtype must be 'f32' or 'bf16', got {dtype_s!r}")
    q_mat = np.frombuffer(
        base64.b64decode(payload["query_embeddings_b64"]),
        np.uint16 if dtype_s == "bf16" else np.float32,
    ).reshape(payload["shape"])
    terms = None
    if payload.get("terms_b64"):
        terms = np.frombuffer(base64.b64decode(payload["terms_b64"]),
                              np.int32).reshape(payload["terms_shape"])
    return q_mat, terms


def _make_handler(state: ServeState, default_weights: Dict[str, float],
                  api=None):
    """``api`` (serving.http_api.ServingAPI) adds the RAG surface: every
    endpoint the scheduler path does not own (/v1/rag, /v1/feedback,
    /v1/embeddings, the browser UI) delegates to the RAG handler by
    inheritance, so one port serves both."""
    if api is not None:
        from a_nice_rag_tpu_torch.serving.http_api import (
            _make_handler as _rag_handler,
        )

        base = _rag_handler(api)
    else:
        base = BaseHTTPRequestHandler

    class Handler(base):
        # HTTP/1.1: a client's connection, and its handler thread, serve
        # its next request too, so a query pays no connect, accept or
        # thread start. A reply keeps the connection only where its
        # request was read whole (keep_alive); any other reply, the RAG
        # surface's POSTs among them, says "Connection: close".
        protocol_version = "HTTP/1.1"
        timeout = 300  # seconds an idle connection holds its thread
        keep_alive = False

        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def end_headers(self):
            if not (self.keep_alive or self.close_connection):
                self.send_header("Connection", "close")
            super().end_headers()

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self.keep_alive = True  # a GET has no body to leave unread
            if self.path == "/v1/health":
                self._reply(200, {
                    "status": "ok",
                    "n_docs": state.index.n_docs,
                    "models": list(state.retriever.model_names),
                })
            elif self.path == "/v1/stats":
                out = {
                    "schedulers": state.pool.stats,
                    "health_events": (
                        state.monitor.events[-20:] if state.monitor else []
                    ),
                }
                if getattr(api, "gen_server", None) is not None:
                    out["generation"] = api.gen_server.stats()
                self._reply(200, out)
            elif api is not None:
                super().do_GET()  # browser UI etc.
            else:
                self._reply(404, {"error": "unknown endpoint"})

        def do_POST(self):
            self.keep_alive = False
            if self.path != "/v1/search":
                if api is not None:
                    # RAG / feedback surface (reads rfile itself).
                    super().do_POST()
                else:
                    self._reply(404, {"error": "unknown endpoint"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad JSON: {e}"})
                return
            self.keep_alive = True
            try:
                model = payload.get("model", state.retriever.model_names[0])
                weights = payload.get("model_weights") or default_weights
                if "query_embeddings_b64" in payload:
                    # Batched RPC form: raw little-endian f32 (or bf16
                    # bits) [B, D] and optionally i32 term ids [B, T] as
                    # base64; JSON arrays of a wide batch would bench the
                    # JSON parser, not the serving stack. bf16 halves the
                    # request bytes and the host->device upload; ranking
                    # is the exact f32 ordering of the bf16-rounded
                    # query, the native front's bf16 wire contract.
                    q_mat, terms_b = decode_b64_batch(payload)
                    rows, scores = state.submit_batch_sync(
                        model, q_mat, terms_b, weights,
                        payload.get("filename_type_filter"),
                        float(payload.get("wrrf_k", 40.0)),
                    )
                    # Binary reply in the same b64 form: JSON text of a
                    # [512, n] float matrix costs more host time than
                    # the request.
                    rows = np.ascontiguousarray(rows, np.int32)
                    scores = np.ascontiguousarray(scores, np.float32)
                    self._reply(200, {
                        "rows_b64":
                            base64.b64encode(rows.tobytes()).decode(),
                        "scores_b64":
                            base64.b64encode(scores.tobytes()).decode(),
                        "out_shape": list(rows.shape),
                    })
                    return
                emb = payload.get("query_embedding")
                text = payload.get("query")
                text_terms = None
                if emb is not None:
                    q_vec = np.asarray(emb, np.float32)
                elif text is not None:
                    q_vec, text_terms = state.encode_text_query(str(text))
                else:
                    raise ValueError(
                        "'query_embedding' or 'query' is required"
                    )
                terms = None
                if payload.get("terms") is not None:
                    terms = np.asarray(payload["terms"], np.int32)
                elif text_terms is not None:
                    terms = text_terms
                rows, scores = state.submit_sync(
                    {model: q_vec}, terms, weights,
                    payload.get("filename_type_filter"),
                    float(payload.get("wrrf_k", 40.0)),
                )
                meta = state.index.meta
                out = []
                for r, s in zip(rows.tolist(), scores.tolist()):
                    if r < 0 or r >= meta.n_docs:
                        continue
                    out.append({
                        "id": meta.ids[r],
                        "source": meta.sources[r],
                        "score": s,
                        "document": meta.contents[r],
                    })
                self._reply(200, {"results": out})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serving boundary
                logger.exception("search failed")
                self._reply(500, {"error": str(e)})

    return Handler


def serve_state(
    state: ServeState,
    default_weights: Dict[str, float],
    host: str = "127.0.0.1",
    port: int = 8800,
    background: bool = False,
    api=None,
):
    """Start the asyncio scheduler loop thread + HTTP server. With
    ``background``, returns the server; its ``shutdown()`` also stops the
    monitor, the scheduler pool and the loop."""
    loop = asyncio.new_event_loop()
    state.loop = loop
    loop_thread = threading.Thread(target=loop.run_forever, daemon=True,
                                   name="scheduler-loop")
    loop_thread.start()
    if state.monitor is not None:
        state.monitor.start()
    gen_server = getattr(api, "gen_server", None)
    if gen_server is not None:
        gen_server.start()
    server = ThreadingHTTPServer(
        (host, port), _make_handler(state, default_weights, api=api)
    )

    def _teardown():
        """Stop everything the serve started: the monitor, the
        generation server, the scheduler pool's loop tasks (so no asyncio
        task is left pending when the loop thread dies), then the
        loop, which is closed once its thread has ended."""
        if state.monitor is not None:
            state.monitor.stop()
        if gen_server is not None:
            gen_server.stop()
        try:
            fut = asyncio.run_coroutine_threadsafe(state.pool.stop(), loop)
            fut.result(timeout=10)
        except Exception:  # noqa: BLE001 — best-effort teardown
            logger.exception("serve: stopping the scheduler pool failed")
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(timeout=10)
        if not loop_thread.is_alive():
            loop.close()

    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        orig_shutdown = server.shutdown

        def _shutdown():
            orig_shutdown()
            server.server_close()
            _teardown()

        server.shutdown = _shutdown
        return server
    logger.info("serving on http://%s:%d", host, port)
    try:
        server.serve_forever()
    finally:
        _teardown()
    return None


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--index", default=None, help="index artifact path")
    p.add_argument("--demo", action="store_true",
                   help="serve a synthetic demo corpus")
    p.add_argument("--device", default="cuda",
                   help="device the index is served on (default cuda)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--models", default=None,
                   help="comma-separated dense models (default: all)")
    p.add_argument("--no-bm25", action="store_true")
    p.add_argument("--autotune", action="store_true",
                   help="tune K1's query block and splits on the card")
    p.add_argument("--rounded-fold", "--pallas-rounded", action="store_true",
                   help="serve the dense lists on the rounded fold (K1r / "
                        "K2r: top-k on bf16-rounded scores, ties to the "
                        "lower id; maskless calls over N %% 1024 == 0 "
                        "rows) on one device; the sharded route stays "
                        "exact. With --autotune, adds its plans to the "
                        "tuner instead of forcing it")
    p.add_argument("--shards", type=int, default=0)
    p.add_argument("--two-tier-common", type=int, default=0)
    # The retriever fixes these at startup and a /v1/search request cannot
    # change them: the depth of each ranker's list, the fused results a
    # query gets back, and the postings a BM25 query may gather (those past
    # it are dropped, so a corpus with longer posting lists needs more).
    p.add_argument("--similarity-k", type=int, default=25,
                   help="candidates per ranker before the fusion")
    p.add_argument("--common-sections-n", type=int, default=15,
                   help="fused results returned per query")
    p.add_argument("--bm25-budget", type=int, default=16384,
                   help="BM25 postings gathered per query")
    p.add_argument("--nprobe", type=int, default=0,
                   help="serve the flagship model via IVF ANN, probing "
                        "this many clusters per query (0 = exact)")
    p.add_argument("--ivf-clusters", type=int, default=None,
                   help="IVF cluster count (default ~sqrt(N))")
    p.add_argument("--ivf-spill", action="store_true",
                   help="store boundary docs in their two nearest "
                        "clusters (better low-nprobe recall, up to 2x "
                        "IVF memory)")
    p.add_argument("--ivf-max-coverage", type=float, default=0.25,
                   help="auto IVF routing threshold: batches whose "
                        "expected cluster coverage 1-(1-p/C)^B exceeds "
                        "this take the exact stream")
    p.add_argument("--ivf-cache", default=None,
                   help="path to persist/reuse the sharded IVF "
                        "clustering layout (skips startup k-means)")
    p.add_argument("--native-port", type=int, default=None,
                   help="also serve the binary native (C++) front on this "
                        "port: length-prefixed binary frames, "
                        "socket-layer batching, no Python per request. "
                        "Single-dense-model configs only; 0 picks a free "
                        "port")
    p.add_argument("--native-t-max", type=int, default=32,
                   help="term-id columns per row on the native front")
    p.add_argument("--native-wire-dtype", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="embedding element width on the native wire: bf16 "
                        "halves the bytes per row on the socket and the "
                        "host->device upload; int8 quarters them (per-row "
                        "scale, dequantized on the device); ranking is "
                        "the exact f32 ordering of the quantized query's "
                        "scores")
    p.add_argument("--embedder", default=None,
                   help="on-device query embedder so /v1/search takes raw "
                        "text: 'hashing' = the hashing tokenizer + the "
                        "transformer encoder (seeded random weights "
                        "unless --embedder-ckpt)")
    p.add_argument("--embedder-ckpt", default=None,
                   help="checkpoint dir of trained encoder params "
                        "(models.trainer.train_encoder's checkpoint_dir; "
                        "its latest step)")
    p.add_argument("--llm", default=None, choices=["local"],
                   help="'local' attaches the on-device decoder LM: adds "
                        "/v1/rag (+SSE), /v1/generate, "
                        "/v1/chat/completions, /v1/feedback and the "
                        "browser UI to this port. Seeded random demo "
                        "weights unless --llm-ckpt")
    p.add_argument("--llm-ckpt", default=None,
                   help="HF-format Qwen3 checkpoint dir (config.json + "
                        "*.safetensors) for the local LM")
    p.add_argument("--gen-slots", type=int, default=4,
                   help="continuous-batching decode slots")
    p.add_argument("--gen-chunk", type=int, default=8,
                   help="decode steps per host read")
    p.add_argument("--gen-max-len", type=int, default=1024,
                   help="KV-cache length per slot")
    p.add_argument("--draft-ckpt", default=None,
                   help="smaller HF-format Qwen3 checkpoint dir used as "
                        "the speculative-decoding draft (greedy streams "
                        "stay the target's)")
    p.add_argument("--gamma", type=int, default=4,
                   help="draft proposals per speculation round")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="incremental prefill: admit long prompts N tokens "
                        "per decode tick so active streams never stall "
                        "longer than one chunk's forward")
    p.add_argument("--max-pending", type=int, default=None,
                   help="backpressure: reject /v1/generate submissions "
                        "(HTTP 429) beyond this many queued requests")
    p.add_argument("--retain-prefixes", type=int, default=0,
                   help="keep up to N retired requests' KV rows as cached "
                        "prefixes (multi-turn chat prefills only the new "
                        "tail)")
    p.add_argument("--logprob-topk", type=int, default=0,
                   help="emit the top-K raw-distribution alternatives per "
                        "generated token (/v1/generate 'top_logprobs'); "
                        "0 = off")
    p.add_argument("--json-mode", action="store_true",
                   help="register guided-decoding JSON constraints on the "
                        "local LM: /v1/generate and /v1/chat/completions "
                        "then take 'constraint' or response_format "
                        "{'type': 'json_object'} and the output parses")
    p.add_argument("--json-depth", type=int, default=4,
                   help="max JSON nesting depth for --json-mode")
    p.add_argument("--chat-template", default="auto",
                   choices=["auto", "chatml", "plain"],
                   help="chat prompt format for /v1/chat/completions: "
                        "auto = the checkpoint's declared chat_template "
                        "with a marker-in-vocab fallback")
    p.add_argument("--lm-tp", type=int, default=None,
                   help="tensor-parallel degree for the local LM: attention "
                        "heads, MLP columns and KV caches split over the "
                        "first N cards (parallel/lm.py's Megatron layout; "
                        "greedy streams equal one card's)")
    return p


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = _parser()
    args, rest = parser.parse_known_args(argv)
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.lm_tp is not None and args.llm != "local":
        raise SystemExit("--lm-tp needs --llm local")
    if args.llm and not args.embedder:
        args.embedder = "hashing"  # RAG needs a query embedder
    if args.embedder_ckpt and args.embedder != "hashing":
        raise SystemExit("--embedder-ckpt needs --embedder hashing")

    if args.demo:
        from a_nice_rag_tpu_torch.index import build_index
        from a_nice_rag_tpu_torch.testing import synth_corpus

        c = synth_corpus(n_docs=2048, dim=128, n_queries=4, seed=11)
        index = build_index(ids=c.ids, sources=c.sources,
                            contents=c.contents, embeddings=c.embeddings,
                            token_lists=c.tokens, device=args.device)
    elif args.index:
        from a_nice_rag_tpu_torch.index import load_index

        index = load_index(args.index, device=args.device)
    else:
        raise SystemExit("--index or --demo is required")

    model_names = (
        args.models.split(",") if args.models
        else list(index.dense_model_names)
    )
    use_bm25 = not args.no_bm25 and index.bm25 is not None
    embedder = None
    if args.embedder == "hashing":
        embedder = hashing_embedder(index, model_names[0],
                                    args.embedder_ckpt)
    elif args.embedder:
        raise SystemExit(f"unknown --embedder {args.embedder!r}")
    state = build_state(
        index, tuple(model_names), use_bm25=use_bm25,
        autotune=args.autotune, shards=args.shards,
        two_tier_common=args.two_tier_common,
        similarity_k=args.similarity_k,
        common_sections_n=args.common_sections_n, budget=args.bm25_budget,
        nprobe=args.nprobe, ivf_clusters=args.ivf_clusters,
        ivf_cache=args.ivf_cache, ivf_spill=args.ivf_spill,
        ivf_max_coverage=args.ivf_max_coverage, embedder=embedder,
        rounded_fold=args.rounded_fold,
        devices=None if args.device.startswith("cuda") else
        [args.device] * max(args.shards, 1),
    )
    weights = {m: (5.0 if m == model_names[0] else 1.0)
               for m in model_names}
    if use_bm25:
        weights["BM25"] = 1.0
    api = None
    if args.llm == "local":
        api = build_local_llm_api(
            index, state, embedder, model_names,
            llm_ckpt=args.llm_ckpt, gen_slots=args.gen_slots,
            gen_chunk=args.gen_chunk, gen_max_len=args.gen_max_len,
            draft_ckpt=args.draft_ckpt, gamma=args.gamma,
            prefill_chunk=args.prefill_chunk, max_pending=args.max_pending,
            json_mode=args.json_mode, json_depth=args.json_depth,
            logprob_topk=args.logprob_topk,
            retain_prefixes=args.retain_prefixes,
            chat_template=args.chat_template, lm_tp=args.lm_tp,
        )
    native = None
    if args.native_port is not None:
        from a_nice_rag_tpu_torch.serving.native_front import (
            NativeRetrievalFront,
        )

        native = NativeRetrievalFront(
            state.retriever, weights, host=args.host,
            port=args.native_port, t_max=args.native_t_max,
            wire_dtype=args.native_wire_dtype,
        )
        logger.info(
            "native binary front on %s:%d (dim=%d, t_max=%d, wire=%s)",
            args.host, native.port, native.dim, native.t_max,
            native.wire_dtype,
        )
    try:
        serve_state(state, weights, host=args.host, port=args.port, api=api)
    finally:
        if native is not None:
            native.stop()


def hashing_embedder(index, model: str, ckpt: Optional[str] = None):
    """``--embedder hashing [--embedder-ckpt DIR]``: the hashing encoder
    (``EncoderConfig`` at the width of the index's ``model`` matrix) on
    the index's device, holding the latest checkpoint's params under
    ``ckpt`` (``models.trainer.train_encoder``'s ``checkpoint_dir``) when
    given, seeded random weights otherwise."""
    from a_nice_rag_tpu_torch.models import EncoderConfig, OnDeviceEmbedder
    from a_nice_rag_tpu_torch.ops.quantized import QuantizedDense

    mat = index.dense_matrix(model)
    if isinstance(mat, QuantizedDense):
        mat = mat.values
    embedder = OnDeviceEmbedder(EncoderConfig(out_dim=int(mat.shape[1])),
                                device=index.device)
    if ckpt:
        from a_nice_rag_tpu_torch.models.checkpoint import restore_checkpoint

        # (step, params, opt_state): the params alone are served.
        _, params, _ = restore_checkpoint(
            ckpt, template=embedder.model.state_dict())
        embedder.model.load_state_dict(params)
    return embedder


def _checkpoint_eos(llm_ckpt: str, default: int) -> int:
    """The checkpoint config's ``eos_token_id`` (the first of a list), or
    ``default``: a real checkpoint decodes until its own EOS."""
    with open(os.path.join(llm_ckpt, "config.json")) as f:
        eos = json.load(f).get("eos_token_id")
    if isinstance(eos, list):
        eos = eos[0] if eos else None
    return default if eos is None else int(eos)


def _checkpoint_tokenizer(llm_ckpt: str, chat_template: str):
    """The checkpoint's own tokenizer (exact BPE encode + streaming
    byte-map decode), or None when it has no ``tokenizer.json`` or the
    ``tokenizers`` runtime cannot read it (then prompts use the byte
    tokenizer and constraints still lower onto the file's byte map)."""
    if not os.path.exists(os.path.join(llm_ckpt, "tokenizer.json")):
        return None
    from a_nice_rag_tpu_torch.models.hf_tokenizer import HFTokenizer

    try:
        tok = HFTokenizer(llm_ckpt)
    except Exception as e:  # noqa: BLE001 — degrade, don't die
        logger.warning("serve: tokenizers runtime rejected tokenizer.json "
                       "(%s); prompts use the demo byte tokenizer", e)
        return None
    if chat_template != "auto":
        tok.force_chatml = chat_template == "chatml"
    logger.info("serve: generation endpoints use the checkpoint's "
                "tokenizer (%d pieces, %d specials)",
                len(tok.token_bytes), len(tok.specials))
    return tok


def _json_constraints(vocab: int, eos_id: int, depth: int, llm_ckpt,
                      hf_tok):
    """The JSON guided-decoding registry of --json-mode, lowered onto the
    checkpoint's tokenizer (multi-byte BPE pieces) when there is one and
    onto the byte tokenizer otherwise."""
    from a_nice_rag_tpu_torch.models.constrain import (
        compile_constraint,
        json_dfa,
    )

    token_bytes = None
    if hf_tok is not None:
        token_bytes = hf_tok.token_bytes
    elif llm_ckpt and os.path.exists(os.path.join(llm_ckpt,
                                                  "tokenizer.json")):
        from a_nice_rag_tpu_torch.models.hf_tokenizer import (
            load_token_bytes,
        )

        token_bytes, _ = load_token_bytes(llm_ckpt)
    dfas = {
        "json": json_dfa(max_depth=depth),
        "json_object": json_dfa(max_depth=depth, top_level="object"),
        "json_array": json_dfa(max_depth=depth, top_level="array"),
    }
    return {name: compile_constraint(dfa, vocab, eos_id,
                                     token_bytes=token_bytes, name=name)
            for name, dfa in dfas.items()}


def build_local_llm_api(index, state, embedder, model_names,
                        llm_ckpt=None, gen_slots: int = 4,
                        gen_chunk: int = 8, gen_max_len: int = 1024,
                        max_pending=None, draft_ckpt=None, gamma: int = 4,
                        prefill_chunk=None, json_mode: bool = False,
                        json_depth: int = 4, logprob_topk: int = 0,
                        retain_prefixes: int = 0,
                        chat_template: str = "auto",
                        lm_tp: Optional[int] = None):
    """Attach the on-device decoder LM to this deployment, on the index's
    device: a continuous-batching GenerationServer shared by
    /v1/generate, /v1/chat/completions and the RAG LLM hop, a RAGSystem
    over this serve state's engine (sharded or single-device), and a
    ServingAPI exposing /v1/rag (+SSE) and the browser UI. No SaaS
    anywhere (the reference's generation hop is SaaS-only,
    src/query_rag.py:434-513). ``lm_tp`` > 1 serves the LM over a ``tp``
    mesh of the first ``lm_tp`` cards (``lm_tp`` slots of the CPU when the
    index is on the CPU)."""
    from a_nice_rag_tpu_torch.config import InfoSource
    from a_nice_rag_tpu_torch.models import convert
    from a_nice_rag_tpu_torch.models.decoder import (
        EOS,
        init_decoder,
        small_lm_config,
    )
    from a_nice_rag_tpu_torch.rag.providers import LocalTpuLLMClient
    from a_nice_rag_tpu_torch.rag.system import RAGSystem
    from a_nice_rag_tpu_torch.retrieval.rerank import IdentityReranker
    from a_nice_rag_tpu_torch.serving.genserver import GenerationServer
    from a_nice_rag_tpu_torch.serving.http_api import ServingAPI

    dev = index.device
    mesh = None
    if lm_tp is not None and lm_tp > 1:
        from a_nice_rag_tpu_torch.parallel import make_mesh

        if dev.type == "cuda":
            n = torch.cuda.device_count()
            if lm_tp > n:
                raise SystemExit(
                    f"--lm-tp {lm_tp} > available devices ({n})")
            devices = [f"cuda:{i}" for i in range(lm_tp)]
        else:
            devices = [dev] * lm_tp
        mesh = make_mesh((lm_tp,), ("tp",), devices)
        logger.info("serve: local LM tensor-parallel over %s",
                    [str(d) for d in mesh.devices])
    if llm_ckpt:
        lm_cfg, lm = convert.load_decoder_checkpoint_dir(llm_ckpt,
                                                         device=dev)
        logger.info("serve: local LM loaded from %s (%d layers)",
                    llm_ckpt, lm_cfg.num_layers)
    else:
        lm = init_decoder(small_lm_config(), device=dev)
        logger.warning("serve: local LM is RANDOM-INIT demo weights "
                       "(pass --llm-ckpt for real generation)")
    draft = None
    if draft_ckpt:
        d_cfg, draft = convert.load_decoder_checkpoint_dir(draft_ckpt,
                                                           device=dev)
        if lm.cfg.vocab_size != d_cfg.vocab_size:
            raise SystemExit(
                f"--draft-ckpt vocab ({d_cfg.vocab_size}) must match "
                f"the target's ({lm.cfg.vocab_size})"
            )
        logger.info("serve: speculative draft loaded from %s "
                    "(%d layers, gamma=%d)", draft_ckpt, d_cfg.num_layers,
                    gamma)
    eos_id, hf_tok = EOS, None
    if llm_ckpt:
        eos_id = _checkpoint_eos(llm_ckpt, EOS)
        hf_tok = _checkpoint_tokenizer(llm_ckpt, chat_template)
    constraints = None
    if json_mode:
        if draft is not None:
            raise SystemExit(
                "--json-mode does not compose with --draft-ckpt "
                "(constrained decoding is rejected in speculative mode)"
            )
        constraints = _json_constraints(lm.cfg.vocab_size, eos_id,
                                        json_depth, llm_ckpt, hf_tok)
        logger.info("serve: JSON guided decoding registered (depth=%d)",
                    json_depth)
    gen = GenerationServer(lm, slots=gen_slots, eos_id=eos_id,
                           max_len=gen_max_len, chunk=gen_chunk,
                           draft_model=draft, gamma=gamma,
                           prefill_chunk=prefill_chunk,
                           max_pending=max_pending, constraints=constraints,
                           logprob_topk=logprob_topk,
                           retain_prefixes=retain_prefixes, mesh=mesh)
    # The client's prompt window leaves the cache room for its 256-token
    # answer rounded up to whole chunks, and for the BOS it prepends to a
    # cut prompt (the JAX package's gen_max_len - 256 overflows the row by
    # one on a cut prompt, and the RAG answer becomes the submit error).
    answer = 256  # the client's answer budget, as the JAX package's
    client = LocalTpuLLMClient(
        lm, server=gen, tokenizer=hf_tok, max_new_tokens=answer,
        max_prompt_tokens=max(64, gen_max_len - 1 - gen_chunk * -(
            -answer // gen_chunk)))
    rag = RAGSystem(
        indexes={InfoSource.NICE: index},
        embedder=embedder,
        reranker=IdentityReranker(),
        llm_clients={"local": client},
        device=dev,
    )
    sidx = getattr(state.retriever, "sidx", None)
    if sidx is not None:
        from a_nice_rag_tpu_torch.parallel.engine import ShardedSearchEngine

        rag.attach_index(
            InfoSource.NICE, index,
            engine=ShardedSearchEngine(sidx, embedder=embedder,
                                       reranker=IdentityReranker()),
        )
    return ServingAPI(rag, gen_server=gen, llm_options=["local-tpu"],
                      tokenizer=hf_tok)


if __name__ == "__main__":
    main()
