"""Native binary serving front: C++ socket layer + Python dispatchers.

Counterpart of ``a_nice_rag_tpu/serving/native_front.py``.
``NativeRetrievalFront`` starts the native server (``native/anr_serve.cpp``,
built with g++ at first use) and ``inflight`` Python dispatch threads. The
native threads own accept / frame parsing / batching / reply framing;
Python wakes once per BATCH:

    poll (fills preallocated buffers, GIL released while waiting)
      -> pad to the power-of-two bucket (a dp multiple when sharded)
      -> upload to the device (bf16 bits or int8 rows as they are)
      -> retriever.retrieve_device (one device call)
      -> reply per frame (native code frames + writes the sockets)

This takes the HTTP front's per-request work (HTTP parse, JSON, base64)
off Python, so the host layer stops being the ceiling of the serving
path. The front serves the single-dense-model (+BM25) configuration with
fixed weights / filter / wrrf_k; richer knobs stay on the HTTP surface.
"""

from __future__ import annotations

import ctypes
import logging
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.ops.quantized import QuantizedDense
from a_nice_rag_tpu_torch.serving.scheduler import (
    retriever_device,
    upload_bf16,
)

logger = logging.getLogger(__name__)

_MAGIC_REQ = 0x51524E41  # "ANRQ"
_MAGIC_REP = 0x50524E41  # "ANRP"
_MAGIC_ERR = 0x45524E41  # "ANRE"
WIRE_DTYPES = ("f32", "bf16", "int8")


class NativeFrontUnavailable(RuntimeError):
    """The native front could not be built (no g++, or its build
    failed); the HTTP front (serving.serve_cli) still serves."""


def bf16_bits(x) -> np.ndarray:
    """f32 values -> their bf16 bits (uint16), rounded to nearest even by
    torch's conversion; NaN becomes the quiet NaN of its sign, as
    ``ml_dtypes.bfloat16`` gives it (torch's CPU conversion gives
    0xFFFF)."""
    f = np.ascontiguousarray(x, np.float32)
    bits = torch.from_numpy(f).to(torch.bfloat16).view(torch.int16).numpy(
        ).view(np.uint16)
    nan = np.isnan(f)
    if nan.any():
        sign = (f.view(np.uint32)[nan] >> 16).astype(np.uint16) & 0x8000
        bits[nan] = sign | 0x7FC0
    return bits


def bf16_values(bits: np.ndarray) -> np.ndarray:
    """bf16 bits (uint16) -> the f32 values they hold, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def _check_wire(wire_dtype: str) -> None:
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype must be 'f32', 'bf16', or 'int8', "
                         f"got {wire_dtype!r}")


class NativeRetrievalFront:
    def __init__(
        self,
        retriever,
        weights: Dict[str, float],
        host: str = "127.0.0.1",
        port: int = 0,
        t_max: int = 32,
        max_batch: int = 512,
        wait_ms: float = 2.0,
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
        max_frame_rows: int = 2048,
        inflight: int = 4,
        collect_ms: float = 2.0,
        max_queued_rows: Optional[int] = None,
        wire_dtype: str = "f32",
    ):
        """``inflight`` dispatch threads pipeline poll -> device -> reply:
        while one batch's results download, the next batch launches.
        Device execution serializes; the overlap hides host<->device
        copies, as BatchScheduler(max_inflight=) does. ``collect_ms`` is
        the native batch-formation window: once a frame arrives, the poll
        keeps collecting stragglers that long (or until max_batch rows
        wait) before dispatching. ``max_queued_rows`` caps the native
        request queue (default 8 x max_batch); past it readers block, so
        a client pipelining faster than the device drains hits TCP
        backpressure instead of growing server memory without bound.

        ``wire_dtype``: "f32" (default), "bf16" or "int8". bf16 halves the
        bytes per row on both hops of the serving path: the socket frame
        and, because the dispatcher uploads the polled bits as they are,
        the host->device copy. Scores are then computed from the
        bf16-rounded query, exactly widened to f32 on the device: ranking
        is the exact f32 ordering of the rounded query's scores. "int8"
        quarters the bytes: each wire row is ``dim`` int8 components and
        one trailing f32 per-row scale (stride dim + 4; the client sends
        scale = max|x| / 127). The dispatcher uploads the int8 rows and
        the scales and dequantizes on the device (i8 * scale in f32).
        Clients must send matching frames (``NativeFrontClient(wire_dtype
        =...)``); the server rejects a mismatched frame with an error
        naming the dtype it expects."""
        from a_nice_rag_tpu_torch.native import build

        lib = build.load_serve_lib()
        if lib is None:
            raise NativeFrontUnavailable(
                "native serving front unavailable "
                f"({build.build_error}); use the HTTP front "
                "(serving.serve_cli)")
        if len(retriever.model_names) != 1:
            raise ValueError(
                "the native front serves the single-dense-model "
                f"configuration; got models {retriever.model_names!r}")
        _check_wire(wire_dtype)
        self._lib = lib
        self.retriever = retriever
        self.model = retriever.model_names[0]
        self.weights = dict(weights)
        self.filename_type_filter = filename_type_filter
        self.wrrf_k = float(wrrf_k)
        self.t_max = int(t_max)
        self.max_batch = int(max_batch)
        self.wait_ms = float(wait_ms)
        self.collect_ms = float(collect_ms)
        # The scoring operand's depth, for every retriever: a
        # FusedRetriever's model is a tensor or (int8) a QuantizedDense
        # with [N, D] .values; a ShardedRetriever holds a ShardedIndex.
        sidx = getattr(retriever, "sidx", None)
        if sidx is not None:
            mat = sidx.shards[0].dense[self.model]
            self._dp = int(sidx.n_dp)
        else:
            mat = retriever.index.dense_matrix(self.model)
            self._dp = 1
        self.dim = int((mat.values if isinstance(mat, QuantizedDense)
                        else mat).shape[-1])
        self.device = retriever_device(retriever)
        self.wire_dtype = wire_dtype
        self._wire_esz = {"f32": 4, "bf16": 2, "int8": 1}[wire_dtype]
        self._h = lib.anr_serve_start(
            host.encode(), int(port), self.dim, self.t_max,
            int(min(max_frame_rows, max_batch)),
            int(max_queued_rows if max_queued_rows is not None
                else 8 * self.max_batch),
            self._wire_esz,
        )
        if not self._h:
            raise OSError(f"native front failed to bind {host}:{port}")
        self.port = int(lib.anr_serve_port(self._h))
        self.host = host
        self._max_frames = self.max_batch  # 1-row frames worst case
        self.batches_run = 0
        self.rows_served = 0
        self._count_mu = threading.Lock()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name=f"native-front-{i}")
            for i in range(max(1, int(inflight)))
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        # Sharded retrievers need batches divisible by the mesh's dp
        # axis; lift the power-of-two bucket to a dp multiple.
        if self._dp > 1:
            b = max(b, self._dp)
            if b % self._dp:
                b = (b // self._dp + 1) * self._dp
        return b

    def _dispatch_loop(self) -> None:
        lib = self._lib
        # Per-thread poll buffers: each dispatch thread owns one set, so
        # polls from different threads never alias. bf16 rows stay bits
        # (uint16) and int8 rows stay raw wire rows (dim int8 + trailing
        # f32 scale) until the device.
        if self.wire_dtype == "bf16":
            emb_buf = np.empty((self.max_batch, self.dim), np.uint16)
        elif self.wire_dtype == "int8":
            emb_buf = np.empty((self.max_batch, self.dim + 4), np.uint8)
        else:
            emb_buf = np.empty((self.max_batch, self.dim), np.float32)
        terms_buf = np.empty((self.max_batch, self.t_max), np.int32)
        tokens = (ctypes.c_uint64 * self._max_frames)()
        frame_counts = (ctypes.c_int32 * self._max_frames)()
        emb_p = ctypes.c_void_p(emb_buf.ctypes.data)
        terms_p = terms_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while not self._stop.is_set():
            n = lib.anr_serve_poll(
                self._h, self.max_batch, self.wait_ms, emb_p, terms_p,
                tokens, frame_counts, self._max_frames, self.collect_ms,
            )
            if n < 0:
                break
            if n == 0:
                continue
            counts = [int(frame_counts[i]) for i in range(n)]
            toks = [int(tokens[i]) for i in range(n)]
            try:
                rows, scores = self._run_batch(emb_buf, terms_buf,
                                               sum(counts))
            except Exception as e:  # noqa: BLE001 — serving boundary
                logger.exception("native front dispatch failed")
                msg = str(e)[:200].encode()
                for tok in toks:
                    lib.anr_serve_reply_error(self._h, tok, msg)
                continue
            n_out = rows.shape[1]
            off = 0
            for tok, c in zip(toks, counts):
                r = np.ascontiguousarray(rows[off:off + c], np.int32)
                s = np.ascontiguousarray(scores[off:off + c], np.float32)
                lib.anr_serve_reply(
                    self._h, tok, c, n_out,
                    r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                )
                off += c
            with self._count_mu:
                self.batches_run += 1
                self.rows_served += off

    def _queries(self, emb_buf: np.ndarray, rows: int,
                 b_pad: int) -> torch.Tensor:
        """The polled rows, padded to ``b_pad``, as f32 on the device."""
        if self.wire_dtype == "int8":
            # [rows, dim + 4] uint8 -> int8 rows + f32 scales, uploaded as
            # they are and dequantized on the device.
            q_i8 = np.zeros((b_pad, self.dim), np.int8)
            q_i8[:rows] = emb_buf[:rows, :self.dim].view(np.int8)
            sc = np.zeros((b_pad,), np.float32)
            sc[:rows] = emb_buf[:rows, self.dim:].copy().view(
                np.float32).ravel()
            i8 = torch.from_numpy(q_i8).to(self.device)
            return (i8.to(torch.float32)
                    * torch.from_numpy(sc).to(self.device)[:, None])
        q = np.zeros((b_pad, self.dim), emb_buf.dtype)
        q[:rows] = emb_buf[:rows]
        if self.wire_dtype == "bf16":
            return upload_bf16(q, self.device)
        return torch.from_numpy(q).to(self.device)

    def _run_batch(
        self, emb_buf: np.ndarray, terms_buf: np.ndarray, rows: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        b_pad = self._bucket(rows)
        q = self._queries(emb_buf, rows, b_pad)
        terms = None
        if self.retriever.use_bm25:
            terms = np.full((b_pad, self.t_max), -1, np.int32)
            terms[:rows] = terms_buf[:rows]
        d_rows, d_scores, _ = self.retriever.retrieve_device(
            {self.model: q}, terms, self.weights,
            self.filename_type_filter, self.wrrf_k,
        )
        return d_rows.cpu().numpy(), d_scores.cpu().numpy()

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        if self._h is None:
            return {"batches_run": self.batches_run,
                    "rows_served": self.rows_served}
        frames = ctypes.c_uint64()
        rows = ctypes.c_uint64()
        bad = ctypes.c_uint64()
        self._lib.anr_serve_stats(
            self._h, ctypes.byref(frames), ctypes.byref(rows),
            ctypes.byref(bad),
        )
        return {
            "frames_in": frames.value,
            "rows_in": rows.value,
            "bad_frames": bad.value,
            "batches_run": self.batches_run,
            "rows_served": self.rows_served,
        }

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        # Two-phase: stop wakes every blocked poll (the handle stays
        # valid), free releases it once no dispatch thread can be inside
        # a lib call. A thread still in a long device call (a first-use
        # kernel build) replies afterwards, which must see a live handle.
        self._lib.anr_serve_stop(self._h)
        for t in self._threads:
            t.join(timeout=30)
        alive = [t for t in self._threads if t.is_alive()]
        if alive:
            logger.warning(
                "native front: %d dispatch thread(s) still in flight at "
                "stop(); leaking the server handle rather than freeing "
                "under them", len(alive))
            return
        self._lib.anr_serve_free(self._h)
        self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class NativeFrontClient:
    """Minimal blocking client for the binary front (tests + bench).

    One TCP connection; ``search`` sends a [B, D] query block (and
    optional [B, T] term ids) as one frame and blocks for its reply.
    Thread-safe for one in-flight request per client instance.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 60.0,
                 wire_dtype: str = "f32"):
        _check_wire(wire_dtype)
        self.wire_dtype = wire_dtype
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._req_id = 0

    def _recv_all(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            b = self._sock.recv(min(n, 1 << 20))
            if not b:
                raise ConnectionError("native front closed the connection")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def search(
        self,
        q: np.ndarray,
        terms: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        # bf16 rows may come as their bits (uint16), sent as they are.
        q = np.asarray(q)
        if not (self.wire_dtype == "bf16" and q.dtype == np.uint16):
            q = np.ascontiguousarray(q, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        n_rows = q.shape[0]
        self._req_id += 1
        flags = {"f32": 0, "bf16": 2, "int8": 4}[self.wire_dtype]
        if self.wire_dtype == "int8":
            # Per-row symmetric quantization: scale = max|x| / 127, so
            # precision tracks the row's magnitude. Wire row = dim int8 +
            # trailing f32 scale (stride dim + 4).
            dim = q.shape[1]
            mx = np.max(np.abs(q), axis=1)
            scale = np.where(mx > 0, mx / 127.0, 1.0).astype(np.float32)
            i8 = np.clip(np.rint(q / scale[:, None]), -127, 127).astype(
                np.int8)
            wire = np.empty((n_rows, dim + 4), np.uint8)
            wire[:, :dim] = i8.view(np.uint8)
            wire[:, dim:] = scale.view(np.uint8).reshape(n_rows, 4)
            body = wire.tobytes()
        elif self.wire_dtype == "bf16":
            body = (q if q.dtype == np.uint16 else bf16_bits(q)).tobytes()
        else:
            body = q.tobytes()
        if terms is not None:
            t = np.ascontiguousarray(terms, np.int32)
            if t.ndim == 1:
                t = t[None, :]
            flags |= 1
            body += t.tobytes()
        payload = struct.pack("<IHH", self._req_id, n_rows, flags) + body
        self._sock.sendall(
            struct.pack("<II", _MAGIC_REQ, len(payload)) + payload
        )
        magic, plen = struct.unpack("<II", self._recv_all(8))
        payload = self._recv_all(plen)
        if magic == _MAGIC_ERR:
            raise RuntimeError(
                f"native front error: {payload[4:].decode(errors='replace')}"
            )
        if magic != _MAGIC_REP:
            raise ConnectionError(f"bad reply magic {magic:#x}")
        rid, nr, n_out = struct.unpack("<IHH", payload[:8])
        if rid != self._req_id:
            raise ConnectionError("reply req_id mismatch")
        nbytes = nr * n_out * 4
        rows = np.frombuffer(payload[8:8 + nbytes], np.int32)
        scores = np.frombuffer(payload[8 + nbytes:8 + 2 * nbytes], np.float32)
        return rows.reshape(nr, n_out), scores.reshape(nr, n_out)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
