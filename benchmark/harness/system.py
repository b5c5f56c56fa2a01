"""The system under test: the port's served retrieval path, in process.

A ``FusedRetriever`` over an ``ArrayIndex`` made from the generated
arrays (or, where the configuration names a ``mesh``, a
``ShardedRetriever`` over a ``ShardedIndex`` of the shards made on their
devices), a ``SchedulerPool`` around it with the configuration's
``BatchScheduler`` settings, and closed-loop client threads that call
the pool's ``submit_threadsafe`` and wait for each reply, as the HTTP
front's handlers do, without the HTTP front.

The pool's retriever is a :class:`Recorder`: it passes every call
through and keeps each batch's inputs and outputs, so that the check can
judge the lists and the fusion of the batches that served the sampled
replies, and the roofline can count each batch's rows.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from a_nice_rag_tpu_torch.index.array_index import ArrayIndex, CorpusMeta
from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays
from a_nice_rag_tpu_torch.ops.quantized import QuantizedDense
from a_nice_rag_tpu_torch.parallel.mesh import make_mesh
from a_nice_rag_tpu_torch.parallel.sharded import (
    IndexShard,
    ShardedIndex,
    ShardedRetriever,
)
from a_nice_rag_tpu_torch.retrieval.engine import FusedRetriever
from a_nice_rag_tpu_torch.serving.scheduler import (
    SchedulerPool,
    retriever_device,
)

from benchmark.harness.gen import Int8Shard, bucket

REPLY_TIMEOUT_S = 120.0


def build_index(cfg: dict, dense=None, int8=None, tc=None,
                impacts: Optional[torch.Tensor] = None) -> ArrayIndex:
    """An index over the generated arrays as they are: n rows, no padding
    rows, so no mask operand (the kernels' unmasked path)."""
    n = cfg["n_docs"]
    model = cfg["model"]
    meta = CorpusMeta(ids=[], sources=[], contents=[], urls=[], n_docs=n,
                      n_docs_padded=n)
    bm25 = stats = None
    if tc is not None:
        dev = tc.post_doc.device
        bm25 = Bm25Arrays(
            indptr=tc.indptr.to(torch.int32),
            doc_ids=torch.cat([tc.post_doc, torch.tensor(
                [n], dtype=torch.int32, device=dev)]),
            impact=torch.cat([impacts, torch.zeros(1, device=dev)]),
            n_docs_padded=n)
        stats = {"max_df": int(torch.diff(tc.indptr).max()),
                 "nnz": int(tc.post_doc.shape[0])}
    return ArrayIndex(
        meta=meta,
        dense={model: dense} if dense is not None else {},
        bm25=bm25, vocab=None, bm25_stats=stats,
        dense_q={model: QuantizedDense(*int8)} if int8 is not None else None,
    )


def build_sharded_index(cfg: dict, shards: Sequence[Int8Shard],
                        devices: Sequence) -> ShardedIndex:
    """The port's sharded index over int8 shards already on their devices:
    one ``IndexShard`` a slot of a dp x corpus mesh (``cfg["mesh"]``), in
    the port's shard geometry, over a base index that holds only the
    corpus's metadata (the shards' pad rows are masked by it)."""
    mesh_cfg = cfg["mesh"]
    mesh = make_mesh(shape=(mesh_cfg["dp"], mesh_cfg["corpus"]),
                     axis_names=("dp", "corpus"), devices=list(devices))
    if mesh_cfg["dp"] != 1 or len(shards) != mesh_cfg["corpus"]:
        raise ValueError(f"mesh {mesh_cfg}: one dp group of "
                         f"{len(shards)} shards is what the harness lays out")
    n_local = shards[0].values.shape[0]
    n_shards = len(shards)
    meta = CorpusMeta(ids=[], sources=[], contents=[], urls=[],
                      n_docs=cfg["n_docs"], n_docs_padded=n_local * n_shards)
    base = ArrayIndex(meta=meta, dense={}, bm25=None, vocab=None,
                      bm25_stats=None)
    row = [IndexShard(device=slot.device, offset=sh.offset, n_real=sh.n_real,
                      dense={cfg["model"]: QuantizedDense(sh.values,
                                                          sh.scales)},
                      bm25=None)
           for slot, sh in zip(mesh.slot_grid("dp", "corpus")[0], shards)]
    return ShardedIndex(mesh=mesh, replicas=[row], base_index=base,
                        n_local=n_local, n_shards=n_shards)


def build_retriever(cfg: dict, index,
                    dense_backend: Optional[str] = None):
    """A ``FusedRetriever`` over an ``ArrayIndex``, or a
    ``ShardedRetriever`` over a ``ShardedIndex``, with the configuration's
    settings."""
    r = cfg["retriever"]
    if isinstance(index, ShardedIndex):
        return ShardedRetriever(
            index, (cfg["model"],), use_bm25=False,
            similarity_k=r["similarity_k"],
            common_sections_n=r["common_sections_n"], budget=r["budget"],
            dense_backend=dense_backend or r["dense_backend"])
    return FusedRetriever(
        index, (cfg["model"],), use_bm25="bm25" in cfg,
        similarity_k=r["similarity_k"],
        common_sections_n=r["common_sections_n"], budget=r["budget"],
        dense_backend=dense_backend or r["dense_backend"],
        two_tier_common=r["two_tier_common"],
        two_tier_dtype=r["two_tier_dtype"],
        t_max_hint=cfg["scheduler"]["t_max"])


def devices_of(retriever) -> List[torch.device]:
    """Every device a retriever runs on, first the one it takes its
    queries on."""
    sidx = getattr(retriever, "sidx", None)
    shards = [] if sidx is None else [sh.device for rep in sidx.replicas
                                      for sh in rep]
    return list(dict.fromkeys([retriever_device(retriever)] + shards))


def synchronize(devices: Sequence[torch.device]) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Batch:
    """One device batch the pool ran: its host query rows, term ids, and
    the retriever's outputs (device tensors)."""

    queries: np.ndarray
    terms: Optional[np.ndarray]
    fids: torch.Tensor
    fvals: torch.Tensor
    lists: torch.Tensor
    done: float  # host clock when the retriever returned


class Recorder:
    """The retriever as the pool sees it: every call passes through, and
    while ``on`` each batch is kept with the host time it returned."""

    def __init__(self, retriever: FusedRetriever):
        self._inner = retriever
        self.on = False
        self.batches: List[Batch] = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def retrieve_device(self, q_embs, q_terms, weights,
                        filename_type_filter=None, wrrf_k=40.0):
        # A ShardedRetriever's retrieve_device is retrieve_lists[:2]: the
        # same work, with the merged lists it leaves out.
        lists_of = getattr(self._inner, "retrieve_lists", None)
        out = (lists_of or self._inner.retrieve_device)(
            q_embs, q_terms, weights, filename_type_filter, wrrf_k)
        if self.on:
            q = next(iter(q_embs.values()))
            self.batches.append(Batch(q, q_terms if self._inner.use_bm25
                                      else None, *out, time.perf_counter()))
        return out if lists_of is None else out[:2] + (None,)


@dataclasses.dataclass
class Request:
    index: int
    start: float
    end: float
    reply: object  # (ids, scores) or the exception raised


class Served:
    """The pool on its own event-loop thread, and the traffic's requests."""

    def __init__(self, cfg: dict, retriever: FusedRetriever,
                 queries: np.ndarray, terms: Optional[np.ndarray],
                 rows_per_request: int):
        s = cfg["scheduler"]
        self.cfg = cfg
        self.recorder = Recorder(retriever)
        self.devices = devices_of(retriever)
        self.pool = SchedulerPool(
            self.recorder, max_batch=s["max_batch"],
            max_wait_ms=s["max_wait_ms"], t_max=s["t_max"],
            max_inflight=s["max_inflight"])
        self.weights = dict(cfg["weights"])
        self.wrrf_k = float(cfg["wrrf_k"])
        self.model = cfg["model"]
        self.rows = rows_per_request
        self.queries = queries
        self.terms = terms
        self.n_requests = queries.shape[0] // rows_per_request
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        name="pool-loop", daemon=True)
        self._thread.start()

    def request_rows(self, i: int) -> slice:
        return slice(i * self.rows, (i + 1) * self.rows)

    def submit(self, i: int):
        rows = self.request_rows(i)
        batched = self.rows > 1
        q = self.queries[rows] if batched else self.queries[rows.start]
        t = None
        if self.terms is not None:
            t = self.terms[rows] if batched else self.terms[rows.start]
        return self.pool.submit_threadsafe(
            self.loop, {self.model: q}, t, weights=self.weights,
            wrrf_k=self.wrrf_k, batched=batched)

    def buckets(self, clients: int) -> List[int]:
        """The padded batch sizes this traffic can make: from one request
        to as many rows as the scheduler coalesces."""
        m = self.cfg["scheduler"]["max_batch"]
        # The scheduler adds entries while the batch holds fewer than
        # max_batch rows.
        top = self.rows if self.rows >= m else min(self.rows * clients,
                                                   m - 1 + self.rows)
        out, b = [], bucket(self.rows)
        while b <= bucket(max(self.rows, top)):
            out.append(b)
            b <<= 1
        return out

    def warm(self, clients: int) -> None:
        """Every bucket the traffic can make, twice, straight through the
        retriever; then two requests a client through the pool. Kernel
        libraries are built on the first call."""
        for b in self.buckets(clients):
            b_rows = min(b, self.queries.shape[0])
            q = np.zeros((b, self.queries.shape[1]), np.float32)
            q[:b_rows] = self.queries[:b_rows]
            t = None
            if self.terms is not None:
                t = np.full((b, self.terms.shape[1]), -1, np.int32)
                t[:b_rows] = self.terms[:b_rows]
            for _ in range(2):
                self.recorder.retrieve_device(
                    {self.model: q}, t, self.weights, None, self.wrrf_k)
        synchronize(self.devices)
        drive(self, clients, seconds=None, max_requests=2 * clients)

    def stats(self) -> Dict[str, int]:
        out = {"batches_run": 0, "queries_served": 0}
        for s in self.pool.stats.values():
            out["batches_run"] += s["batches_run"]
            out["queries_served"] += s["queries_served"]
        return out

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.pool.stop(),
                                         self.loop).result(60)
        asyncio.run_coroutine_threadsafe(
            self.loop.shutdown_default_executor(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(60)
        self.loop.close()


def drive(served: Served, clients: int, seconds: Optional[float],
          max_requests: Optional[int] = None,
          order: Optional[Sequence[int]] = None) -> List[Request]:
    """Closed loop: ``clients`` threads, each sending its next request as
    soon as the last one's reply arrives, with no think time. A client
    sends while the window (``seconds``) is open or until
    ``max_requests`` have been sent; it waits for the reply of every
    request it sent. Requests follow ``order`` (request indices), cycling;
    the window closes when the last reply arrives."""
    order = list(order) if order is not None else list(
        range(served.n_requests))
    counter = itertools.count()
    stop_at = None if seconds is None else time.perf_counter() + seconds
    done: List[Request] = []

    def client():
        while True:
            t0 = time.perf_counter()
            if stop_at is not None and t0 >= stop_at:
                return
            j = next(counter)
            if max_requests is not None and j >= max_requests:
                return
            i = order[j % len(order)]
            try:
                reply = served.submit(i).result(REPLY_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001 — a failed request
                reply = e
            done.append(Request(i, t0, time.perf_counter(), reply))

    threads = [threading.Thread(target=client, name=f"client-{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return done
