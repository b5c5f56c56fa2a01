"""Micro-batching scheduler for high-QPS serving.

Counterpart of ``a_nice_rag_tpu/serving/scheduler.py``. Concurrent
callers submit single queries (or client batches); the scheduler
coalesces whatever is waiting (up to ``max_batch`` rows, waiting at most
``max_wait_ms``) into ONE ``retrieve_device`` call, padding the batch to a
power-of-two bucket. The bucket fixes B, and B picks the IVF route through
the coverage rule, so the port takes the route the JAX package takes.
Per-query dispatch overhead is amortized B-ways.

bf16 rows travel as ``uint16`` numpy views of their bits: they are
uploaded as they are and reinterpreted as bf16 on the device, then
upcast (exactly) to f32 there.

Callers on other threads (the HTTP handlers) submit through
``submit_threadsafe``. Where the loop would ship their entry alone and
at once (nothing queued, the adaptive wait 0, a batch slot free), the
caller's thread runs that batch itself, with no hand-off to the loop or
a worker; otherwise the entry joins the loop's queue and the worker
thread that runs its batch resolves the caller's future.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.utils.trace import span

DEFAULT_MAX_BATCH = 256


@dataclasses.dataclass
class _Pending:
    q_embs: Dict[str, np.ndarray]  # model -> [D] (or [rows, D])
    q_terms: Optional[np.ndarray]  # [T] or None (or [rows, T])
    # An asyncio future of the loop, or (threadsafe) a
    # concurrent.futures.Future that the thread running the batch
    # resolves.
    future: object
    # batched marks a CLIENT-BATCHED submission (submit_many): the whole
    # row block rides one queue entry and one future, not one asyncio
    # future per row. Its result keeps the leading rows axis even at
    # rows == 1 (a 1-row client batch must NOT squeeze to the submit()
    # 1-D form).
    rows: int = 1
    batched: bool = False
    threadsafe: bool = False
    arrival: float = 0.0  # time.monotonic() when the entry arrived


def retriever_device(retriever) -> torch.device:
    """The device a retriever takes its queries on: a FusedRetriever's
    index device, a ShardedRetriever's lead slot."""
    sidx = getattr(retriever, "sidx", None)
    return sidx.lead if sidx is not None else retriever.device


def upload_bf16(bits: np.ndarray, device: torch.device) -> torch.Tensor:
    """bf16 rows held as uint16 bits -> f32 on ``device``: the upload
    ships two bytes a component, the upcast is exact."""
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.to(device).view(torch.bfloat16).to(torch.float32)


class BatchScheduler:
    def __init__(
        self,
        retriever,
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_wait_ms: float = 2.0,
        t_max: int = 32,
        max_inflight: int = 2,
        adaptive: bool = True,
    ):
        """``adaptive`` scales the collect deadline from an EWMA of the
        arrival rate: under light load the scheduler stops waiting for
        stragglers that statistically will not come (single queries
        dispatch immediately); under heavy load it waits only as long as
        filling ``max_batch`` is expected to take. ``max_wait_ms`` stays
        the hard upper bound either way. Up to ``max_inflight`` batches
        run at once, each on a worker thread (or on the thread of a
        ``submit_threadsafe`` caller that runs its entry alone)."""
        self.retriever = retriever
        self.weights = weights
        self.filename_type_filter = filename_type_filter
        self.wrrf_k = wrrf_k
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.t_max = t_max
        self.adaptive = adaptive
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._batch_tasks: set = set()
        self._inflight = asyncio.Semaphore(max_inflight)
        # Batches running on any thread: the loop's workers take a slot
        # (waiting for one if need be), a caller's direct run only a free
        # one.
        self._slots = threading.BoundedSemaphore(max_inflight)
        self._arrival_mu = threading.Lock()  # arrivals come from threads
        self._last_arrival: Optional[float] = None
        self._inter_ewma_s: Optional[float] = None  # mean inter-arrival
        self.batches_run = 0
        self.queries_served = 0
        # Entries that reached a batch slot, and the seconds they waited
        # for it since arrival (queued or not).
        self.entries_run = 0
        self.queue_s = 0.0
        self._count_mu = threading.Lock()  # batches finish on worker threads

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    async def start(self) -> None:
        if self._task is None:
            self._loop = asyncio.get_running_loop()
            self._task = asyncio.create_task(self._collect_loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # Drain in-flight batch tasks so nothing is left pending when the
        # event loop is torn down. They hold real batches: let them
        # finish rather than cancel.
        if self._batch_tasks:
            await asyncio.gather(*tuple(self._batch_tasks),
                                 return_exceptions=True)

    async def submit(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One query in, (fused doc rows [n], fused scores [n]) out."""
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._enqueue(_Pending(q_embs, q_terms, future))
        return await future

    async def submit_many(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Client-batched submission: ``q_embs[m]`` is [rows, D] (and
        ``q_terms`` [rows, T]), carried as ONE queue entry + ONE future.
        It still coalesces with other pending traffic up to ``max_batch``
        rows, so single-query submitters share the same device batches.
        Returns (doc rows [rows, n], scores [rows, n])."""
        rows = next(iter(q_embs.values())).shape[0]
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._enqueue(_Pending(q_embs, q_terms, future, rows, batched=True))
        return await future

    def submit_threadsafe(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms: Optional[np.ndarray] = None,
        batched: bool = False,
    ) -> concurrent.futures.Future:
        """``submit`` (or, ``batched``, ``submit_many``) from a thread
        other than the loop's, on a started scheduler. Returns a
        ``concurrent.futures.Future`` holding what the coroutine returns.
        Where the loop would ship the entry alone and at once, this
        thread runs the batch and the future is done on return; else a
        worker thread resolves it."""
        if self._loop is None:
            raise RuntimeError("submit_threadsafe needs a started scheduler")
        rows = next(iter(q_embs.values())).shape[0] if batched else 1
        future: concurrent.futures.Future = concurrent.futures.Future()
        pending = _Pending(q_embs, q_terms, future, rows, batched,
                           threadsafe=True)
        self._note_arrival(pending)
        if (self._adaptive_wait_s() == 0.0 and self._queue.empty()
                and self._slots.acquire(blocking=False)):
            try:
                out = self._run_batch([pending])[0]
            except Exception as e:  # noqa: BLE001 — the caller reads it
                _resolve(future, e)
            else:
                _resolve(future, out)
            finally:
                self._slots.release()
            return future
        self._loop.call_soon_threadsafe(self._queue.put_nowait, pending)
        return future

    def _enqueue(self, pending: _Pending) -> None:
        """On the loop: note the arrival, queue the entry."""
        self._note_arrival(pending)
        self._queue.put_nowait(pending)

    def _note_arrival(self, pending: _Pending) -> None:
        """Stamp the entry's arrival. A single query updates the
        arrival-rate estimate; a client batch marks the arrival only."""
        with self._arrival_mu:
            now = time.monotonic()
            pending.arrival = now
            if not pending.batched and self._last_arrival is not None:
                dt = max(now - self._last_arrival, 1e-7)
                self._inter_ewma_s = (
                    dt
                    if self._inter_ewma_s is None
                    else 0.9 * self._inter_ewma_s + 0.1 * dt
                )
            self._last_arrival = now

    # ------------------------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return b

    def _adaptive_wait_s(self) -> float:
        """Collect deadline from the arrival-rate estimate.

        Expected arrivals within max_wait < 1 -> don't wait (the batch
        of 1 ships now; waiting would only add latency). Otherwise wait
        just long enough to fill max_batch at the estimated rate, capped
        by max_wait.
        """
        cap = self.max_wait_ms / 1e3
        if not self.adaptive or self._inter_ewma_s is None:
            return cap
        expected_arrivals = cap / self._inter_ewma_s
        if expected_arrivals < 1.0:
            return 0.0
        return min(cap, self.max_batch * self._inter_ewma_s)

    async def _collect(self) -> List[_Pending]:
        first = await self._queue.get()
        batch = [first]
        rows = first.rows
        # Anything already queued ships in this batch regardless of the
        # wait policy (a burst arriving after idle still coalesces).
        while rows < self.max_batch:
            try:
                p = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            batch.append(p)
            rows += p.rows
        deadline = asyncio.get_running_loop().time() + self._adaptive_wait_s()
        while rows < self.max_batch:
            timeout = deadline - asyncio.get_running_loop().time()
            if timeout <= 0:
                break
            try:
                p = await asyncio.wait_for(self._queue.get(), timeout)
            except asyncio.TimeoutError:
                break
            batch.append(p)
            rows += p.rows
        return batch

    async def _collect_loop(self) -> None:
        # Batches overlap up to max_inflight: while one batch's results
        # download, the next one launches (device execution serializes,
        # host<->device copies pipeline behind it).
        async def run_one(batch):
            async with self._inflight:
                try:
                    results = await asyncio.to_thread(self._run_in_slot,
                                                      batch)
                except Exception as e:  # noqa: BLE001 — propagate
                    results = [e] * len(batch)
                for pending, out in zip(batch, results):
                    if not pending.threadsafe:
                        _resolve(pending.future, out)

        # The event loop keeps only a WEAK reference to tasks; without a
        # strong reference here a pending batch task can be GC'd
        # mid-flight, dropping the batch and hanging every caller. The
        # set lives on the instance so stop() can drain it.
        tasks = self._batch_tasks
        while True:
            batch = await self._collect()
            t = asyncio.create_task(run_one(batch))
            tasks.add(t)
            t.add_done_callback(tasks.discard)

    def _run_in_slot(self, batch: List[_Pending]):
        with self._slots:
            return self._run_and_resolve(batch)

    def _run_and_resolve(self, batch: List[_Pending]):
        """On a worker: run the batch, then resolve its thread-safe
        entries here (the loop resolves the others)."""
        try:
            results = self._run_batch(batch)
        except Exception as e:  # noqa: BLE001 — propagate
            for pending in batch:
                if pending.threadsafe:
                    _resolve(pending.future, e)
            raise
        for pending, out in zip(batch, results):
            if pending.threadsafe:
                _resolve(pending.future, out)
        return results

    def _run_batch(self, batch: List[_Pending]):
        """Run one batch on a held slot: the padded host buffers, the
        retriever's device call, the fused outputs' download."""
        now = time.monotonic()
        waited = sum(now - p.arrival for p in batch)
        with self._count_mu:
            self.entries_run += len(batch)
            self.queue_s += waited
        with span("sched.batch"):
            with span("sched.assemble"):
                q_embs, terms, b = self._assemble(batch)
            # Device path + download of ONLY the fused outputs (the
            # per-list ids stay on the device), one copy each.
            d_fids, d_fvals, _ = self.retriever.retrieve_device(
                q_embs, terms, self.weights, self.filename_type_filter,
                self.wrrf_k
            )
            with span("sched.download"):
                fids = d_fids.cpu().numpy()
                fvals = d_fvals.cpu().numpy()
            with self._count_mu:
                self.batches_run += 1
                self.queries_served += b
            out = []
            i = 0
            for p in batch:
                if p.rows == 1 and not p.batched:
                    out.append((fids[i], fvals[i]))
                else:
                    out.append((fids[i:i + p.rows], fvals[i:i + p.rows]))
                i += p.rows
            return out

    def _assemble(self, batch: List[_Pending]):
        """The entries coalesced into padded host buffers (bf16 bits
        uploaded): (queries by model, term ids [b_pad, t_max], rows)."""
        models = self.retriever.model_names
        b = sum(p.rows for p in batch)
        b_pad = self._bucket(b)
        q_embs: Dict[str, object] = {}
        for m in models:
            dim = np.asarray(batch[0].q_embs[m]).shape[-1]
            # Coalesce as bf16 bits only when EVERY entry carries bf16
            # rows (the half-width RPC/wire forms): the device upload then
            # ships half the bytes. Mixed or f32 traffic keeps the f32
            # buffer; a bf16 row widens into it exactly.
            bits = all(np.asarray(p.q_embs[m]).dtype == np.uint16
                       for p in batch)
            arr = np.zeros((b_pad, dim), np.uint16 if bits else np.float32)
            i = 0
            for p in batch:
                row = np.asarray(p.q_embs[m])
                if row.dtype == np.uint16 and not bits:
                    row = (row.astype(np.uint32) << 16).view(np.float32)
                arr[i:i + p.rows] = row
                i += p.rows
            q_embs[m] = (upload_bf16(arr, retriever_device(self.retriever))
                         if bits else arr)
        terms = np.full((b_pad, self.t_max), -1, np.int32)
        if self.retriever.use_bm25:
            i = 0
            for p in batch:
                if p.q_terms is not None:
                    t = np.asarray(p.q_terms)
                    if p.rows == 1 and t.ndim == 1:
                        t = t[None, :]
                    w = min(t.shape[1], self.t_max)
                    terms[i:i + p.rows, :w] = t[:, :w]
                i += p.rows
        return q_embs, terms, b


def _resolve(future, out) -> None:
    """Set a result, or an exception, on a future that is not done
    (a caller may have cancelled or timed out)."""
    if future.done():
        return
    try:
        if isinstance(out, BaseException):
            future.set_exception(out)
        else:
            future.set_result(out)
    except (asyncio.InvalidStateError,
            concurrent.futures.InvalidStateError):
        pass  # cancelled since the check


class SchedulerPool:
    """Per-configuration scheduler pool.

    A serving process usually exposes a handful of retrieval
    configurations (weights / filter / wrrf_k combinations, e.g. the
    app's default hybrid vs a dense-only eval config). Each distinct
    configuration gets its own BatchScheduler and batching queue, all
    sharing the same retriever (and therefore the same device index).
    Schedulers start lazily on first use.
    """

    def __init__(self, retriever, **scheduler_kwargs):
        self.retriever = retriever
        self.kwargs = scheduler_kwargs
        self._pool: Dict[tuple, BatchScheduler] = {}

    @staticmethod
    def _key(weights, filename_type_filter, wrrf_k) -> tuple:
        return (
            tuple(sorted(weights.items())),
            filename_type_filter or None,
            float(wrrf_k),
        )

    async def get(
        self,
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ) -> BatchScheduler:
        key = self._key(weights, filename_type_filter, wrrf_k)
        sched = self._pool.get(key)
        if sched is None:
            sched = BatchScheduler(
                self.retriever,
                dict(weights),
                filename_type_filter,
                wrrf_k,
                **self.kwargs,
            )
            self._pool[key] = sched
        await sched.start()  # idempotent; revives a stopped scheduler
        return sched

    async def submit(
        self,
        q_embs,
        q_terms=None,
        weights: Optional[Dict[str, float]] = None,
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ):
        if weights is None:
            raise ValueError("SchedulerPool.submit requires weights")
        sched = await self.get(weights, filename_type_filter, wrrf_k)
        return await sched.submit(q_embs, q_terms)

    async def submit_many(
        self,
        q_embs,
        q_terms=None,
        weights: Optional[Dict[str, float]] = None,
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ):
        if weights is None:
            raise ValueError("SchedulerPool.submit_many requires weights")
        sched = await self.get(weights, filename_type_filter, wrrf_k)
        return await sched.submit_many(q_embs, q_terms)

    def submit_threadsafe(
        self,
        loop: asyncio.AbstractEventLoop,
        q_embs,
        q_terms=None,
        weights: Optional[Dict[str, float]] = None,
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
        batched: bool = False,
    ) -> concurrent.futures.Future:
        """``submit`` (``batched``: ``submit_many``) from a thread other
        than ``loop``'s, where the pool's schedulers run. A running
        scheduler takes the entry at once; a configuration's first call
        starts its scheduler on ``loop`` and waits for that."""
        if weights is None:
            raise ValueError("SchedulerPool.submit_threadsafe requires "
                             "weights")
        sched = self._pool.get(
            self._key(weights, filename_type_filter, wrrf_k))
        if sched is None or not sched.running:
            sched = asyncio.run_coroutine_threadsafe(
                self.get(weights, filename_type_filter, wrrf_k), loop
            ).result()
        return sched.submit_threadsafe(q_embs, q_terms, batched)

    async def stop(self) -> None:
        # Entries stay for post-mortem stats; their loops are stopped
        # (get() restarts a scheduler's loop on next use).
        for sched in self._pool.values():
            await sched.stop()

    @property
    def stats(self) -> Dict[str, Dict]:
        return {
            str(k): {
                "batches_run": s.batches_run,
                "queries_served": s.queries_served,
                "entries_run": s.entries_run,
                "queue_s": s.queue_s,
            }
            for k, s in self._pool.items()
        }
