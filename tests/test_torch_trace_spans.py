"""The port's spans (``utils/trace.span``) in the served path, and the
scheduler's queue counters.

With no profiler recording, ``span`` is one shared null context and never
calls ``record_function``; under a profile of every thread
(``device_profile``), a CPU ``FusedRetriever`` served through a
``BatchScheduler`` shows ``sched.batch`` around ``sched.assemble``,
``retriever`` (around ``retriever.upload``, ``dense``, ``bm25`` and
``fusion``) and ``sched.download``, on the worker thread that ran a queued
batch and on the caller's thread for a lone entry. ``queue_s`` and
``entries_run`` count the entries of both paths.
"""

import asyncio
import concurrent.futures
import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.retrieval import FusedRetriever
from a_nice_rag_tpu_torch.serving import BatchScheduler, SchedulerPool
from a_nice_rag_tpu_torch.testing import synth_corpus
from a_nice_rag_tpu_torch.utils.trace import QueryTrace, device_profile, span

MODEL = "voyage-3-large"
W = {MODEL: 5.0, "BM25": 1.0}
INNER = {
    "sched.batch": {"sched.assemble", "retriever", "sched.download"},
    "retriever": {"retriever.upload", "dense", "bm25", "fusion"},
}


@pytest.fixture(scope="module")
def served():
    c = synth_corpus(n_docs=300, dim=32, n_queries=16, seed=93)
    idx = build_index(device="cpu", ids=c.ids, sources=c.sources,
                      contents=c.contents, embeddings=c.embeddings,
                      token_lists=c.tokens)
    fr = FusedRetriever(idx, (MODEL,), use_bm25=True, similarity_k=10,
                        common_sections_n=5, budget=4096)
    q = c.query_embeddings[MODEL]
    terms = np.asarray(idx.pad_term_ids(c.query_tokens, 16))
    return fr, q, terms


@contextlib.contextmanager
def _scheduler(fr, **kw):
    """A started scheduler on an event loop of its own thread."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    sched = BatchScheduler(fr, W, max_wait_ms=2.0, t_max=16, **kw)
    asyncio.run_coroutine_threadsafe(sched.start(), loop).result(60)
    try:
        yield sched
    finally:
        asyncio.run_coroutine_threadsafe(sched.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        assert not thread.is_alive()
        loop.close()


def _annotations(path):
    """Program spans of a Chrome trace: thread id -> [(name, start, end)]."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            out.setdefault(e["tid"], []).append(
                (e["name"], e["ts"], e["ts"] + e["dur"]))
    return out


def _check_nesting(spans):
    """Each span of INNER holds its inner spans (one batch's worth)."""
    by_name = {}
    for name, a, b in spans:
        by_name.setdefault(name, []).append((a, b))
    for outer, inner in INNER.items():
        assert len(by_name.get(outer, ())) == 1, sorted(by_name)
        a0, b0 = by_name[outer][0]
        for name in inner:
            assert len(by_name.get(name, ())) == 1, (name, sorted(by_name))
            a, b = by_name[name][0]
            assert a0 <= a and b <= b0, (outer, name)


def test_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    first, second = span("sched.batch"), span("bm25")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first:
        pass
    assert calls == []


def test_span_records_on_every_thread_under_a_profile(tmp_path):
    """Under ``device_profile`` a span is a ``record_function`` range,
    recorded on the thread that opened it, the profile's thread or
    another one."""
    tids = []

    def work(name):
        tids.append(threading.get_native_id())
        with span(name) as s:
            assert isinstance(s, torch.profiler.record_function)
            torch.ones(4).sum()

    with device_profile(str(tmp_path)) as prof:
        work("on.main")
        t = threading.Thread(target=work, args=("on.thread",))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    got = _annotations(prof.trace_path)
    assert [n for n, _, _ in got[tids[0]]] == ["on.main"]
    assert [n for n, _, _ in got[tids[1]]] == ["on.thread"]


@pytest.mark.parametrize("lone", [True, False], ids=["lone", "queued"])
def test_served_batch_spans_on_the_thread_that_ran_it(served, tmp_path,
                                                      lone):
    """A lone entry runs, and its spans lie, on the caller's thread; a
    queued one on the worker thread that ran its batch."""
    fr, q, terms = served
    me = threading.get_native_id()
    with _scheduler(fr, adaptive=lone) as sched:
        if lone:
            sched._inter_ewma_s = 0.1  # one query a 100 ms: no wait
        with device_profile(str(tmp_path)) as prof:
            fut = sched.submit_threadsafe({MODEL: q[0]}, terms[0])
            assert fut.done() == lone
            ids, _ = fut.result(60)
    assert ids.shape == (5,)
    got = _annotations(prof.trace_path)
    ran = [tid for tid, s in got.items()
           if any(n == "sched.batch" for n, _, _ in s)]
    assert ran == [me] if lone else (len(ran) == 1 and ran[0] != me)
    _check_nesting(got[ran[0]])


def test_queue_counters_count_lone_and_queued_entries(served):
    """Lone entries wait next to nothing; queued ones wait for a slot.
    ``entries_run`` counts both paths, ``queue_s`` sums their waits."""
    fr, q, terms = served
    hold_s = 0.05
    with _scheduler(fr, max_inflight=2) as sched:
        sched._inter_ewma_s = 0.1
        sched.submit_threadsafe({MODEL: q[0]}, terms[0]).result(60)
        sched.submit_threadsafe({MODEL: q[1:4]}, terms[1:4],
                                batched=True).result(60)
        assert sched.entries_run == 2 and 0.0 <= sched.queue_s < hold_s
        lone_s = sched.queue_s
        for _ in range(2):
            assert sched._slots.acquire(blocking=False)
        queued = [sched.submit_threadsafe({MODEL: q[i]}, terms[i])
                  for i in (4, 5)]
        time.sleep(hold_s)
        assert not any(f.done() for f in queued)
        sched._slots.release()
        sched._slots.release()
        for f in queued:
            f.result(60)
        assert sched.entries_run == 4
        assert sched.queue_s - lone_s >= 2 * hold_s
        assert sched.batches_run >= 3 and sched.queries_served == 6


def test_pool_stats_sum_the_entries_sent(served):
    """Eight threads send three entries each through one pool: its
    stats hold ``entries_run`` equal to the entries sent and a
    non-negative ``queue_s``, beside ``batches_run`` and
    ``queries_served``."""
    fr, q, terms = served
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    pool = SchedulerPool(fr, max_wait_ms=1.0, t_max=16)

    def client(c):
        for j in range(3):
            i = (3 * c + j) % q.shape[0]
            pool.submit_threadsafe(loop, {MODEL: q[i]}, terms[i],
                                   weights=W).result(60)

    try:
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            for f in [ex.submit(client, c) for c in range(8)]:
                f.result(120)
        (stats,) = pool.stats.values()
    finally:
        asyncio.run_coroutine_threadsafe(pool.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()
    assert stats["entries_run"] == stats["queries_served"] == 24
    assert stats["queue_s"] >= 0.0 and 1 <= stats["batches_run"] <= 24


def test_query_trace_times_its_spans_on_the_shared_helper(tmp_path):
    """``QueryTrace.span`` keeps each stage's seconds and is a program
    span under a profile."""
    trace = QueryTrace()
    with device_profile(str(tmp_path)) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                time.sleep(0.01)
    assert trace.durations["outer"] >= trace.durations["inner"] >= 0.01
    got = _annotations(prof.trace_path)[threading.get_native_id()]
    assert sorted(n for n, _, _ in got) == ["inner", "outer"]
