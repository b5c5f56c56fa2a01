"""The port's serving layer: the micro-batching scheduler, the feedback
log, the debug trap and the terminal app, against the JAX package's.

Mirrors tests/test_serving.py on the CPU (the port's index on "cpu", its
sharded case on an 8-slot "cpu" mesh), checks the submissions of other
threads (``submit_threadsafe``, the HTTP handlers' path) against the
loop's own, then holds the port's scheduler
against the JAX package's on one synth_corpus: equal fused ids and fused
scores within 1e-6, for single and submit_many traffic and for bf16 rows
(the port carries them as uint16 bits, the JAX package as ml_dtypes
bf16: the same bits). Last, FusedRetriever.retrieve_device driven from 8
threads across index versions, each result equal to a serial call.
"""

import asyncio
import json
import os
import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.retrieval import FusedRetriever as JaxRetriever
from a_nice_rag_tpu.serving import BatchScheduler as JaxScheduler
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.retrieval import FusedRetriever
from a_nice_rag_tpu_torch.serving import BatchScheduler, FeedbackLog

MODEL = "voyage-3-large"
W = {MODEL: 5.0, "BM25": 1.0}
SCORE_ATOL = 1e-6


def _args(c):
    return dict(ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings=c.embeddings, token_lists=c.tokens)


@pytest.fixture(scope="module")
def retriever():
    c = synth_corpus(n_docs=300, dim=32, n_queries=32, seed=91)
    idx = build_index(device="cpu", **_args(c))
    fr = FusedRetriever(idx, (MODEL,), use_bm25=True, similarity_k=10,
                        common_sections_n=5, budget=4096)
    return c, idx, fr


def _run(coro_fn, sched):
    async def main():
        await sched.start()
        try:
            return await asyncio.wait_for(coro_fn(sched), 60)
        finally:
            await sched.stop()

    return asyncio.run(main())


def test_scheduler_batches_concurrent_queries(retriever):
    c, idx, fr = retriever
    sched = BatchScheduler(fr, W, max_wait_ms=20.0, t_max=16)

    async def go(s):
        async def one(i):
            terms = idx.term_ids(c.query_tokens[i])[:16]
            return await s.submit({MODEL: c.query_embeddings[MODEL][i]},
                                  terms)

        return await asyncio.gather(*(one(i) for i in range(16)))

    results = _run(go, sched)
    assert len(results) == 16
    assert sched.queries_served == 16
    # Coalescing: far fewer device calls than queries.
    assert sched.batches_run < 16
    hits = sum(c.gold_ids[i] in [idx.meta.ids[j] for j in ids if j >= 0]
               for i, (ids, _) in enumerate(results))
    assert hits >= 14


def test_scheduler_matches_direct_call(retriever):
    c, idx, fr = retriever
    sched = BatchScheduler(fr, W, max_wait_ms=1.0, t_max=16)

    async def go(s):
        terms = idx.term_ids(c.query_tokens[0])[:16]
        return await s.submit({MODEL: c.query_embeddings[MODEL][0]}, terms)

    ids_s, _ = _run(go, sched)
    terms = np.full((1, 16), -1, np.int32)
    t = idx.term_ids(c.query_tokens[0])[:16]
    terms[0, :len(t)] = t
    fids, _, _ = fr({MODEL: c.query_embeddings[MODEL][:1]}, terms, W, None,
                    40.0)
    np.testing.assert_array_equal(ids_s, fids[0])


def test_feedback_log_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "fb.json")
    log = FeedbackLog(path)
    log.record("q1", "a1", "up", "fake-llm", [{"source": "NG1"}])
    log.record("q2", "a2", "down")
    entries = log.entries()
    assert len(entries) == 2
    assert entries[0]["rating"] == "up"
    assert entries[1]["query"] == "q2"
    with open(path) as f:
        raw = json.load(f)
    assert isinstance(raw, list) and len(raw) == 2


def test_debug_flags_catch_nans():
    from a_nice_rag_tpu_torch.utils.debugging import (
        disable_debug,
        enable_debug,
    )

    enable_debug(nans=True)
    try:
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(4)) * 0
    finally:
        disable_debug()
    # And clean afterwards.
    assert bool(torch.isnan(torch.tensor(float("nan"))).all())
    enable_debug(nans=False, infs=True)
    try:
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(4))
    finally:
        disable_debug()


def test_deterministic_mode(monkeypatch):
    from a_nice_rag_tpu_torch.utils.debugging import deterministic_mode

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = torch.are_deterministic_algorithms_enabled()
    try:
        deterministic_mode()
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(before)


def test_device_profile_writes_trace(tmp_path):
    from a_nice_rag_tpu_torch.utils.trace import device_profile

    with device_profile(str(tmp_path)) as prof:
        torch.ones((8, 8)).sum()
    assert os.path.exists(prof.trace_path)


def test_terminal_app_loop(monkeypatch, tmp_path, capsys):
    from a_nice_rag_tpu_torch.config import InfoSource
    from a_nice_rag_tpu_torch.rag import FakeLLMClient, RAGSystem
    from a_nice_rag_tpu_torch.retrieval.embed import PrecomputedEmbedder
    from a_nice_rag_tpu_torch.serving import app as app_mod

    c = synth_corpus(n_docs=80, dim=16, n_queries=2, seed=171)
    idx = build_index(urls=c.urls, device="cpu", **_args(c))
    system = RAGSystem(
        indexes={InfoSource.NICE: idx},
        embedder=PrecomputedEmbedder(
            {"what now?": c.query_embeddings[MODEL][0]}),
        llm_clients={"fake": FakeLLMClient()}, device="cpu",
    )
    feed = iter(["what now?", "u", ""])
    monkeypatch.setattr("builtins.input", lambda *a: next(feed))
    monkeypatch.chdir(tmp_path)
    app_mod.run_terminal(system, llm_model="fake-llm")
    out = capsys.readouterr().out
    assert "[fake:fake-llm]" in out
    assert "--- sources ---" in out
    # Thumbs-up got recorded.
    entries = FeedbackLog(
        str(tmp_path / "feedback/query_feedback.json")).entries()
    assert len(entries) == 1 and entries[0]["rating"] == "up"


def test_adaptive_wait_policy(retriever):
    c, idx, fr = retriever
    sched = BatchScheduler(fr, {MODEL: 1.0}, max_wait_ms=2.0, adaptive=True)
    # No estimate yet: fall back to the cap.
    assert sched._adaptive_wait_s() == pytest.approx(0.002)
    # Light load (1 query / 100 ms): ship immediately.
    sched._inter_ewma_s = 0.1
    assert sched._adaptive_wait_s() == 0.0
    # Heavy load (1 query / us): wait only as long as filling max_batch
    # takes, well under the cap.
    sched._inter_ewma_s = 1e-6
    w = sched._adaptive_wait_s()
    assert 0 < w <= 256 * 1e-6 + 1e-9
    # adaptive off: always the cap.
    sched.adaptive = False
    assert sched._adaptive_wait_s() == pytest.approx(0.002)


def test_adaptive_scheduler_serves_bursts(retriever):
    c, idx, fr = retriever
    sched = BatchScheduler(fr, W, max_wait_ms=5.0, t_max=16, adaptive=True)

    async def go(s):
        async def one(i):
            terms = idx.term_ids(c.query_tokens[i])[:16]
            return await s.submit({MODEL: c.query_embeddings[MODEL][i]},
                                  terms)

        # Burst, pause, single query (exercises the no-wait branch).
        burst = await asyncio.gather(*(one(i) for i in range(8)))
        await asyncio.sleep(0.05)
        return burst + [await one(8)]

    results = _run(go, sched)
    assert len(results) == 9 and sched.queries_served == 9
    hits = sum(c.gold_ids[i] in [idx.meta.ids[j] for j in ids if j >= 0]
               for i, (ids, _) in enumerate(results))
    assert hits >= 8


def test_scheduler_pool_per_configuration(retriever):
    from a_nice_rag_tpu_torch.serving import SchedulerPool

    c, idx, fr = retriever

    async def run():
        pool = SchedulerPool(fr, max_wait_ms=2.0, t_max=16)
        try:
            terms = idx.term_ids(c.query_tokens[0])[:16]
            q = {MODEL: c.query_embeddings[MODEL][0]}
            ids_h, _ = await pool.submit(q, terms, weights=W)
            ids_d, _ = await pool.submit(q, terms, weights={MODEL: 1.0})
            # Same config key -> same scheduler instance (no new entry).
            await pool.submit(q, terms, weights={"BM25": 1.0, MODEL: 5.0})
            return pool, ids_h, ids_d
        finally:
            await pool.stop()

    pool, ids_h, ids_d = asyncio.run(asyncio.wait_for(run(), 60))
    assert len(pool.stats) == 2  # two distinct configurations
    terms = idx.pad_term_ids([c.query_tokens[0]], 16)
    f_ids, _, _ = fr({MODEL: c.query_embeddings[MODEL][:1]}, terms, W)
    np.testing.assert_array_equal(ids_h, f_ids[0])


def test_scheduler_over_sharded_retriever():
    """The micro-batch scheduler serves a sharded retriever (8 "cpu"
    slots; the bucket is a power of two, a multiple of dp = 1)."""
    from a_nice_rag_tpu_torch.parallel import (
        ShardedRetriever,
        make_mesh,
        shard_index,
    )

    c = synth_corpus(n_docs=512, dim=32, n_queries=16, seed=95)
    idx = build_index(device="cpu", **_args(c))
    sidx = shard_index(idx, make_mesh(shape=(1, 8), devices=["cpu"] * 8))
    sr = ShardedRetriever(sidx, model_names=(MODEL,), use_bm25=True,
                          similarity_k=10, common_sections_n=5, budget=2048)
    sched = BatchScheduler(sr, W, max_wait_ms=20.0, t_max=16)

    async def go(s):
        async def one(i):
            terms = idx.term_ids(c.query_tokens[i])[:16]
            return await s.submit({MODEL: c.query_embeddings[MODEL][i]},
                                  terms)

        return await asyncio.gather(*(one(i) for i in range(12)))

    results = _run(go, sched)
    assert len(results) == 12 and sched.queries_served == 12
    hits = sum(c.gold_ids[i] in [idx.meta.ids[j] for j in ids if j >= 0]
               for i, (ids, _) in enumerate(results))
    assert hits >= 8, hits


def test_submit_many_coalesces_with_single_queries(retriever):
    """A client batch (one queue entry carrying B rows) returns per-row
    results equal to B single submits, and coalesces with concurrent
    single-query traffic."""
    c, idx, fr = retriever
    sched = BatchScheduler(fr, W, max_batch=64, max_wait_ms=5.0, t_max=16)

    async def go(s):
        q = c.query_embeddings[MODEL]
        terms = np.asarray(idx.pad_term_ids(c.query_tokens, 16))

        async def single(i):
            return await s.submit({MODEL: q[i]}, terms[i])

        block = s.submit_many({MODEL: q[4:12]}, terms[4:12])
        singles = asyncio.gather(*(single(i) for i in range(4)))
        (rows_b, scores_b), _ = await asyncio.gather(block, singles)
        assert rows_b.shape[0] == 8
        for j, i in enumerate(range(4, 12)):
            r1, s1 = await s.submit({MODEL: q[i]}, terms[i])
            np.testing.assert_array_equal(rows_b[j], r1)
            np.testing.assert_allclose(scores_b[j], s1, rtol=1e-5)
        assert s.queries_served >= 8 + 4

    _run(go, sched)


def test_submit_many_single_row_keeps_batch_axis(retriever):
    """A 1-row client batch comes back [1, n], not squeezed to the
    submit() 1-D form."""
    c, idx, fr = retriever
    sched = BatchScheduler(fr, W, max_wait_ms=1.0, t_max=16)

    async def go(s):
        q = c.query_embeddings[MODEL][:1]
        terms = np.asarray(idx.pad_term_ids(c.query_tokens[:1], 16))
        rows, scores = await s.submit_many({MODEL: q}, terms)
        assert rows.ndim == 2 and rows.shape[0] == 1
        assert scores.ndim == 2 and scores.shape[0] == 1
        r1, _ = await s.submit({MODEL: q[0]}, terms[0])
        assert r1.ndim == 1
        np.testing.assert_array_equal(rows[0], r1)

    _run(go, sched)


def _loop_thread():
    """An event loop running on its own thread, as serve_state runs the
    scheduler pool's; ``_close`` ends both."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    return loop, thread


def _close(loop, thread):
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=10)
    assert not thread.is_alive()
    loop.close()


def _on(loop, coro, timeout=60):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


def test_submit_threadsafe_matches_submit(retriever):
    """Entries submitted from another thread (the HTTP handlers' path)
    in a burst coalesce into shared batches, and the futures the worker
    thread resolves hold what submit / submit_many return: a single
    query's 1-D rows, a client batch's leading rows axis, even at one
    row."""
    c, idx, fr = retriever
    q = c.query_embeddings[MODEL]
    terms = np.asarray(idx.pad_term_ids(c.query_tokens, 16))
    loop, loop_t = _loop_thread()
    sched = BatchScheduler(fr, W, max_batch=64, max_wait_ms=20.0, t_max=16)
    _on(loop, sched.start())
    try:
        singles = [sched.submit_threadsafe({MODEL: q[i]}, terms[i])
                   for i in range(6)]
        block = sched.submit_threadsafe({MODEL: q[6:10]}, terms[6:10],
                                        batched=True)
        one_row = sched.submit_threadsafe({MODEL: q[:1]}, terms[:1],
                                          batched=True)
        got = [f.result(60) for f in singles]
        rows_b, scores_b = block.result(60)
        rows_1, scores_1 = one_row.result(60)
        assert sched.queries_served == 11 and sched.batches_run < 8

        async def serial():
            return [await sched.submit({MODEL: q[i]}, terms[i])
                    for i in range(10)]

        want = _on(loop, serial())
    finally:
        _on(loop, sched.stop())
        _close(loop, loop_t)
    for i in range(6):
        assert got[i][0].ndim == 1
        np.testing.assert_array_equal(got[i][0], want[i][0])
        np.testing.assert_allclose(got[i][1], want[i][1], rtol=1e-5)
    assert rows_b.shape[0] == 4
    for j, i in enumerate(range(6, 10)):
        np.testing.assert_array_equal(rows_b[j], want[i][0])
        np.testing.assert_allclose(scores_b[j], want[i][1], rtol=1e-5)
    assert rows_1.ndim == 2 and rows_1.shape[0] == 1
    np.testing.assert_array_equal(rows_1[0], want[0][0])
    np.testing.assert_allclose(scores_1[0], want[0][1], rtol=1e-5)


class _Recording:
    """A retriever that notes the thread of each device call."""

    def __init__(self, fr):
        self.fr, self.threads = fr, []
        self.model_names, self.use_bm25 = fr.model_names, fr.use_bm25
        self.device = fr.device

    def retrieve_device(self, *args):
        self.threads.append(threading.get_ident())
        return self.fr.retrieve_device(*args)


def test_submit_threadsafe_runs_a_lone_entry_on_the_callers_thread(
        retriever):
    """Under light load (the adaptive wait 0), an entry with nothing
    queued and a batch slot free runs on the caller's thread: its future
    is done on return. With every slot taken, or with a collect wait, it
    goes through the loop to a worker thread instead."""
    c, idx, fr = retriever
    q = c.query_embeddings[MODEL]
    terms = np.asarray(idx.pad_term_ids(c.query_tokens, 16))
    rec = _Recording(fr)
    loop, loop_t = _loop_thread()
    sched = BatchScheduler(rec, W, max_wait_ms=2.0, t_max=16,
                           max_inflight=2)
    _on(loop, sched.start())
    me = threading.get_ident()
    try:
        sched._inter_ewma_s = 0.1  # one query a 100 ms
        fut = sched.submit_threadsafe({MODEL: q[0]}, terms[0])
        assert fut.done() and rec.threads == [me]
        block = sched.submit_threadsafe({MODEL: q[:3]}, terms[:3],
                                        batched=True)
        assert block.done() and rec.threads == [me, me]
        for _ in range(2):
            assert sched._slots.acquire(blocking=False)
        sched._inter_ewma_s = 0.1
        queued = sched.submit_threadsafe({MODEL: q[1]}, terms[1])
        assert not queued.done()
        sched._slots.release()
        sched._slots.release()
        ids_q, _ = queued.result(60)
        assert rec.threads[-1] != me
        sched.adaptive = False  # a collect wait: the loop takes it
        waited = sched.submit_threadsafe({MODEL: q[2]}, terms[2])
        waited.result(60)
        assert rec.threads[-1] != me and len(rec.threads) == 4

        async def serial():
            return [await sched.submit({MODEL: q[i]}, terms[i])
                    for i in range(3)]

        want = _on(loop, serial())
    finally:
        _on(loop, sched.stop())
        _close(loop, loop_t)
    np.testing.assert_array_equal(fut.result()[0], want[0][0])
    np.testing.assert_array_equal(block.result()[0],
                                  np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(ids_q, want[1][0])
    np.testing.assert_array_equal(waited.result()[0], want[2][0])
    assert sched.batches_run == 7 and sched.queries_served == 9


def test_submit_threadsafe_under_many_threads(retriever):
    """16 threads submit through submit_threadsafe, single queries and
    client batches, while the interpreter switches threads every
    microsecond: the lone-entry runs and the loop's batches share the
    slots. Every reply equals a serial call's, no query is lost from the
    counters and every batch slot comes back."""
    c, idx, fr = retriever
    q = c.query_embeddings[MODEL]
    terms = np.asarray(idx.pad_term_ids(c.query_tokens, 16))
    loop, loop_t = _loop_thread()
    sched = BatchScheduler(fr, W, max_batch=16, max_wait_ms=1.0, t_max=16,
                           max_inflight=2)
    _on(loop, sched.start())

    async def serial():
        return [await sched.submit({MODEL: q[i]}, terms[i])
                for i in range(8)]

    want = _on(loop, serial())
    base = sched.queries_served
    errors = []

    def worker(w_id):
        try:
            for i in range(12):
                r = (w_id + i) % 8
                if i % 3 == 2:
                    rows, _ = sched.submit_threadsafe(
                        {MODEL: q[r:r + 1]}, terms[r:r + 1],
                        batched=True).result(60)
                    rows = rows[0]
                else:
                    rows, _ = sched.submit_threadsafe(
                        {MODEL: q[r]}, terms[r]).result(60)
                np.testing.assert_array_equal(rows, want[r][0])
                if i % 4 == 3:
                    sched._inter_ewma_s = 0.1  # light load: run it here
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
        _on(loop, sched.stop())
        _close(loop, loop_t)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert sched.queries_served - base == 16 * 12
    for _ in range(2):
        assert sched._slots.acquire(blocking=False)


class _FailingRetriever:
    model_names = (MODEL,)
    use_bm25 = True
    device = torch.device("cpu")

    def retrieve_device(self, *args):
        raise RuntimeError("device call failed")


def test_submit_threadsafe_raises_the_batch_error(retriever):
    """A batch that fails raises its error from every entry's future: the
    worker-resolved, the loop-resolved and one the caller ran alone,
    whose batch slot comes back; a scheduler that was never started
    refuses the entry."""
    c, idx, _ = retriever
    q = c.query_embeddings[MODEL]
    terms = np.asarray(idx.pad_term_ids(c.query_tokens, 16))
    sched = BatchScheduler(_FailingRetriever(), W, max_wait_ms=20.0,
                           t_max=16)
    with pytest.raises(RuntimeError, match="started scheduler"):
        sched.submit_threadsafe({MODEL: q[0]}, terms[0])
    loop, loop_t = _loop_thread()
    _on(loop, sched.start())
    try:
        fut = sched.submit_threadsafe({MODEL: q[0]}, terms[0])
        coro = asyncio.run_coroutine_threadsafe(
            sched.submit({MODEL: q[1]}, terms[1]), loop)
        for f in (fut, coro):
            with pytest.raises(RuntimeError, match="device call failed"):
                f.result(60)
        sched._inter_ewma_s = 0.1  # light load: the caller runs it
        lone = sched.submit_threadsafe({MODEL: q[2]}, terms[2])
        assert lone.done()
        with pytest.raises(RuntimeError, match="device call failed"):
            lone.result()
        assert sched._slots.acquire(blocking=False)  # the slot came back
        sched._slots.release()
    finally:
        _on(loop, sched.stop())
        _close(loop, loop_t)


def test_pool_submit_threadsafe_starts_each_configuration(retriever):
    """SchedulerPool.submit_threadsafe starts a configuration's scheduler
    on the loop at its first call, reuses it after, and restarts it once
    the pool was stopped; the rows equal a direct call's."""
    from a_nice_rag_tpu_torch.serving import SchedulerPool

    c, idx, fr = retriever
    q = {MODEL: c.query_embeddings[MODEL][0]}
    terms = idx.pad_term_ids([c.query_tokens[0]], 16)
    loop, loop_t = _loop_thread()
    pool = SchedulerPool(fr, max_wait_ms=2.0, t_max=16)
    try:
        ids_h, _ = pool.submit_threadsafe(loop, q, terms[0],
                                          weights=W).result(60)
        sched = next(iter(pool._pool.values()))
        pool.submit_threadsafe(loop, q, terms[0],
                               weights={"BM25": 1.0, MODEL: 5.0}).result(60)
        pool.submit_threadsafe(loop, q, terms[0],
                               weights={MODEL: 1.0}).result(60)
        assert len(pool.stats) == 2
        assert next(iter(pool._pool.values())) is sched
        assert sched.queries_served == 2
        _on(loop, pool.stop())
        assert not sched.running
        pool.submit_threadsafe(loop, q, terms[0], weights=W).result(60)
        assert sched.running and sched.queries_served == 3
        with pytest.raises(ValueError, match="requires weights"):
            pool.submit_threadsafe(loop, q, terms[0])
    finally:
        _on(loop, pool.stop())
        _close(loop, loop_t)
    f_ids, _, _ = fr({MODEL: c.query_embeddings[MODEL][:1]}, terms, W)
    np.testing.assert_array_equal(ids_h, f_ids[0])


# -- parity with the JAX package's scheduler --------------------------------


@pytest.fixture(scope="module")
def pair():
    c = synth_corpus(n_docs=400, dim=32, n_queries=24, seed=93)
    kw = dict(use_bm25=True, similarity_k=10, common_sections_n=5,
              budget=4096)
    jfr = JaxRetriever(jax_build_index(**_args(c)), (MODEL,), **kw)
    idx = build_index(device="cpu", **_args(c))
    return c, idx, jfr, FusedRetriever(idx, (MODEL,), **kw)


def _serve(sched_cls, fr, q, terms, many):
    """Every row through one scheduler: submit_many blocks of 8 rows, or
    one submit per row, all concurrent."""
    sched = sched_cls(fr, W, max_batch=16, max_wait_ms=5.0, t_max=16)

    async def go(s):
        if many:
            outs = await asyncio.gather(*(
                s.submit_many({MODEL: q[i:i + 8]}, terms[i:i + 8])
                for i in range(0, len(q), 8)))
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]))
        outs = await asyncio.gather(*(s.submit({MODEL: q[i]}, terms[i])
                                      for i in range(len(q))))
        return np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])

    return _run(go, sched)


@pytest.mark.parametrize("many", [False, True], ids=["single", "many"])
def test_scheduler_parity_with_jax(pair, many):
    c, idx, jfr, fr = pair
    q = np.asarray(c.query_embeddings[MODEL], np.float32)
    terms = np.asarray(idx.pad_term_ids(c.query_tokens, 16), np.int32)
    j_ids, j_scores = _serve(JaxScheduler, jfr, q, terms, many)
    t_ids, t_scores = _serve(BatchScheduler, fr, q, terms, many)
    np.testing.assert_array_equal(t_ids, np.asarray(j_ids))
    np.testing.assert_allclose(t_scores, np.asarray(j_scores), rtol=0,
                               atol=SCORE_ATOL)


def test_bf16_bits_parity_with_jax(pair):
    """bf16 rows: the port's uint16 bits and the JAX package's ml_dtypes
    rows hold the same values, coalesce half-width and give the same
    fused ids (and scores within 1e-6)."""
    from a_nice_rag_tpu_torch.serving.native_front import bf16_bits

    c, idx, jfr, fr = pair
    q = np.asarray(c.query_embeddings[MODEL], np.float32)
    qb = q.astype(ml_dtypes.bfloat16)
    bits = bf16_bits(q)
    np.testing.assert_array_equal(bits, qb.view(np.uint16))
    terms = np.asarray(idx.pad_term_ids(c.query_tokens, 16), np.int32)
    j_ids, j_scores = _serve(JaxScheduler, jfr, qb, terms, True)
    t_ids, t_scores = _serve(BatchScheduler, fr, bits, terms, True)
    np.testing.assert_array_equal(t_ids, np.asarray(j_ids))
    np.testing.assert_allclose(t_scores, np.asarray(j_scores), rtol=0,
                               atol=SCORE_ATOL)
    # The same as f32 rows holding the bf16 values.
    f_ids, _ = _serve(BatchScheduler, fr, qb.astype(np.float32), terms,
                      True)
    np.testing.assert_array_equal(t_ids, f_ids)


# -- retrieve_device under the fronts' dispatch threads -------------------


def test_retrieve_device_is_thread_safe(pair):
    """8 threads call retrieve_device (three filters, forty weightings)
    while the index's version moves under them, which evicts the cached
    masks as new weights and masks are cached; the interpreter switches
    threads every microsecond. Every result equals a serial call's."""
    c, idx, _, fr = pair
    q = np.asarray(c.query_embeddings[MODEL][:4], np.float32)
    terms = np.asarray(idx.pad_term_ids(c.query_tokens[:4], 16), np.int32)
    calls = [(f, {MODEL: 5.0 + 0.01 * j, "BM25": 1.0})
             for f in (None, "CG", "NG") for j in range(40)]
    want = [fr.retrieve_device({MODEL: q}, terms, w, f, 40.0)
            for f, w in calls]
    fr._const_cache.clear()
    errors, done = [], threading.Event()

    def worker(w_id):
        try:
            for i in range(len(calls)):
                j = (w_id * 17 + i) % len(calls)
                f, w = calls[j]
                got = fr.retrieve_device({MODEL: q}, terms, w, f, 40.0)
                for a, b in zip(got, want[j]):
                    assert torch.equal(a, b), (w_id, i, f)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def bump():
        while not done.wait(0.0002):
            idx._version += 1

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        bumper = threading.Thread(target=bump, daemon=True)
        bumper.start()
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        done.set()
        bumper.join(timeout=10)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert idx._version > 0


def test_launch_counts_survive_concurrent_calls():
    """The served fronts call the kernels from several dispatch threads:
    ``count_launch`` from more threads than cores, with the interpreter's
    switch interval shortened, loses no launch."""
    import sys
    import threading

    from a_nice_rag_tpu_torch.ops.kernels._launches import count_launch

    def kernel():
        pass

    kernel.launches = 0

    def bump():
        for _ in range(2000):
            count_launch(kernel)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert kernel.launches == 16 * 2000
