"""The program spans of a traced window (``harness/spans.py``) on
synthetic Chrome traces, and ``trace_threads.py`` at the cells'
rehearsal size."""

import json

import pytest

from benchmark import trace_threads
from benchmark.harness import spans, trace
from benchmark.harness.spec import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 991
A, B = 101, 202  # two host threads


def _x(cat, name, ts, dur, tid=0, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _traces(events):
    return trace.parse(events), spans.parse(events)


def test_device_time_goes_to_the_launching_threads_span():
    """Two threads' launches interleave on one stream. Each kernel counts
    to the span its own launch lies in, even where it runs inside the
    other thread's span range or under a device-side annotation of the
    other batch."""
    events = [
        _x("user_annotation", "bm25", 0, 100, tid=A),
        _x("user_annotation", "retriever", 0, 120, tid=A),
        _x("user_annotation", "dense", 50, 50, tid=B),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, tid=A, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 2, tid=B, corr=2),
        _x("cuda_driver", "cuLaunchKernelEx", 90, 2, tid=A, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 130, 2, tid=B, corr=4),
        _x("kernel", "sort", 200, 10, corr=1),
        _x("kernel", "topk", 210, 50, corr=2),
        _x("kernel", "scan", 260, 40, corr=3),
        _x("gpu_memcpy", "Memcpy DtoH", 300, 5, corr=4),
        _x("kernel", "no launch", 310, 5, corr=9),
        _x("gpu_user_annotation", "bm25", 200, 100, tid=7),
    ]
    _, sp = _traces(events)
    got = spans.span_device_s(sp)
    assert got == pytest.approx({"bm25": 50e-6, "retriever": 50e-6,
                                 "dense": 50e-6})
    assert set(sp.spans) == {A, B} and len(sp.device) == 5


def test_gap_labels_follow_the_launching_thread_then_any_thread():
    events = [
        # Gap [10, 30], ended by B's copy: B is in retriever.upload's
        # aten::copy_ at 20, though A's aten::where is shorter there.
        _x("kernel", "k0", 0, 10, corr=1),
        _x("gpu_memcpy", "Memcpy HtoD", 30, 10, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 0, 1, tid=A, corr=1),
        _x("cuda_runtime", "cudaMemcpyAsync", 29, 1, tid=B, corr=2),
        _x("user_annotation", "retriever.upload", 15, 20, tid=B),
        _x("cpu_op", "aten::copy_", 18, 7, tid=B),
        _x("cpu_op", "aten::where", 19, 2, tid=A),
        _x("cpu_op", "aten::sort", 0, 50, tid=A),
        # Gap [40, 60], ended by an op with no launch in the trace: the
        # innermost host op of any thread, aten::sort.
        _x("kernel", "k2", 60, 10, corr=3),
        # Gap [70, 100], ended by B's kernel; B is in `dense` with no op.
        _x("kernel", "k3", 100, 10, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 99, 1, tid=B, corr=4),
        _x("user_annotation", "dense", 80, 20, tid=B),
        # Gap [110, 200], ended by A's kernel; A has nothing at 155 and
        # nor has any thread: no host op.
        _x("kernel", "k4", 200, 10, corr=5),
        _x("cuda_runtime", "cudaLaunchKernel", 199, 1, tid=A, corr=5),
    ]
    tr, sp = _traces(events)
    assert spans.gap_labels(tr, sp) == pytest.approx({
        "retriever.upload > aten::copy_": 20e-6, "aten::sort": 20e-6,
        "dense": 30e-6, "no host op": 90e-6})
    # The old rule, for the same gaps.
    assert dict(trace.breakdown(tr)["idle_gaps"]) == pytest.approx({
        "aten::where": 20e-6, "aten::sort": 20e-6, "no host op": 120e-6})


def test_no_launches_or_spans_give_todays_idle_gaps_exactly():
    events = [
        _x("kernel", "a", 0, 10), _x("kernel", "b", 5, 20),
        _x("gpu_memset", "c", 40, 5), _x("kernel", "d", 47, 1),
        _x("gpu_memcpy", "e", 80, 3), _x("kernel", "f", 90.5, 2),
        _x("kernel", "g", 200, 1),
        _x("cpu_op", "aten::copy_", 30, 30, tid=A),
        _x("cpu_op", "aten::empty", 35, 1, tid=B),
        _x("cpu_op", "aten::sum", 60, 40, tid=A),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
    ]
    tr, sp = _traces(events)
    want = trace.breakdown(tr, top=1000)["idle_gaps"]
    got = spans.gap_labels(tr, sp)
    assert got == dict(want) and len(got) == 3


def test_not_begun_counts_gaps_before_the_next_batch_started():
    """The gap before B's first kernel counts: B's batch began after the
    device went idle. The gap before B's second kernel does not."""
    events = [
        _x("user_annotation", "sched.batch", 0, 50, tid=A),
        _x("user_annotation", "sched.batch", 60, 60, tid=B),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, tid=A, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 70, 1, tid=B, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 95, 1, tid=B, corr=3),
        _x("kernel", "k1", 12, 28, corr=1),
        _x("kernel", "k2", 71, 9, corr=2),
        _x("kernel", "k3", 100, 10, corr=3),
    ]
    assert spans.not_begun_s(_traces(events)[1]) == pytest.approx(31e-6)


def test_readings_are_none_where_the_span_or_counter_is_missing():
    """msmarco's batches have no bm25 or fusion span; a program without
    the counters gives no queue reading."""
    events = [
        _x("user_annotation", "dense", 0, 100, tid=A),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, tid=A, corr=1),
        _x("kernel", "topk", 200, 10, corr=1),
    ]
    got = spans.span_device_s(_traces(events)[1])
    assert "bm25" not in got and "fusion" not in got
    assert spans.queue_ms({"batches_run": 3, "queries_served": 9}) is None
    assert spans.queue_ms({"entries_run": 0, "queue_s": 0.0}) is None
    assert spans.queue_ms({"entries_run": 4, "queue_s": 0.5}) == 125.0


@pytest.mark.parametrize("all_threads", [False, True])
def test_only_an_every_thread_profile_records_other_threads_spans(
        all_threads, tmp_path):
    """``run.py``'s profile records the spans of the thread that opened
    it alone; the batches run on the pool's worker and client threads."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from a_nice_rag_tpu_torch.utils.trace import span

    def work():
        with span("on.thread"):
            pass

    kw = ({"experimental_config": spans.all_threads_config()}
          if all_threads else {})
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        with span("on.main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    sp = spans.load(str(tmp_path / "trace.json"))[1]
    names = {n for items in sp.spans.values() for n, _, _ in items}
    assert "on.main" in names
    assert ("on.thread" in names) == all_threads
    assert len(sp.spans) == (2 if all_threads else 1)


@pytest.mark.parametrize("cell", CELLS)
def test_trace_threads_rehearsal(cell, capsys):
    """Profiled on every thread, the program's spans and the pool's
    counters are in the probe's line, and the replies are judged."""
    assert trace_threads.main([
        "--workload", cell, "--seed", str(SEED), "--seconds", "1",
        "--rehearse"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["threads_with_spans"] > 0
    assert out["queue_ms"] > 0 and out["stats"]["entries_run"] > 0
    assert out["metrics"]["sched.rows_per_batch"] > 0
    assert "device" not in out
