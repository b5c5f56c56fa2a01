"""Trace one cell's window on every thread and read the program's spans.

    python3 benchmark/trace_threads.py --workload <cell> --seed <n> \\
        --seconds <s> [--rehearse]

From the root of a checkout. Runs the cell's driver (``runner.run`` for
retrieval) as ``run.py --trace 1`` does (the same set-up, traffic,
window and check), with hooks for the length of the call:
``torch.profiler`` records the host operations of every thread
(``spans.all_threads_config``), the pool's stats sum every counter of
its schedulers, and the exported trace and the window are kept for
``harness/spans.py``. Prints one JSON line:

- ``correct``, ``metrics`` (the cell's per-layer metrics, as in
  ``run.py``'s line) and ``stats`` (the pool's counters in the window);
- ``span_ms_per_batch``: device milliseconds of the operations launched
  inside each program span, over the batches run;
- ``device_s``, ``launched_s``: the window's device time, and the part of
  it whose launch the trace holds; ``sched_batch_share``: the share of
  ``device_s`` launched inside ``sched.batch``;
- ``queue_ms``: the scheduler's wait from arrival to a batch slot
  (``queue_s`` over ``entries_run``), where the program counts it;
- ``idle_gaps``: idle seconds by the launching thread's span and host
  operation (``spans.gap_labels``), and ``idle_gaps_any_thread`` by
  ``trace.breakdown``'s rule; ``idle_s``: idle seconds of the gaps
  labelled, ``idle_launcher_share`` the share of them labelled by the
  launching thread, ``idle_span_share`` by a program span there;
  ``idle_not_begun_s``: idle seconds before the next batch began
  (``spans.not_begun_s``);
- ``span_cost_us``: a span's host cost with no profiler and under one;
- the device and its power limit.

``--rehearse`` runs at the configuration's rehearsal size on the CPU and
prints no device.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402  (its caches and environment)

SPAN_COST_N = 20000


def _span_cost_us() -> dict:
    """Microseconds a span costs, off and under an every-thread CPU
    profile (None where the program has no ``span``)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import spans

    try:
        from a_nice_rag_tpu_torch.utils.trace import span
    except ImportError:
        return {"off": None, "on": None}

    def per_span():
        t = time.perf_counter()
        for _ in range(SPAN_COST_N):
            with span("cost"):
                pass
        return (time.perf_counter() - t) / SPAN_COST_N * 1e6

    off = per_span()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=spans.all_threads_config()):
        on = per_span()
    return {"off": off, "on": on}


@contextlib.contextmanager
def every_thread(kept: dict):
    """``runner.run`` profiled on every thread, summing every counter of
    the pool, with the window's ``trace.Trace``, ``spans.Spans`` and
    ``trace.Window`` in ``kept["trace"]``, ``kept["spans"]`` and
    ``kept["window"]``."""
    import torch.profiler

    from benchmark.harness import spans, system, trace

    saved = (torch.profiler.profile, system.Served.stats, trace.export,
             trace.read_metrics)
    config = spans.all_threads_config()

    def profile(*args, **kw):
        return saved[0](*args, experimental_config=config, **kw)

    def stats(served):
        out: dict = {}
        for s in served.pool.stats.values():
            for k, v in s.items():
                out[k] = out.get(k, 0) + v
        return out

    def export(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            kept["trace"], kept["spans"] = spans.load(path)
            return kept["trace"]
        finally:
            os.remove(path)

    def read_metrics(readers, w):
        kept["window"] = w
        return saved[3](readers, w)

    torch.profiler.profile, system.Served.stats = profile, stats
    trace.export, trace.read_metrics = export, read_metrics
    try:
        yield kept
    finally:
        (torch.profiler.profile, system.Served.stats, trace.export,
         trace.read_metrics) = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import spans, trace
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not args.rehearse and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    try:
        spans.all_threads_config()
    except TypeError as e:
        print(f"torch {torch.__version__} cannot profile every thread: {e}",
              file=sys.stderr)
        return 4
    cost = _span_cost_us()
    with every_thread({}) as kept:
        out = cell.driver.run(cell, args.seed, args.seconds, True,
                              time.perf_counter(), rehearse=args.rehearse)
    tr, sp, w = kept["trace"], kept["spans"], kept["window"]
    stats = w.stats
    span_s = spans.span_device_s(sp)
    gaps = spans.label_gaps(tr, sp)
    labelled: dict = {}
    for k, s, _ in gaps:
        labelled[k] = labelled.get(k, 0.0) + s
    batches = max(stats.get("batches_run", 0), 1)
    device_s = sum(b - a for _, a, b, _ in sp.device) / 1e6
    idle_s = max(sum(s for _, s, _ in gaps), 1e-12)
    result = {
        "workload": args.workload, "seed": args.seed,
        "torch": torch.__version__, "correct": out["correct"],
        "metrics": trace.read_metrics(cell.readers, w),
        "stats": stats,
        "span_ms_per_batch": {k: 1e3 * v / batches
                              for k, v in sorted(span_s.items())},
        "device_s": device_s,
        "sched_batch_share": span_s.get("sched.batch", 0.0) / max(device_s,
                                                                  1e-12),
        "launched_s": sum(b - a for _, a, b, c in sp.device
                          if c in sp.launches) / 1e6,
        "queue_ms": spans.queue_ms(stats),
        "busy_s": w.busy_s, "window_s": w.window_s,
        "idle_s": idle_s,
        "idle_launcher_share": sum(s for _, s, own in gaps if own) / idle_s,
        "idle_span_share": sum(s for k, s, _ in gaps
                               if k.split(" > ")[0] in span_s) / idle_s,
        "idle_not_begun_s": spans.not_begun_s(sp),
        "idle_gaps": sorted(labelled.items(), key=lambda kv: -kv[1])[:12],
        "idle_gaps_any_thread": trace.breakdown(tr, 12)["idle_gaps"],
        "threads_with_spans": len(sp.spans),
        "span_cost_us": cost,
    }
    if not args.rehearse:
        result["device"] = out["device"]["kind"]
        result["power"] = out["info"]["power"]
    print(json.dumps(run._plain(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
