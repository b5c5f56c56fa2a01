"""One run of one cell: set-up, the measured window, the check.

Set-up (``setup_s``, from the process's start to the window's opening):
the data and the query pool made on the device from the seed, the index
and the retriever built, the pool started, every bucket the traffic can
make warmed through the retriever (the kernel libraries are built on the
first call, into the checkout's ``a_nice_rag_tpu_torch/_build/``), and
two requests a client through the pool.

The window: the traffic's closed-loop clients send for ``seconds``; it
closes when the last reply of a request sent in it arrives. ``qps`` is
the rows of every request sent in the window over its length; ``p50_ms``
and ``p95_ms`` the median and 95th percentile of every such request's
time from submit to reply. A traced run (``trace``) wraps the window in
``torch.profiler`` and reports the per-layer metrics instead.

Then the device's peak memory is read, the pool stopped and the
program's index freed, and the sampled replies are judged
(``check.py``).
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import check, gen, system, trace
from benchmark.harness.spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "a_nice_rag_tpu")
# What this system's traced window gives its per-layer readers (a
# metric's ``READS``; ``trace.Window``): ``device``, the trace itself;
# ``batches``, the scheduler's batches (``batch_rows``, and ``stats``'
# ``batches_run`` and ``queries_served``).
FEEDS = ("device", "batches")
# The axes of a configuration's ``mesh``: dp x corpus slots, a card each.
MESH_AXES = ("dp", "corpus")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's
    (compared whole: ``a_nice_rag_tpu_torch`` is not ``a_nice_rag_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def rehearsal_config(cfg: dict) -> dict:
    """The configuration at its rehearsal size (CPU, plain versions)."""
    small = dict(cfg)
    over = cfg["rehearsal"]
    for key, v in over.items():
        if isinstance(v, dict):
            small[key] = {**cfg[key], **v}
        else:
            small[key] = v
    return small


def mesh_devices(cfg: dict, rehearse: bool) -> Optional[list]:
    """The devices of the configuration's mesh, one a slot (dp x corpus):
    cuda:0 ... on the card, slots that share the CPU in a rehearsal; None
    without a mesh."""
    mesh = cfg.get("mesh")
    if mesh is None:
        return None
    slots = mesh["dp"] * mesh["corpus"]
    return ([torch.device("cpu")] * slots if rehearse
            else [torch.device("cuda", i) for i in range(slots)])


def build_sharded(cfg: dict, seed: int, devices: list, pool_rows: int,
                  mark=None):
    """``build`` for a configuration with a mesh: each shard's int8 rows
    made on its device, the query pool on the first."""
    if cfg["dense_dtype"] != "int8" or "bm25" in cfg:
        raise ValueError("a mesh lays out int8 dense rows only")
    shards = gen.dense_int8_shards(cfg, seed, devices)
    data = {"device": devices[0], "int8_shards": shards}
    pool = gen.query_pool(cfg, pool_rows, seed, devices[0],
                          int8_shards=shards)
    if mark is not None:
        mark("data")
    index = system.build_sharded_index(cfg, shards, devices)
    if mark is not None:
        mark("index")
    return data, pool, index


def build(cfg: dict, seed: int, device, pool_rows: int, mark=None):
    """(data, query pool, index): everything from the seed. ``mark(name)``
    notes the time after the data and after the index."""
    data = {"device": device}
    if cfg["dense_dtype"] == "bfloat16":
        data["bf16"] = gen.dense_bf16(cfg, seed, device)
    else:
        data["int8"] = gen.dense_int8(cfg, seed, device)
    tc = impacts = None
    if "bm25" in cfg:
        tc = gen.term_corpus(cfg, seed, device)
        impacts = gen.index_impacts(tc, cfg["bm25"])
        data["terms"] = tc
    pool = gen.query_pool(
        cfg, pool_rows, seed, device, bf16_rows=data.get("bf16"),
        int8_rows=data.get("int8"), tc=tc, t_max=cfg["scheduler"]["t_max"],
        budget=cfg["retriever"]["budget"] if tc is not None else None)
    if tc is not None:
        # The passages' words serve only the queries' draws.
        tc.words = tc.offsets = None
    if mark is not None:
        mark("data")
    index = system.build_index(cfg, dense=data.get("bf16"),
                               int8=data.get("int8"), tc=tc, impacts=impacts)
    del impacts
    if mark is not None:
        mark("index")
    return data, pool, index


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        t_process: float, rehearse: bool = False,
        control: bool = False, marks: Optional[dict] = None) -> dict:
    """One run; returns the result line's object. ``control`` adds the
    control's numbers on the same sampled rows, its verdict against the
    cell's limits, and every number the program read (``control.py``).

    ``info.setup_marks`` holds the seconds from the process's start at
    which each step of set-up ended, after any given in ``marks``."""
    cfg = rehearsal_config(cell.config) if rehearse else cell.config
    traffic = dict(cell.traffic)
    if traffic["loop"] != "closed":
        raise ValueError(f"traffic loop {traffic['loop']!r}: "
                         f"system.drive runs closed loops only")
    if rehearse:
        traffic.update(cfg.get("rehearsal_traffic", {}))
    devices = mesh_devices(cfg, rehearse)
    device = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    rows = traffic["rows_per_request"]
    clients = traffic["clients"]
    info = {}
    marks = info["setup_marks"] = dict(marks or {})

    def mark(name):
        marks[name] = time.perf_counter() - t_process

    mark("imports")
    if device.type == "cuda":
        for dev in devices or [device]:
            torch.zeros(1, device=dev)
        system.synchronize(devices or [device])
        mark("cuda")

    if devices is None:
        data, pool, index = build(cfg, seed, device, traffic["pool_rows"],
                                  mark)
    else:
        data, pool, index = build_sharded(cfg, seed, devices,
                                          traffic["pool_rows"], mark)
    retriever = system.build_retriever(
        cfg, index, dense_backend="kernel" if rehearse else None)
    info.update(rows_cut=pool.rows_cut, use_kernel=retriever.use_kernel)
    if pool.terms is not None:
        info["max_postings"] = int(gen.postings_of(data["terms"],
                                                   pool.terms).max())
    queries = pool.dense.cpu().numpy()
    terms = pool.terms.cpu().numpy() if pool.terms is not None else None
    del pool
    served = system.Served(cfg, retriever, queries, terms, rows)
    order = np.random.default_rng(
        np.random.SeedSequence([int(seed), 3])).permutation(
            served.n_requests)
    mark("served")
    served.warm(clients)
    cards = [d for d in served.devices if d.type == "cuda"]
    system.synchronize(cards)
    for dev in cards:
        torch.cuda.reset_peak_memory_stats(dev)
    mark("warm")
    setup_s = marks["warm"]

    before = served.stats()
    served.recorder.on = True
    prof = start_profile() if traced else None
    t0 = time.perf_counter()
    requests = system.drive(served, clients, seconds, order=order)
    t1 = max(r.end for r in requests)
    system.synchronize(cards)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    served.recorder.on = False
    after = served.stats()
    stats = {k: after[k] - before[k] for k in after}
    peaks = [torch.cuda.max_memory_allocated(dev) for dev in cards]
    if len(peaks) > 1:
        info["memory_peak_bytes_by_card"] = peaks
    served.close()

    lat = np.array([(r.end - r.start) * 1e3 for r in requests])
    e2e = {"qps": len(requests) * rows / (t1 - t0),
           "p50_ms": float(np.percentile(lat, 50)),
           "p95_ms": float(np.percentile(lat, 95)),
           "setup_s": setup_s}
    info["latency_ms"] = {q: float(np.percentile(lat, q))
                          for q in (90, 99, 100)}
    info["latency_ms"]["mean"] = float(lat.mean())

    layer, extra = {}, {}
    if prof is not None:
        layer, extra = traced_window(
            prof, cell, cfg, window_s, stats,
            batch_rows=[b.queries.shape[0] for b in served.recorder.batches])
        del prof
        if cell.chips > 1:
            info["card_busy_s"] = extra["card_busy_s"]

    # The program's state goes before the reference runs; the generated
    # inputs (data) stay: the reference reads them too.
    served.recorder._inner = None
    served.pool = None
    del index, retriever
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    picks = check.sample_requests(requests, rows, traffic["check_rows"], seed)
    numbers, sampled = check.judge(served, requests, picks)
    limits = cfg["limits"]
    if sampled is not None:
        numbers.update(check.list_numbers(cfg, sampled, data))
        if control:
            ctl = check.list_numbers(cfg, sampled, data, control=True)
            info["control"] = ctl
            info["control_correct"] = check.verdict(
                {k: v for k, v in ctl.items() if k in limits}, limits)
            info["program"] = dict(numbers)
    numbers = {k: numbers[k] for k in limits if k in numbers}
    ok = sampled is not None and check.verdict(numbers, limits) \
        and set(numbers) == set(limits)

    return result_line(
        cell, ok=ok, attempted=len(requests),
        failed=int(numbers.get("missing", 0)), rehearse=rehearse,
        traced=traced, e2e=e2e, layer=layer, extra=extra,
        peak=max(peaks) if peaks else 0, device=device, info=info,
        numbers=numbers, limits=limits)


def start_profile():
    """``torch.profiler`` over the window, CPU and CUDA activity, entered:
    each driver's traced run records the same."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def traced_window(prof, cell: Cell, cfg: dict, window_s: float,
                  stats: dict, batch_rows=()) -> tuple:
    """(per-layer readings, extra) of a traced window: the trace read
    back, each card's busy spans, the ``trace.Window`` the cell's readers
    get (``stats``, ``batch_rows``: what the driver feeds), and the
    line's ``busy_s``, ``window_s``, ``breakdown`` and ``card_busy_s``."""
    tr = trace.export(prof)
    spans = trace.card_spans(tr, cell.chips)
    busy = trace.mean_busy_s(spans)
    w = trace.Window(
        device_ops=tr.device, busy_s=busy, window_s=window_s,
        batch_rows=list(batch_rows), stats=stats, config=cfg,
        chips=cell.chips, card_spans=spans,
        card_busy_s={c: trace.spans_s(sp) for c, sp in spans.items()})
    layer = trace.read_metrics(cell.readers, w)
    return layer, {"busy_s": busy, "window_s": window_s,
                   "breakdown": trace.breakdown(tr),
                   "card_busy_s": w.card_busy_s}


def result_line(cell: Cell, *, ok: bool, attempted: int, failed: int,
                rehearse: bool, traced: bool, e2e: dict, layer: dict,
                extra: dict, peak: int, device, info: dict, numbers: dict,
                limits: dict) -> dict:
    """The result line's object: the verdict and counts; the cell's
    end-to-end metrics (``e2e``) or, traced, its per-layer readings
    (``layer``); the device (``peak``: the fullest card's peak bytes);
    ``breakdown`` where traced; ``info`` with the power limit; and last
    each number compared beside its limit. A rehearsal has no metrics and
    no device."""
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed}
    if not rehearse:
        want = {m["name"] for m in (cell.per_layer if traced
                                    else cell.end_to_end)}
        units = {m["name"]: m["unit"]
                 for m in cell.end_to_end + cell.per_layer}
        values = layer if traced else {
            m["name"]: e2e[m["name"]] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in values.items() if k in want}
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips, "memory_peak_bytes": int(peak),
            **({"busy_s": extra["busy_s"], "window_s": extra["window_s"]}
               if traced else {})}
        if traced:
            result["breakdown"] = extra["breakdown"]
    else:
        result["rehearsal"] = True
    # Read once the window and the check are over: not set-up.
    info["power"] = None if rehearse else power_limit()
    result["info"] = info
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    return result


def checks_text(result: dict) -> str:
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in result["checks"].items()]
    lines.append(f"correct: {result['correct']}")
    return "\n".join(lines)

