"""Where one client's served latency goes, layer by layer.

    python -m a_nice_rag_tpu_torch.probes.served_tail [--n-docs N]
        [--requests 400] [--repeats 3] [--device cuda]

bench.py's 2M configuration (``scale_2m_data``: 2^21 x 256 bf16 rows,
planted queries, CSR postings) behind ``build_state`` / ``serve_state``,
with the tuned K1 plan and the scheduler settings of ``chip_smoke.py``'s
phase 20. One client in turn posts single-query JSON (``json_b1``) and
8-row b64 frames (``b64_b8``) on one connection, each reply's ids held
to a direct ``retrieve_device`` on its rows. Hooks time every request's
layers: the client's clock around the request and its reply
(``client``), the HTTP handler's ``do_POST`` (``http``), the scheduler
pool as the handler sees it (``pool``: ``submit_sync`` /
``submit_batch_sync``) and the device call with its upload and download
(``device``: ``retrieve_device``). With one client in turn every request
is its own batch, so the i-th record of each layer is the i-th
request's.

One JSON line per series and repeat: p50 / p90 / p99 / max of each
layer, the six slowest requests with their layers, and the cyclic
collector's runs in the series. Each kind first takes ``WARMUP``
requests that are not timed (the first call at a new bucket sets up its
buffers). To compare two trees on one host, run the probe from a
checkout of each in one call.
"""

from __future__ import annotations

import argparse
import gc
import json
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from a_nice_rag_tpu_torch import bench
from a_nice_rag_tpu_torch.index import ArrayIndex, CorpusMeta

MODEL = "voyage-3-large"
WEIGHTS = {MODEL: 5.0, "BM25": 1.0}
FRAME = 8  # rows of a b64 frame, chip_smoke.py's B_MICRO
WARMUP = 20
LAYERS = ("client", "http", "pool", "device")


def served_index(cfg: bench.Scale2MConfig, device):
    """The 2M configuration as a served index: ids, sources and empty
    contents, as ``chip_smoke.py``'s stage A reference index carries
    them. Returns (index, q [B, D], terms [B, T])."""
    emb, _, q, bm25, terms = bench.scale_2m_data(cfg, device)
    n = cfg.n
    meta = CorpusMeta(ids=[str(i) for i in range(n)], sources=["CG"] * n,
                      contents=[""] * n, urls=[], n_docs=n, n_docs_padded=n)
    index = ArrayIndex(meta=meta, dense={MODEL: emb}, bm25=bm25, vocab=None,
                       bm25_stats={"max_df": cfg.df},
                       bm25_doc_mask=np.ones(n, dtype=bool))
    return index, q, terms


class _Layers:
    """Per-layer durations (ms) of the requests since ``clear``. The
    handler's record lands after its reply has gone out, so the client
    waits for every layer's records (``settle``) before reading them or
    clearing."""

    def __init__(self):
        self.ms: Dict[str, List[float]] = {name: [] for name in LAYERS}
        self._cv = threading.Condition()

    def clear(self) -> None:
        with self._cv:
            for v in self.ms.values():
                v.clear()

    def add(self, name: str, ms: float) -> None:
        with self._cv:
            self.ms[name].append(ms)
            self._cv.notify_all()

    def settle(self, n: int, timeout_s: float = 30.0) -> None:
        """Wait until every layer holds ``n`` records; raise if one holds
        another count then."""
        with self._cv:
            self._cv.wait_for(
                lambda: all(len(v) >= n for v in self.ms.values()),
                timeout_s)
            counts = {k: len(v) for k, v in self.ms.items()}
        if any(c != n for c in counts.values()):
            raise AssertionError(f"one record a request: {n} requests, "
                                 f"records {counts}")

    def timed(self, name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, (time.perf_counter() - t0) * 1e3)
        return wrapped


def _stats(ms: List[float]) -> dict:
    return {"p50": float(np.percentile(ms, 50)),
            "p90": float(np.percentile(ms, 90)),
            "p99": float(np.percentile(ms, 99)),
            "max": float(np.max(ms))}


def run(n_docs: int = 1 << 21, requests: int = 400, repeats: int = 3,
        device: str = "cuda") -> List[dict]:
    from a_nice_rag_tpu_torch.serving.serve_cli import (
        build_state,
        serve_state,
    )

    dev = torch.device(device)
    cfg = bench.Scale2MConfig(n=n_docs)
    index, q, terms = served_index(cfg, dev)
    state = build_state(
        index, (MODEL,), use_bm25=True, autotune=dev.type == "cuda",
        similarity_k=32, common_sections_n=15, budget=1024,
        scheduler_kwargs={"max_batch": 2 * cfg.batch, "max_wait_ms": 2.0,
                          "max_inflight": 4})
    retr = state.retriever
    want = retr.retrieve_device({MODEL: q}, terms, WEIGHTS, None,
                                40.0)[0].cpu().numpy()
    q_host, t_host = q.cpu().numpy(), terms.cpu().numpy()
    ids = index.meta.ids
    card = bench.card_line() if dev.type == "cuda" else "cpu"

    layers = _Layers()
    state.submit_sync = layers.timed("pool", state.submit_sync)
    state.submit_batch_sync = layers.timed("pool", state.submit_batch_sync)
    retr.retrieve_device = layers.timed("device", retr.retrieve_device)
    server = serve_state(state, WEIGHTS, port=0, background=True)
    handler = server.RequestHandlerClass
    handler.do_POST = layers.timed("http", handler.do_POST)
    collections = []

    def collected(phase, info):
        if phase == "stop":
            collections.append(info["generation"])

    gc.callbacks.append(collected)

    def single(sender, i):
        r = i % cfg.batch
        sender.body = json.dumps({"query_embedding": q_host[r].tolist(),
                                  "terms": t_host[r].tolist()})
        t0 = time.perf_counter()
        got = [x["id"] for x in sender.post()["results"]]
        layers.add("client", (time.perf_counter() - t0) * 1e3)
        if got != [ids[j] for j in want[r] if j >= 0]:
            raise AssertionError(f"single query {r}: {got[:3]}")

    def frame(sender, i):
        r0 = (i * FRAME) % (cfg.batch - FRAME + 1)
        sender.body = bench.b64_body(q_host[r0:r0 + FRAME],
                                     t_host[r0:r0 + FRAME], WEIGHTS)
        t0 = time.perf_counter()
        got = sender()
        layers.add("client", (time.perf_counter() - t0) * 1e3)
        if not np.array_equal(got, want[r0:r0 + FRAME]):
            raise AssertionError(f"frame at row {r0}")

    out = []
    try:
        port = server.server_address[1]
        with bench.HttpSender(port, "") as sender:
            for one in (single, frame):
                for i in range(WARMUP):
                    one(sender, i)
            layers.settle(2 * WARMUP)
            for rep in range(repeats):
                for series, one in (("json_b1", single), ("b64_b8", frame)):
                    layers.clear()
                    del collections[:]
                    for i in range(requests):
                        one(sender, i)
                    layers.settle(requests)
                    ms = {k: np.asarray(v) for k, v in layers.ms.items()}
                    slow = np.argsort(ms["client"])[::-1][:6]
                    rec = {"probe": "served_tail", "series": series,
                           "repeat": rep, "requests": requests,
                           "n_docs": n_docs, "card": card,
                           **{f"{k}_ms": _stats(v) for k, v in ms.items()},
                           "slowest": [{"request": int(i), **{
                               k: float(ms[k][i]) for k in LAYERS}}
                               for i in slow],
                           "gc_collections": [collections.count(g)
                                              for g in range(3)]}
                    print(json.dumps(rec), flush=True)
                    out.append(rec)
    finally:
        server.shutdown()
        gc.callbacks.remove(collected)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-docs", type=int, default=1 << 21)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.n_docs, a.requests, a.repeats, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
