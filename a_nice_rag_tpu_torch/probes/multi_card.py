"""The sharded path across distinct cards, against one card's virtual mesh.

    python -m a_nice_rag_tpu_torch.probes.multi_card [N_CARDS]

Lays the bench's 2M configuration (2^21 x 256 bf16 + CSR BM25, B = 256,
k 32) over N_CARDS distinct cards, one shard a card (default: every
visible card; at least 2), and over as many slots of the first card, and
runs on both meshes:

  hybrid   ShardedRetriever.retrieve_lists: K1 on each shard's card, the
           lists moved to the lead card and merged; fused ids, scores and
           lists torch.equal across the two meshes;
  ivf      shard_ivf on the virtual mesh, saved and loaded into the
           cards' index, then micro-batches of B = 8 through K3 on every
           card; ids equal;
  recover  DeviceHealthMonitor with the last card dead: the corpus laid
           out again over the rest; ids equal to a virtual mesh of as
           many slots.

Each part reports its host-clock ms (every card synchronized, median of
10) and its kernel launches. One JSON line on stdout, with each card's
name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

from a_nice_rag_tpu_torch.bench import (
    MODEL,
    Scale2MConfig,
    array_index,
    recall_at_10,
    scale_2m_data,
)
from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.ops import kernels
from a_nice_rag_tpu_torch.parallel import (
    DeviceHealthMonitor,
    ShardedRetriever,
    default_probe,
    load_shard_ivf,
    make_mesh,
    save_shard_ivf,
    shard_index,
    shard_ivf,
)

TimeFn = Callable[[Callable[[], object], Sequence[torch.device]], float]


def synchronize(devices: Sequence[torch.device]) -> None:
    for dev in sorted({d for d in devices if d.type == "cuda"}, key=str):
        torch.cuda.synchronize(dev)


def host_ms(fn, devices, n: int = 10) -> float:
    """Median host-clock ms of one call ending with every card idle."""
    fn()
    synchronize(devices)
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        synchronize(devices)
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def _equal(a, b, what: str) -> None:
    for x, y in zip(a, b):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what} differ between the two meshes")


def _counted(fn, devices):
    """fn's output and its K1 / K3 launches."""
    synchronize(devices)
    kernels.reset_launch_counts()
    out = fn()
    synchronize(devices)
    return out, {"fused_dense_top_k": kernels.fused_dense_top_k.launches,
                 "ivf_dense_top_k": kernels.ivf_dense_top_k.launches}


def run(cards: Sequence, lead, cfg: Scale2MConfig = Scale2MConfig(),
        ivf_batches: int = 16, nprobe: int = 16, tile_n: int = 1024,
        time_ms: TimeFn = host_ms) -> Dict:
    """Both meshes over ``cards`` (distinct devices) and ``len(cards)``
    slots of ``lead``; raises where their results differ."""
    n = len(cards)
    lead = torch.device(lead)
    emb, gold, q, bm25, terms = scale_2m_data(cfg, lead)
    index = array_index(cfg.n, dense={MODEL: emb}, bm25=bm25, df=cfg.df)
    meshes = {"cards": make_mesh(shape=(1, n), devices=cards),
              "slots": make_mesh(shape=(1, n), devices=[lead] * n)}
    devices = list(meshes["cards"].devices)
    sidx = {name: shard_index(index, m) for name, m in meshes.items()}
    kw = dict(similarity_k=cfg.k, common_sections_n=15, budget=1024)
    w = {MODEL: 5.0, "BM25": 1.0}
    qd = {MODEL: q}
    out: Dict = {"n_cards": n, "n_local": sidx["cards"].n_local,
                 "batch": cfg.batch, "hybrid": {}, "ivf": {}}

    got = {}
    for name, s in sidx.items():
        r = ShardedRetriever(s, (MODEL,), use_bm25=True, **kw)
        got[name], launches = _counted(
            lambda: r.retrieve_lists(qd, terms, w, None, 40.0), devices)
        out["hybrid"][name] = {
            "ms": time_ms(lambda: r.retrieve_device(qd, terms, w, None,
                                                    40.0), devices),
            "launches": launches}
    _equal(got["cards"], got["slots"], "hybrid results")
    out["hybrid"]["equal"] = True
    out["hybrid"]["recall10"] = recall_at_10(got["cards"][0].to(lead), gold)

    ivf = {"slots": shard_ivf(sidx["slots"], MODEL, tile_n=tile_n)}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "shard_ivf.npz")
        save_shard_ivf(ivf["slots"], path)
        ivf["cards"] = load_shard_ivf(sidx["cards"], path)
    ids = {}
    bm = 8
    for name, s in ivf.items():
        r = ShardedRetriever(s, (MODEL,), use_bm25=False, similarity_k=16,
                             common_sections_n=16, nprobe=nprobe)
        if not r._route_ivf(bm, False, False):
            raise AssertionError("B = 8 must take the IVF route")

        def calls(r=r):
            return torch.cat([
                r.retrieve_device({MODEL: q[i * bm:(i + 1) * bm]}, None,
                                  {MODEL: 1.0}, None, 40.0)[0].cpu()
                for i in range(ivf_batches)])

        ids[name], launches = _counted(calls, devices)
        out["ivf"][name] = {
            "ms_b8": time_ms(lambda r=r: r.retrieve_device(
                {MODEL: q[:bm]}, None, {MODEL: 1.0}, None, 40.0), devices),
            "launches": launches}
    _equal([ids["cards"]], [ids["slots"]], "IVF ids")
    out["ivf"].update(equal=True, calls=ivf_batches, nprobe=nprobe,
                      clusters_per_shard=ivf["cards"].ivf_n_clusters)
    del ivf

    dead = meshes["cards"].slots[-1]
    state = {}
    mon = DeviceHealthMonitor(
        sidx["cards"], rebuild=lambda s: state.update(sidx=s),
        probe_fn=lambda slot, t: slot is not dead and default_probe(slot, t))
    t0 = time.perf_counter()
    if not mon.check_and_recover():
        raise AssertionError("no recovery ran")
    recovery_s = time.perf_counter() - t0
    flat = shard_index(index, make_mesh(shape=(1, n - 1),
                                        devices=[lead] * (n - 1)))
    after = {}
    for name, s in (("cards", state["sidx"]), ("slots", flat)):
        r = ShardedRetriever(s, (MODEL,), use_bm25=True, **kw)
        after[name] = r.retrieve_lists(qd, terms, w, None, 40.0)
    _equal(after["cards"], after["slots"], "recovered results")
    out["recover"] = {"survivors": n - 1, "seconds": recovery_s,
                      "equal": True,
                      "probes": [default_probe(s, 30.0)
                                 for s in meshes["cards"].slots]}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda()
    n = int(argv[0]) if argv else torch.cuda.device_count()
    if not 2 <= n <= torch.cuda.device_count():
        raise SystemExit(f"need 2 to {torch.cuda.device_count()} cards, "
                         f"asked for {n}")
    out = run([f"cuda:{i}" for i in range(n)], "cuda:0")
    out["cards"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[:n]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
