"""The sharded path across distinct cards, against one card's virtual mesh.

    python -m a_nice_rag_tpu_torch.probes.multi_card [N_CARDS] [tp]

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
10) and its kernel launches. Then the tensor-parallel parts (``run_tp``),
over the same cards and as many slots of the first:

  tp_decode  GenerationServer(mesh=) with a tp axis over the cards: the
             decoder at Qwen3-0.6B's widths (bf16, random weights), each
             card holding its heads, MLP columns and kv heads; the greedy
             streams of 4 requests equal across the two meshes, and the
             tok/s of 64 requests over 64 slots (chunk 16) on each;
  dp_tp_step make_sharded_train_step at EncoderConfig's defaults over
             dp x tp = N/2 x 2 (1 x 2 for 2 cards): 3 steps' losses and
             the updated weights equal across the two meshes (within
             1e-5), and the step's host-clock ms.

With ``tp`` only the tensor-parallel parts run. One JSON line on stdout,
with each card's name and power limit.
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


def _tokens(reqs):
    out = []
    for r in reqs:
        toks = []
        while not r.out.empty():
            item = r.out.get_nowait()
            if isinstance(item, int):
                toks.append(item)
        out.append(toks)
    return out


def run_tp(cards: Sequence, lead, lm_cfg=None, enc_cfg=None,
           slots: int = 64, chunk: int = 16, new_tokens: int = 32,
           batch: int = 32, seq: int = 128) -> Dict:
    """The tensor-parallel parts over ``cards`` and ``len(cards)`` slots
    of ``lead``; raises where the two meshes' results differ."""
    from a_nice_rag_tpu_torch.bench import GenConfig, gen_model
    from a_nice_rag_tpu_torch.models.encoder import (
        EncoderConfig,
        init_encoder,
    )
    from a_nice_rag_tpu_torch.models.train import make_sharded_train_step
    from a_nice_rag_tpu_torch.serving.genserver import GenerationServer

    n, lead = len(cards), torch.device(lead)
    meshes = {"cards": list(cards), "slots": [lead] * n}
    devices = [torch.device(c) for c in cards]
    model = gen_model(lm_cfg or GenConfig(), lead)
    g = torch.Generator().manual_seed(14)
    prompts = [torch.randint(0, 256, (k,), generator=g).tolist()
               for k in (20, 9, 33, 14)]
    out: Dict = {"tp_decode": {}, "dp_tp_step": {}}
    streams = {}
    for name, devs in meshes.items():
        mesh = make_mesh((n,), ("tp",), devs)
        srv = GenerationServer(model, slots=slots, max_len=256, chunk=chunk,
                               eos_id=-1, mesh=mesh)
        reqs = [srv.submit(x, 24) for x in prompts]
        srv.drain()
        streams[name] = _tokens(reqs)
        reqs = [srv.submit(prompts[0], new_tokens) for _ in range(slots)]
        synchronize(devices)
        t0 = time.perf_counter()
        srv.drain()
        synchronize(devices)
        seconds = time.perf_counter() - t0
        got = sum(len(t) for t in _tokens(reqs))
        out["tp_decode"][name] = {"tok_s": got / seconds,
                                  "tokens": got, "seconds": seconds}
        del srv
    if streams["cards"] != streams["slots"]:
        raise AssertionError("tp decode streams differ between the meshes")
    out["tp_decode"]["streams_equal"] = True
    del model

    cfg = enc_cfg or EncoderConfig()
    enc = init_encoder(cfg, seed=3, device=lead)
    state = {k: v.clone() for k, v in enc.state_dict().items()}
    ids = torch.randint(1, cfg.vocab_size, (2, batch, seq), generator=g)
    shape = (n // 2, 2) if n >= 4 else (1, n)
    losses, weights = {}, {}
    for name, devs in meshes.items():
        mesh = make_mesh(shape, ("dp", "tp"), devs)
        step, params, _, _ = make_sharded_train_step(enc, state, mesh)
        q, d = ids[0].to(lead), ids[1].to(lead)
        losses[name] = [float(step(q, d)) for _ in range(3)]
        weights[name] = params.state_dict()
        out["dp_tp_step"][name] = {
            "losses": losses[name],
            "step_ms": host_ms(lambda: step(q, d), devices, n=3),
            "slot_devices": sorted({str(s.device) for s in mesh.slots})}
    err = max(float((weights["cards"][k].cpu() - weights["slots"][k].cpu())
                    .abs().max()) for k in state)
    if not torch.allclose(torch.tensor(losses["cards"]),
                          torch.tensor(losses["slots"]), rtol=1e-5) or \
            err > 1e-5:
        raise AssertionError(f"dp x tp steps differ between the meshes: "
                             f"{losses}, weights {err}")
    out["dp_tp_step"].update(mesh=list(shape), batch=[batch, seq],
                             weights_max_abs_diff=err, equal=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda()
    n = int(argv[0]) if argv else torch.cuda.device_count()
    if not 2 <= n <= torch.cuda.device_count():
        raise SystemExit(f"need 2 to {torch.cuda.device_count()} cards, "
                         f"asked for {n}")
    cards = [f"cuda:{i}" for i in range(n)]
    out = {"n_cards": n} if argv[1:] == ["tp"] else run(cards, "cuda:0")
    out.update(run_tp(cards, "cuda:0"))
    out["cards"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[:n]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
