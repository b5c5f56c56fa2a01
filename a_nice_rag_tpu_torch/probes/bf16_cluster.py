"""K1r and K1c on bf16 rows: the cluster kernel beside K1's kernel.

    python a_nice_rag_tpu_torch/probes/bf16_cluster.py [--batches
        8,64,256,512] [--anatomy-batch 256] [--out FILE]

On the 2m configuration's rows (``bench.scale_2m_data``: 2^21 x 256 unit
bf16 rows, 256 planted f32 queries, repeated for B > 256), for each fold
(K1r: ``fused_dense_top_k_rounded``; K1c:
``fused_dense_top_k_bf16_compare``, maskless) and batch, k = 32: the
route the wrapper took (``.split_launches``); K1's kernel in the same
score mode (``split_route_top_k``, the split route) and
``csrc/cluster_topk.cu`` with one and two query groups a CTA (where the
planes stay resident), timed in turns (split, cluster, cluster, split),
CUDA events, median of 10 after 3 warm-ups. The wrapper's output is held
torch.equal to the cluster kernel's at its CTA shape on the cluster
route, and whether each cluster output equals the split route's bit for
bit is reported. Then the cluster kernel's anatomy at
``--anatomy-batch`` through the cluster design's checked modes
(``probes.kernel_anatomy.check_cluster`` / ``run_cluster``, each mode
first held against its plain version: the ring alone, + wgmma, + the
epilogue's threshold test at +inf, the whole call, and the main pass
alone seeded with the fold's subsample tau), the docs at or above that
tau (the "compare" mode, held to its plain version), the whole call's
output against the split route's and the first 8 queries' against the
plain version's, and each kernel of one whole call from
``torch.profiler`` (device us and the gap before it). Before the
timings, small checks: each fold on integer grids torch.equal to its
plain version through the cluster kernel. One JSON line, also appended to
``--out``; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
K = 32


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8,64,256,512")
    ap.add_argument("--anatomy-batch", type=int, default=256)
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def _ms(torch, fn):
    for _ in range(3):
        fn()
    samples = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def main(argv=None) -> int:
    args = _args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from a_nice_rag_tpu_torch import bench
    from a_nice_rag_tpu_torch.ops import kernels
    from a_nice_rag_tpu_torch.ops.kernels import _build, cluster_topk
    from a_nice_rag_tpu_torch.ops.kernels import cluster_probe
    from a_nice_rag_tpu_torch.ops.kernels import fused_topk as ft
    from a_nice_rag_tpu_torch.probes import kernel_anatomy

    if not torch.cuda.is_available():
        print("no CUDA GPU visible", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_all(["fused_topk", "cluster_topk", "cluster_probe"])
    sms = ft._sm_count(dev)
    out = {"card": bench.card_line(), "k": K,
           "build_s": {n: round(s, 1) for n, (s, _) in
                       _build.build_log.items()},
           "ptxas_cluster_topk": [
               line for line in _build.build_log.get(
                   "cluster_topk", (0, ""))[1].splitlines()
               if "registers" in line or "spill" in line][:80],
           "method": "CUDA events, median of 10 after 3 warm-ups",
           "folds": {}}
    folds = {"rounded": (kernels.fused_dense_top_k_rounded, ft.SCORE_ROUNDED,
                         lambda e, q, k: ft.fused_dense_top_k_torch(
                             e, q, k, rounded=True)),
             "compare": (kernels.fused_dense_top_k_bf16_compare,
                         ft.SCORE_COMPARE,
                         ft.fused_dense_top_k_bf16_compare_torch)}

    # Integer grids: every score exact in f32, so the kernel and the plain
    # version agree bit for bit whatever the summation order.
    g = torch.Generator(device=dev).manual_seed(7)
    checks = []
    for lo, hi in ((-16, 16), (-1, 1)):
        for n, d in ((70 * 1024, 256), (1024, 64)):
            rows = torch.randint(lo, hi + 1, (n, d), generator=g,
                                 device=dev).bfloat16()
            rows[n // 2:n // 2 + 256] = rows[:256]
            qq = torch.randint(lo, hi + 1, (300, d), generator=g,
                               device=dev).float()
            for kind, (_, score, plain) in folds.items():
                for b, k in ((17, 1), (64, 32), (300, 128)):
                    if not cluster_topk.cluster_plan(n, b, d, k,
                                                     kind=kind).resident:
                        continue  # K1's kernel takes these calls
                    got = cluster_topk.bf16_top_k(rows, qq[:b], k, sms, kind)
                    ref = plain(rows, qq[:b], k)
                    torch.cuda.synchronize()
                    ok = torch.equal(got[0], ref[0]) and torch.equal(
                        got[1], ref[1])
                    checks.append({"kind": kind, "grid": [lo, hi], "n": n,
                                   "d": d, "b": b, "k": k, "equal": ok})
                    if not ok:
                        print(json.dumps({"failed": checks[-1]}), flush=True)
                        return 1
    out["integer_grid_checks"] = len(checks)

    emb, _, q, _, _ = bench.scale_2m_data(bench.Scale2MConfig(), dev)
    for kind, (wrapper, score, plain) in folds.items():
        rows = {}
        for b in (int(x) for x in args.batches.split(",")):
            qb = q.repeat(-(-b // q.shape[0]), 1)[:b].contiguous()
            split0 = wrapper.split_launches
            want = wrapper(emb, qb, K)
            route = "split" if wrapper.split_launches > split0 else "cluster"
            split = ft.split_route_top_k(emb, qb, K, score)
            row = {"route": route}
            qgs = [qg for qg in (1, 2) if cluster_topk.cluster_plan(
                emb.shape[0], b, emb.shape[1], K, qg=qg,
                kind=kind).resident]
            cl = {}
            for qg in qgs:
                got = cluster_topk.bf16_top_k(emb, qb, K, sms, kind, qg=qg)
                torch.cuda.synchronize()
                cl[qg] = got
                row[f"qg{qg}_equals_split"] = bool(
                    torch.equal(got[0], split[0])
                    and torch.equal(got[1], split[1]))
            if route == "cluster":
                qg0 = cluster_topk.default_query_groups(
                    b, emb.shape[1], K, kind)
                if not (torch.equal(cl[qg0][0], want[0])
                        and torch.equal(cl[qg0][1], want[1])):
                    raise AssertionError(f"{kind} B={b}: the wrapper's "
                                         f"output is not its cluster's")
            if b <= 16:
                ref = plain(emb, qb, K)
                row["split_ids_equal_plain"] = bool(torch.equal(split[1],
                                                                ref[1]))
            runs = {"split": []}
            runs.update({f"qg{qg}": [] for qg in qgs})
            order = ["split"] + [f"qg{qg}" for qg in qgs]
            for name in order + order[::-1]:
                if name == "split":
                    fn = lambda: ft.split_route_top_k(emb, qb, K, score)
                else:
                    fn = (lambda qg=int(name[2:]): cluster_topk.bf16_top_k(
                        emb, qb, K, sms, kind, qg=qg))
                runs[name].append(_ms(torch, fn))
            row["ms"] = {name: min(r) for name, r in runs.items()}
            row["ms_runs"] = runs
            row["plan"] = cluster_topk.cluster_plan(
                emb.shape[0], b, emb.shape[1], K, sms, kind=kind)._asdict()
            rows[str(b)] = row
        # The anatomy of the cluster route at one batch, through the
        # checked modes.
        b = args.anatomy_batch
        qb = q.repeat(-(-b // q.shape[0]), 1)[:b].contiguous()
        split = ft.split_route_top_k(emb, qb, K, score)
        ref8 = plain(emb, qb[:8], K)
        err = kernel_anatomy.check_cluster(emb, qb, K, kind)
        line = kernel_anatomy.run_cluster(emb, qb, K, lambda fn, n: _ms(
            torch, fn), kind)
        ana = dict(line["ms"])
        ana["plan"] = line["plan"]
        ana["modes_equal_plain"] = True
        ana["score_max_abs_err"] = err
        got = cluster_topk.bf16_top_k(emb, qb, K, sms, kind)
        torch.cuda.synchronize()
        ana["equal_split"] = bool(torch.equal(got[0], split[0])
                                  and torch.equal(got[1], split[1]))
        ana["max_abs_diff_split"] = float((got[0] - split[0]).abs().max())
        ana["ids_differ_split"] = int((got[1] != split[1]).sum())
        ana["first8_ids_equal_plain"] = bool(torch.equal(got[1][:8],
                                                         ref8[1]))
        ana["first8_max_abs_diff_plain"] = float(
            (got[0][:8] - ref8[0]).abs().max())
        tau, _ = cluster_probe.subsample_seeds(emb, qb, K, kind)
        at_tau = kernels.anatomy_top_k_cluster(emb, qb, K, "compare", tau,
                                               kind)
        want = kernels.anatomy_top_k_cluster_torch(
            emb, qb, K, "compare", tau, kind,
            kernels.anatomy.cluster_active_clusters(emb, b, K, kind,
                                                    "compare"))
        if not torch.equal(at_tau, want):
            raise AssertionError(f"{kind}: compare at tau differs from its "
                                 f"plain version")
        ana["docs_at_or_above_tau_per_row"] = float(at_tau.double().mean())
        ana["split_first8_ids_equal_plain"] = bool(torch.equal(split[1][:8],
                                                               ref8[1]))
        # Each kernel of one whole call, in order (device us, start gap).
        from torch.profiler import ProfilerActivity, profile
        cluster_topk.bf16_top_k(emb, qb, K, sms, kind)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cluster_topk.bf16_top_k(emb, qb, K, sms, kind)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type.name == "CUDA"),
                     key=lambda e: e.time_range.start)
        trace, last = [], None
        for e in evs:
            trace.append({"name": e.name[:48],
                          "us": round(e.time_range.elapsed_us(), 1),
                          "gap_us": None if last is None else round(
                              e.time_range.start - last, 1)})
            last = e.time_range.end
        out["folds"][kind] = {"batches": rows, "anatomy_b": b,
                              "anatomy_ms": ana, "trace": trace}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
