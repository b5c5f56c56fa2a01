"""K2r's time on the int8 stage's matrix, for the port in any checkout.

    python a_nice_rag_tpu_torch/probes/rounded_int8.py [--root DIR]
        [--batches 8,256,512] [--anatomy] [--out FILE]

Imports ``a_nice_rag_tpu_torch`` from ``--root`` (default: the checkout
holding this file), so one call can time two trees on one card in turns
(parent, change, change, parent), each its own process. The matrix is the
bench's int8 configuration (``bench.int8_corpus``: 10,485,760 x 1024, 4096
planted clusters, its seed), the queries its planted ones quantized
(``planted_int8_queries``, ``quantize_queries``), B of them for each
batch (the 256 repeated for B > 256). Each batch: the device ms of
``fused_dense_top_k_int8_rounded(..., k=25)`` (CUDA events, median of 10
after 3 warm-ups), its 10 samples, and the SHA-256 of the values and ids
it returned, so two trees' outputs can be held equal. ``--anatomy``
(trees with the cluster design's probes) adds K2r's anatomy at B = 256
through the checked modes (``probes.kernel_anatomy.check_cluster`` /
``run_cluster``, kind "rounded": the ring alone, + wgmma, + the
epilogue's test at +inf, the whole call, the main pass alone seeded with
the rounded subsample tau; each mode first held against its plain
version, torch.equal on int8 rows) and the docs a row at or above that
tau. One JSON line, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
K = 25


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--batches", default="8,256,512")
    ap.add_argument("--anatomy", action="store_true")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    from a_nice_rag_tpu_torch import bench
    from a_nice_rag_tpu_torch.ops import kernels
    from a_nice_rag_tpu_torch.ops.quantized import quantize_queries

    if not torch.cuda.is_available():
        print("no CUDA GPU visible", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    kernels.build_kernels()
    values, scales, _, g = bench.int8_corpus(bench.Int8Config(), dev)
    gold = torch.randint(0, values.shape[0], (256,), generator=g,
                         device=dev)
    q = bench.planted_int8_queries(values, scales, gold, g)
    fn = kernels.fused_dense_top_k_int8_rounded
    out = {"root": root, "card": bench.card_line(),
           "shape": f"{values.shape[0]} x {values.shape[1]} int8, k={K}",
           "method": "CUDA events, median of 10 after 3 warm-ups",
           "batches": {}}
    for b in (int(x) for x in args.batches.split(",")):
        qv, qs = quantize_queries(q.repeat(-(-b // 256), 1)[:b])
        got = fn(values, scales, qv, qs, K)
        torch.cuda.synchronize()
        digest = hashlib.sha256(got[0].cpu().numpy().tobytes()
                                + got[1].cpu().numpy().tobytes())
        for _ in range(3):
            fn(values, scales, qv, qs, K)
        samples = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(values, scales, qv, qs, K)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        out["batches"][str(b)] = {"ms": statistics.median(samples),
                                  "ms_runs": samples,
                                  "sha256": digest.hexdigest()}
    if args.anatomy:
        from a_nice_rag_tpu_torch.ops.kernels import anatomy, cluster_probe
        from a_nice_rag_tpu_torch.probes import kernel_anatomy

        def event_ms(fn, n):
            for _ in range(3):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n

        qv, qs = quantize_queries(q)
        err = kernel_anatomy.check_cluster(values, qv, K, "rounded", scales,
                                           qs)
        line = kernel_anatomy.run_cluster(values, qv, K, event_ms,
                                          "rounded", scales, qs)
        tau, _ = cluster_probe.subsample_seeds(values, qv, K, "int8", scales)
        at_tau = anatomy.anatomy_top_k_int8_cluster(
            values, scales, qv, qs, K, "compare", tau, "rounded")
        out["anatomy"] = {**line["ms"], "plan": line["plan"],
                          "modes_equal_plain": err == 0.0,
                          "docs_at_or_above_tau_per_row":
                              float(at_tau.double().mean())}
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
