#!/usr/bin/env python3
"""Smoke run of the PyTorch port (a_nice_rag_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc (one nvcc per source,
started together), holds each against its plain PyTorch version, then
drives the port's main path, ``FusedRetriever.retrieve_device``, at the
corpus sizes the repository was built for at scale, and the paths of the
port's bench (``a_nice_rag_tpu_torch.bench``) and stream probes:

  0. device check, card name and power limit, kernel build, the launch
     plans of the int8 and float top-k kernels and of the folds;
  1. K1 (fused_dense_top_k) against its plain version: f32 and bf16 rows,
     with and without a mask, N = 2^20 + 37, k in {1, 32, 128},
     B in {1, 7, 256}, duplicated rows (exact ties across doc splits),
     and k larger than the count of valid docs;
  2. K2 (fused_dense_top_k_int8) against its plain version, same cases,
     then the int8 path's edges at N_EDGE rows: D in {1, 33, 37, 1024},
     B at the query-block switch (8, 16, 17, 64, 65, 256), k in {1, 25,
     128}, rows and queries holding -128 and 127, exact ties across
     sub-tiles, tiles and CTAs, and rows whose base is not 16-byte aligned
     (values[1:] and a copy at an odd address), each torch.equal;
  3. K3/K4 (ivf_dense_top_k, ivf_dense_top_k_int8) against their plain
     versions on the same matrix in f32, bf16 and int8: tile_n 1024 and
     2048, a ragged last tile, static and dynamic (trailing-slot) row
     counts, -1 padded tables, k in {1, 16, 128, 256}, B in {1, 8, 256};
     then K4 on phase 2's edge rows (k up to 256), each torch.equal;
     then the float path's edges (K1 and K3, f32 and bf16 rows) at
     N_EDGE rows: D in {1, 33, 37, 1024, 2048} (the query block streamed
     by depth chunk at 2048 where it does not fit), B in {1, 8, 16, 17,
     64, 65, 256}, k up to 128 (K1) / 256 (K3), rows[1:] and rows at an
     address that is not 16-byte aligned, exact ties across sub-tiles,
     tiles and CTAs, masks that leave fewer than k candidates (tau =
     -inf) and unmasked cases (finite tau), each held through
     check_top_k at F32_ATOL / BF16_ATOL;
  4. stage A: 2^21 x 256 bf16 dense + CSR BM25 hybrid (bench.py's 2M
     configuration), planted recall and id equality with the torch route;
  5. stage B: the same index with a filter mask over half the docs and
     two-tier BM25 (128 common terms, so K1 runs masked twice per call);
 17. SearchEngine, the reference-parity API, on stage A's index (with
     ids, sources and a vocabulary): hybrid retrieve of B = 256 token
     queries (similarity_k 32, common_sections_n 15, weights 5:1,
     return_docs), planted recall@10 >= 0.99, no kernel launched (its
     routes are plain torch, as the JAX package's are plain XLA), its
     dense lists held against K1's through check_top_k at BF16_ATOL, and
     the host-clock ms of one retrieve beside the fused retriever's;
  6. stage D: 2^21 x 256 bf16 with a k-means IVF (bench.py's 2M IVF
     configuration): micro-batches of B = 8 through K3, B = 256 and a
     filtered call through K1, a full probe against the exact route, and
     the IVF/exact crossover record for B in {8, 16, 32, 64};
  7. stage C: 10.5M x 1024 int8 dense-only (bench.py's int8 configuration),
     and SearchEngine.similarity_search_batch there at B = 8 held against
     K2 through check_top_k at INT8_ATOL;
  8. stage E: stage C's matrix with a cluster-major IVF: micro-batches of
     B = 8 through K4, B = 256 through K2;
  9. the stream kernels (stream_sum, stream_sum_busy) against their plain
     versions: f32, bf16 and int8; 1, 2 and 8 parts; bias set and unset;
     a ragged row count, one row, and views that start mid-vector; an
     int8 case whose partial sums stay below 2^24, which must be exact;
     every launch shape of stream_sum, one launch a call and two calls
     the same bits; the busy kernel's per-CTA chains bit for bit;
 10. stage F: the bench's headline stage at full width (9,728 x 2048 f32,
     BM25 from tokens, B = 2048) through bench.headline_stage, with its
     recall guards and route parity (both routes are torch there: 9,728
     docs are below the kernel threshold);
 11. floor lines for stages A and C: bench.stream_floor (stream_sum) over
     the matrices those stages hold, against their retrieve_device time;
 12. the overlap probe (probes.dma_overlap) at X in {0, 8, 64};
 13. the anatomy of K1/K2 (probes.kernel_anatomy: the staging loops,
     + scoring, + the compare pass, + insertions and merge), each mode
     first held against its plain version at N_KERNEL on integer-valued
     rows (exact scores), then held again and timed on stage A's and
     stage C's matrices;
 14. the counted fold (probes.iteration_count) at N_KERNEL against its
     plain version (ids, values and every counter), then on stage A's
     and stage C's matrices with and without a subsample tau, again
     equal to its plain version there and its ids to K1's / K2's;
 15. the keys: xpack_keys / xpack_values over the 13 special values of
     the JAX package's key test plus 2^24 normals, bit for bit, and
     bf16_row_reduce (probes.bf16_fold) at [128, 8192] and [256, 16384],
     then on its edge cases (R 1-4096, W 1-65536, storage offsets, ties
     across a row's warps, all-equal rows, -inf and values below the mask,
     +-0.0, values that round to one bf16), torch.equal on all four
     outputs, one launch a call; its time at both shapes as an event
     pair around one call and device-only (50 calls between one pair);
 16. int4 (probes.int4): exact at 1024 x 256, B = 128, both unpacks;
     the folds' edges (D in {8, 40, 1000, 1024, 2048}, B from 1 to 256
     across clusters of 1-4 query blocks, N below one tile and ragged,
     -128/127 and -8/7, all-negative products, rows not 16-byte aligned),
     each torch.equal; then stage 2's folds over stage C's int8 matrix and
     a 5.4 GB packed one, all three kernels torch.equal to their plain
     versions there (both unpacks), and each fold's stream alone beside
     the whole fold.

Stages A-C also print the retrieve_device time of one call (CUDA
events, median of 10). Each kernel, its plain version and a one-call
PyTorch yardstick
(library_ms) are timed with CUDA events at the main path's shapes, and
each kernel's bound (the larger of its bytes over the HBM rate and its
operations over the peak rate of their type) is computed from the run's
inputs. Prints one JSON object per phase or timing line, the kernels
line, and, as the last line, {"ok": true, "device": {...}}. Any failed
check raises, so the exit code is nonzero and no result line is printed.
All data is made on the device from seeded torch.Generator streams,
except stage F's corpus, which is the bench's numpy synth_corpus.
"""

from __future__ import annotations

import itertools
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
MODEL = "voyage-3-large"
K1_SOURCE = "a_nice_rag_tpu_torch/csrc/fused_topk.cu"
K3_SOURCE = "a_nice_rag_tpu_torch/csrc/ivf_topk.cu"
STREAM_SOURCE = "a_nice_rag_tpu_torch/csrc/stream_sum.cu"
ANATOMY_SOURCE = "a_nice_rag_tpu_torch/csrc/anatomy.cu"
KEYS_SOURCE = "a_nice_rag_tpu_torch/csrc/keys.cu"
INT4_SOURCE = "a_nice_rag_tpu_torch/csrc/int4.cu"
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fused_dense_top_k": (K1_SOURCE,
                          "a_nice_rag_tpu/ops/pallas/fused_topk.py:1440"),
    "fused_dense_top_k_int8": (K1_SOURCE,
                               "a_nice_rag_tpu/ops/pallas/fused_topk.py:1218"),
    "ivf_dense_top_k": (K3_SOURCE,
                        "a_nice_rag_tpu/ops/pallas/ivf_topk.py:143"),
    "ivf_dense_top_k_int8": (K3_SOURCE,
                             "a_nice_rag_tpu/ops/pallas/ivf_topk.py:174"),
    # P1 (and P2: scripts/probe_hbm_stream.py:67, :119, :168, :224).
    "stream_sum": (STREAM_SOURCE, "bench.py:226"),
    "stream_sum_busy": (STREAM_SOURCE, "scripts/probe_dma_overlap.py:74"),
    # P4 (its "stage", "score" and "compare" modes; "full" is K1/K2).
    "anatomy_top_k": (ANATOMY_SOURCE,
                      "scripts/profile_kernel_anatomy.py:138"),
    "anatomy_top_k_int8": (ANATOMY_SOURCE,
                           "scripts/profile_kernel_anatomy.py:138"),
    # P5.
    "fused_top_k_counted": (ANATOMY_SOURCE,
                            "scripts/probe_iteration_count.py:160"),
    "fused_top_k_counted_int8": (ANATOMY_SOURCE,
                                 "scripts/probe_iteration_count.py:160"),
    # T1: the key map and its inverse.
    "xpack_keys": (KEYS_SOURCE, "tests/test_pallas_fused.py:433"),
    "xpack_values": (KEYS_SOURCE, "tests/test_pallas_fused.py:433"),
    # P6 (the four kernels of :41, and :118).
    "bf16_row_reduce": (KEYS_SOURCE, "scripts/probe_bf16_fold.py:41"),
    # P7: stages 1 and 3 (:83, :243, :261), stage 2 (:167, :188).
    "int4_scores": (INT4_SOURCE, "scripts/probe_int4.py:83"),
    "int8_fold_max": (INT4_SOURCE, "scripts/probe_int4.py:167"),
    "int4_fold_max": (INT4_SOURCE, "scripts/probe_int4.py:188"),
}
F32_ATOL = 1e-5
BF16_ATOL = 1e-4
BM25_ATOL = 1e-4
FULL_PROBE_ATOL = 1e-4
# int8 scores across routes: K2 emits (acc * s_d) * s_q, the torch route
# (acc * s_q) * s_d; two float32 roundings of one exact product, at most
# a few ulps of scores below 2 in magnitude.
INT8_ATOL = 1e-6
# One H100 SXM (NVIDIA data sheet, dense rates): HBM bytes/s, FFMA f32
# FLOP/s (f32 rows score in IEEE f32, off the tensor cores), bf16
# tensor-core FLOP/s (bf16 rows: three MMAs per product, one for each
# bf16 piece of the f32 query), int8 tensor-core OP/s.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
INT8_OP_S = 1979e12
QUERY_PIECES = 3


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


class Smoke:
    # Sizes of the phases (bench.py's configurations for stages A-E).
    N_KERNEL, D_KERNEL = (1 << 20) + 37, 256
    # The int8 path's edge cases: rows, depths, batches at the query-block
    # switch, k, the IVF tile.
    N_EDGE, EDGE_D = 70_001, (1, 33, 37, 1024)
    EDGE_B, EDGE_K, EDGE_TILE = (8, 16, 17, 64, 65, 256), (1, 25, 128), 1024
    # The float path's edges (K1, K3): depths, batches, k cycled per case.
    EDGE_FLOAT_D = (1, 33, 37, 1024, 2048)
    EDGE_FLOAT_B = (1, 8, 16, 17, 64, 65, 256)
    EDGE_FLOAT_K = (1, 16, 25, 128)
    IVF_TILES = (1024, 2048)
    N_A, D_A, B, T, V, DF = 1 << 21, 256, 256, 16, 1 << 17, 16
    N_C, D_C, CLUSTERS, CHUNKS = 10_485_760, 1024, 4096, 40
    V_COMMON = 128
    # Stage D: 2048 planted centres, k-means IVF, nprobe 16, k 16.
    N_D, D_D, CENTRES_D, TILE_D, NPROBE_D, K_D, V_D = (
        1 << 21, 256, 2048, 1024, 16, 16, 1 << 17)
    BATCHES_D, B_MICRO = 64, 8
    CROSS_B = (8, 16, 32, 64)
    # Stage E: identity-permuted IVF over stage C, nprobe 8, k 25.
    TILE_E, NPROBE_E, K_E, BATCHES_E = 2048, 8, 25, 32
    # Stream cases: rows x columns of each part (no multiple of any
    # block), the int8 exact case, the busy kernel's chains and the
    # overlap probe's X.
    STREAM_ROWS, STREAM_D, EXACT_ROWS = 100_003, 64, 1 << 20
    STREAM_CTAS = (1, 2, 4, 8)
    BUSY_X, OVERLAP_X = (0, 3), (0, 8, 64)
    # Probes: rows of int4 stage 2's packed matrix (stage C's count), the
    # bf16 fold's shapes, the normals of the key map's case.
    INT4_N = 10_485_760
    # P7's edges (probes.int4.check_edges): row counts, depths, batches.
    FOLD_EDGE_N, FOLD_EDGE_D = (100, 70_001), (8, 40, 1000, 1024, 2048)
    FOLD_EDGE_B = (1, 8, 16, 17, 64, 65, 129, 256)
    BF16_SHAPES = ((128, 8192), (256, 16384))
    BF16_EDGE_SHAPES = None  # None: probes.bf16_fold.EDGE_SHAPES
    # P6's event-pair time at [256, 16384], predicted before its redesign
    # was first timed on the card (ms, low and high).
    P6_PREDICTED_MS = (0.010, 0.020)
    KEY_NORMALS = 1 << 24
    # Stage F: bench.HeadlineConfig fields; empty = the bench's widths.
    HEADLINE = {}

    def __init__(self, port):
        self.p = port
        self.dev = port.require_cuda()
        self.b = port.bench  # data recipes and route checks shared with it
        self.card = self.b.card_line()
        self.gen = torch.Generator(device=self.dev)
        self.max_err = {name: 0.0 for name in KERNELS}
        self.swaps = {name: 0 for name in KERNELS}
        self.main_launches = {name: 0 for name in KERNELS}
        self.times = {}
        self.library = {}
        self.bounds = {}
        self.retrieve_ms = {}
        self.t0 = time.perf_counter()
        self.timer = port.bench.Timer(
            device_ms=lambda fn, n: port.device_loop_ms(fn, n_loop=n,
                                                        trials=1),
            host_ms=lambda fn, n: port.chained_ms(fn, n=n, trials=1),
        )

    # -- helpers ----------------------------------------------------------

    def seed(self, s: int) -> torch.Generator:
        return self.gen.manual_seed(s)

    def compare(self, name, ref, got, atol) -> None:
        (rv, ri), (v, i) = ref, got
        torch.cuda.synchronize()
        self.swaps[name] += self.p.check_top_k(rv, ri, v, i, atol)
        both = torch.isfinite(rv) & torch.isfinite(v)
        if both.any():
            err = float((rv - v).abs()[both].max())
            self.max_err[name] = max(self.max_err[name], err)
        same = v[:, 1:] == v[:, :-1]
        valid = i[:, 1:] >= 0
        if not bool((i[:, 1:] > i[:, :-1])[same & valid].all()):
            raise AssertionError(f"{name}: an exact tie kept the higher id")

    def main_path(self, fn, probed=()):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after: the counts of the port's main path alone. Launches of
        the kernels in ``probed`` (K1/K2 run by a probe of them) are
        returned but stay out of the kernels line, which counts the
        retrieval path's."""
        k = self.p.kernels
        torch.cuda.synchronize()
        k.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {name: getattr(k, name).launches for name in KERNELS}
        for name, n in got.items():
            if name not in probed:
                self.main_launches[name] += n
        return out, got

    @staticmethod
    def expect(stage, counts, at_least=False, **want) -> None:
        for name, n in want.items():
            if counts[name] < n if at_least else counts[name] != n:
                raise AssertionError(
                    f"{stage}: launches {counts}, expected {name} "
                    f"{'>=' if at_least else '='} {n}")

    def bound(self, name, n_bytes, ops, op_rate) -> None:
        """The least time the card could take: bytes over the HBM rate or
        operations over their peak rate, whichever is larger."""
        t_bytes = n_bytes / HBM_BYTES_S * 1e3
        t_ops = ops / op_rate * 1e3
        self.bounds[name] = (max(t_bytes, t_ops),
                             "bytes" if t_bytes >= t_ops else "operations")

    # -- phases -----------------------------------------------------------

    def phase0_build(self) -> None:
        print(self.card, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        self.p.kernels.build_kernels()
        seconds = time.perf_counter() - t0
        for name in self.p.kernels.SOURCES:
            report = self.p.build_log.get(name, (seconds, ""))[1]
            entry = ""
            for line in report.splitlines():
                found = re.search(r"entry function '(\w+)'", line)
                if found:
                    entry = found.group(1)
                elif "registers" in line or "spill" in line:
                    print(f"ptxas {name} {entry}:", line.strip(), flush=True)
        log(phase="build", seconds=round(seconds, 3),
            sources=list(self.p.kernels.SOURCES),
            torch=torch.__version__, cuda=torch.version.cuda)
        self.int8_plan_line()
        self.fold_plan_line()

    def int8_plan_line(self) -> None:
        """The int8 kernels' query block, dynamic shared memory (the
        source's sum, held against topk_plan's) and CTAs per SM at the
        main path's shapes."""
        plan = self.p.topk_plan
        shapes = []
        for b, d, kk in ((self.B, self.D_C, 25), (self.B_MICRO, self.D_C, 25),
                         (self.B_MICRO, self.D_C, 256)):
            bq = plan.query_block(b, d, kk)
            smem = self.p.int8_smem_bytes(bq, d, kk)
            if smem != plan.smem_bytes(bq, d, kk):
                raise AssertionError(f"int8 shared memory {smem} != the "
                                     f"plan's {plan.smem_bytes(bq, d, kk)}")
            shapes.append({"b": b, "d": d, "k": kk, "bq": bq,
                           "smem_bytes": smem,
                           "ctas_per_sm": plan.ctas_per_sm(bq, d, kk)})
        log(phase="int8_plan", shapes=shapes)
        self.float_plan_line()

    def float_plan_line(self) -> None:
        """The float kernels' (K1, K3) query block, whether it stays
        resident in shared memory, the source's shared-memory sum held
        against topk_plan's, CTAs per SM, and the splits of the main and
        tau passes, at the main path's shapes and the edges' deepest."""
        plan, sms = self.p.topk_plan, self.p.sm_count(self.dev)
        shapes = []
        for b, d, kk, rows in (
                (self.B, self.D_A, 32, "bfloat16"),
                (self.B_MICRO, self.D_D, self.K_D, "bfloat16"),
                (self.B, self.V_COMMON, 32, "float32"),
                (self.B, self.EDGE_FLOAT_D[-1], 128, "bfloat16"),
                (self.B_MICRO, self.EDGE_FLOAT_D[-1], 256, "float32")):
            bq = plan.query_block(b, d, kk, rows)
            qres = plan.resident(bq, d, kk, rows)
            smem = self.p.float_smem_bytes(bq, d, kk, rows, qres)
            want = plan.smem_bytes(bq, d, kk, rows, qres)
            if smem != want:
                raise AssertionError(f"float shared memory {smem} != the "
                                     f"plan's {want}")
            fused = plan.fused_plan(self.N_A, b, d, kk, sms, rows)
            shapes.append({
                "b": b, "d": d, "k": kk, "rows": rows, "bq": bq,
                "resident": qres, "smem_bytes": smem,
                "ctas_per_sm": plan.ctas_per_sm(bq, d, kk, rows),
                "k1_splits_2m": fused.splits,
                "k1_tau_splits_2m": plan.tau_fused_plan(
                    self.N_A, b, d, kk, sms, rows)[0]})
        log(phase="float_plan", shapes=shapes)

    def fold_plan_line(self) -> None:
        """P7's launch (fold_plan: clusters of query blocks, TMA or the
        producer's loads, ring slots, shared memory held against the
        source's sum) at the main path's shapes and the edges' deepest."""
        i4, sms = self.p.int4_kernels, self.p.sm_count(self.dev)
        index = self.dev.index if self.dev.index is not None else 0
        shapes = []
        for n, b, d, packed in (
                (self.N_C, self.B, self.D_C, False),
                (self.INT4_N, self.B, self.D_C, True),
                (1024, 128, 256, True),
                (self.N_EDGE, 256, 2048, False),
                (self.N_EDGE, 8, 1000, False)):
            plan = i4.fold_plan(n, b, d, packed, sms)
            active = self.p.fold_active_clusters(index, plan.cluster,
                                                 plan.smem_bytes)
            plan = i4.fold_plan(n, b, d, packed, sms, True, active)
            src = self.p.fold_smem_bytes(d, packed, plan.stages,
                                         plan.resident)
            if src != plan.smem_bytes:
                raise AssertionError(f"fold shared memory {src} != the "
                                     f"plan's {plan.smem_bytes}")
            shapes.append({"n": n, "b": b, "d": d, "packed": packed,
                           "active_clusters": active, "grid": plan.grid,
                           **plan._asdict()})
        log(phase="fold_plan", shapes=shapes)

    def kernel_cases(self, n, d, dtype):
        g = self.seed(101)
        emb = self.b.unit(torch.randn((n, d), generator=g, device=self.dev))
        # Exact ties across doc splits: the first rows again further on.
        for start in (n // 3, n // 2, n - 300):
            emb[start:start + 256] = emb[:256]
        q = self.b.unit(torch.randn((self.B, d), generator=g, device=self.dev))
        half = torch.rand(n, generator=g, device=self.dev) < 0.5
        few = torch.zeros(n, dtype=torch.bool, device=self.dev)
        few[torch.randint(0, n, (5,), generator=g, device=self.dev)] = True
        return emb.to(dtype), q, half, few

    def phase1_k1(self) -> None:
        k = self.p.kernels
        n, d = self.N_KERNEL, self.D_KERNEL
        for dtype, atol in ((torch.float32, F32_ATOL),
                            (torch.bfloat16, BF16_ATOL)):
            emb, q, half, few = self.kernel_cases(n, d, dtype)
            cases = [(m, kk, b) for m in (None, half) for kk in (1, 32, 128)
                     for b in (1, 7, self.B)] + [(few, 32, 7)]
            for mask, kk, b in cases:
                got = k.fused_dense_top_k(emb, q[:b], kk, mask=mask)
                ref = k.fused_dense_top_k_torch(emb, q[:b], kk, mask=mask)
                self.compare("fused_dense_top_k", ref, got, atol)
                if mask is few:
                    assert int((got[1] >= 0).sum(dim=1).max()) <= 5
            del emb
        log(phase="k1_vs_plain", cases=2 * 19, ok=True,
            max_abs_err=self.max_err["fused_dense_top_k"],
            tie_swaps=self.swaps["fused_dense_top_k"])

    def phase2_k2(self) -> None:
        k = self.p.kernels
        n, d = self.N_KERNEL, self.D_KERNEL
        emb, q, half, few = self.kernel_cases(n, d, torch.float32)
        qd = self.p.quantize_embeddings(emb)
        del emb
        qv, qs = self.p.quantize_queries(q)
        cases = [(m, kk, b) for m in (None, half) for kk in (1, 32, 128)
                 for b in (1, 7, self.B)] + [(few, 32, 7)]
        for mask, kk, b in cases:
            args = (qd.values, qd.scales, qv[:b], qs[:b], kk)
            got = k.fused_dense_top_k_int8(*args, mask=mask)
            ref = k.fused_dense_top_k_int8_torch(*args, mask=mask)
            torch.cuda.synchronize()
            if not (torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])):
                raise AssertionError(f"K2 differs from its plain version "
                                     f"(k={kk}, B={b}, mask={mask is not None})")
            self.compare("fused_dense_top_k_int8", ref, got, 0.0)
        edges = 0
        for d in self.EDGE_D:
            values, scales, qv, qs, half = self.edge_rows(d)
            views = [(values, scales, f"D={d}"),
                     (values[1:], scales[1:], f"D={d}, values[1:]"),
                     (self.odd_address(values), scales,
                      f"D={d}, odd address")]
            for rows, scl, what in views:
                for b in self.EDGE_B:
                    for kk in self.EDGE_K:
                        mask = half[:rows.shape[0]] if kk == 25 else None
                        args = (rows, scl, qv[:b], qs[:b], kk)
                        self.equal_int8(
                            k.fused_dense_top_k_int8(*args, mask=mask),
                            k.fused_dense_top_k_int8_torch(*args, mask=mask),
                            f"K2, {what}, B={b}, k={kk}")
                        edges += 1
            del values, scales
        log(phase="k2_vs_plain", cases=len(cases), edge_cases=edges,
            edge_d=list(self.EDGE_D), edge_b=list(self.EDGE_B),
            edge_k=list(self.EDGE_K), ok=True,
            max_abs_err=self.max_err["fused_dense_top_k_int8"])

    @staticmethod
    def equal_int8(got, ref, what) -> None:
        """Values and ids equal. (The tie rule holds on the selection
        scores, before the query scale: two of them may round to one
        emitted value, so the emitted values' ties are not checked.)"""
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"{what}: differs from the plain version")

    def odd_address(self, t):
        """A copy of t whose base is one element past a 16-byte boundary
        (one byte for int8 rows)."""
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=self.dev)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == t.element_size()
        return view

    def edge_rows(self, d):
        """N_EDGE int8 rows of depth d over the full range, 256 queries:
        rows 0-31 copies of queries 0-7 (each query's best rows), copied
        again across sub-tiles (64), a tile boundary (100) and far off
        (n // 2, n - 40: other CTAs), scales with them, so exact ties sit
        at the top of the lists; all-127 and all--128 rows and queries."""
        g = self.seed(171 + d)
        n, i8 = self.N_EDGE, dict(device=self.dev, dtype=torch.int8)
        values = torch.randint(-128, 128, (n, d), generator=g, **i8)
        qv = torch.randint(-128, 128, (256, d), generator=g, **i8)
        qv[8], qv[9] = 127, -128
        values[40], values[41] = 127, -128
        scales = torch.rand(n, generator=g, device=self.dev) + 0.5
        values[:32] = qv[torch.arange(32, device=self.dev) % 8]
        for start in (64, 100, n // 2, n - 40):
            values[start:start + 32] = values[:32]
            scales[start:start + 32] = scales[:32]
        qs = torch.rand(256, generator=g, device=self.dev) + 0.5
        half = torch.rand(n, generator=g, device=self.dev) < 0.5
        return values, scales, qv, qs, half

    def ivf_tables(self, n, tile_n):
        """Tile tables over a matrix of n real rows in tiles of tile_n:
        name -> (table, n_real argument). Real entries ascending first,
        then -1; the last tile holds n % tile_n real rows."""
        tiles = -(-n // tile_n)
        g = self.seed(103 + tile_n)
        pick = torch.randperm(tiles - 1, generator=g, device=self.dev)
        part = torch.cat([pick[: (2 * tiles) // 5].sort().values,
                          torch.tensor([tiles - 1], device=self.dev)])
        i32 = dict(dtype=torch.int32, device=self.dev)

        def padded(real, slots):
            out = torch.full((slots,), -1, **i32)
            out[: real.numel()] = real.to(torch.int32)
            return out

        partial = padded(part, part.numel() + tiles // 5)
        return {
            "full": (torch.arange(tiles, **i32), n),
            "partial": (partial, n),
            "dynamic": (torch.cat([partial, torch.tensor([n], **i32)]), 0),
            "last": (padded(torch.tensor([tiles - 1]), 3), n),
        }

    def phase3_ivf_kernels(self) -> None:
        """K3 and K4 against their plain versions: the N_KERNEL matrix in
        f32, bf16 and int8, padded to whole tiles with non-zero junk rows
        that only the n_real mask keeps out."""
        k = self.p.kernels
        n, d = self.N_KERNEL, self.D_KERNEL
        emb, q, _, _ = self.kernel_cases(n, d, torch.float32)
        qd = self.p.quantize_embeddings(emb)
        qv, qs = self.p.quantize_queries(q)
        cases = [("full", 16, 8), ("partial", 1, 1), ("partial", 128, 256),
                 ("dynamic", 256, 8), ("dynamic", 16, 256), ("last", 256, 256)]
        count = 0
        for tile_n in self.IVF_TILES:
            npad = -(-n // tile_n) * tile_n
            tables = self.ivf_tables(n, tile_n)
            for rows in ("float32", "bfloat16", "int8"):
                if rows == "int8":
                    vals = torch.cat([qd.values, qd.values[: npad - n]])
                    scl = torch.cat([qd.scales, qd.scales[: npad - n]])
                else:
                    e = torch.cat([emb, emb[: npad - n]]).to(
                        getattr(torch, rows))
                for name, kk, b in cases:
                    table, n_real = tables[name]
                    kw = dict(tile_n=tile_n, n_real=n_real)
                    if rows == "int8":
                        args = (vals, scl, qv[:b], qs[:b], table, kk)
                        got = k.ivf_dense_top_k_int8(*args, **kw)
                        ref = k.ivf_dense_top_k_int8_torch(*args, **kw)
                        torch.cuda.synchronize()
                        if not (torch.equal(got[0], ref[0])
                                and torch.equal(got[1], ref[1])):
                            raise AssertionError(
                                f"K4 differs from its plain version ({name}, "
                                f"tile_n={tile_n}, k={kk}, B={b})")
                        self.compare("ivf_dense_top_k_int8", ref, got, 0.0)
                    else:
                        got = k.ivf_dense_top_k(e, q[:b], table, kk, **kw)
                        ref = k.ivf_dense_top_k_torch(e, q[:b], table, kk,
                                                      **kw)
                        self.compare("ivf_dense_top_k", ref, got,
                                     F32_ATOL if rows == "float32"
                                     else BF16_ATOL)
                    ids = got[1][got[1] >= 0].long()
                    real = table[: table.numel() - (n_real == 0)]
                    if not (bool((ids < n).all()) and bool(
                            torch.isin(ids // tile_n, real).all())):
                        raise AssertionError(f"an id outside the tabled "
                                             f"real rows ({name})")
                    count += 1
            del tables
        edges = self.k4_edges()
        log(phase="k3_k4_vs_plain", cases=count, k4_edge_cases=edges,
            ok=True,
            max_abs_err_k3=self.max_err["ivf_dense_top_k"],
            tie_swaps_k3=self.swaps["ivf_dense_top_k"],
            max_abs_err_k4=self.max_err["ivf_dense_top_k_int8"])
        self.float_edges()

    def float_edge_rows(self, d, dtype):
        """N_EDGE unit rows of depth d and 256 unit queries: rows 0-31
        copies of queries 0-7 (each query's best rows), copied again
        across sub-tiles (64), a tile boundary (100) and far off (n // 2,
        n - 40: other CTAs), so exact ties sit at the top of the lists; a
        mask over half the rows and one that keeps every 997th row only
        (fewer than k candidates in tau's subsample: tau = -inf)."""
        g = self.seed(191 + d)
        n = self.N_EDGE
        emb = self.b.unit(torch.randn((n, d), generator=g, device=self.dev))
        q = self.b.unit(torch.randn((256, d), generator=g, device=self.dev))
        emb[:32] = q[torch.arange(32, device=self.dev) % 8]
        for start in (64, 100, n // 2, n - 40):
            emb[start:start + 32] = emb[:32]
        half = torch.rand(n, generator=g, device=self.dev) < 0.5
        few = torch.zeros(n, dtype=torch.bool, device=self.dev)
        few[::997] = True
        return emb.to(dtype), q, half, few

    def float_edges(self) -> None:
        """K1 and K3 at the float path's edges, f32 and bf16 rows, each
        through check_top_k (and the tie rule) at F32_ATOL / BF16_ATOL;
        counts the cases whose tau was finite and -inf."""
        k = self.p.kernels
        n, t = self.N_EDGE, self.EDGE_TILE
        npad = -(-n // t) * t
        tables = self.ivf_tables(n, t)
        cases, taus = {"k1": 0, "k3": 0}, {"finite": 0, "neg_inf": 0}
        for dtype, atol in ((torch.float32, F32_ATOL),
                            (torch.bfloat16, BF16_ATOL)):
            for d in self.EDGE_FLOAT_D:
                emb, q, half, few = self.float_edge_rows(d, dtype)
                views = ((emb, "as is"), (emb[1:], "rows[1:]"),
                         (self.odd_address(emb), "unaligned"))
                for rows, what in views:
                    m = rows.shape[0]
                    for i, b in enumerate(self.EDGE_FLOAT_B):
                        kk = self.EDGE_FLOAT_K[(i + d) % len(
                            self.EDGE_FLOAT_K)]
                        mask = (None, half[:m], few[:m])[i % 3]
                        tau = k.subsample_tau(rows, q[:b], kk, mask)
                        finite = bool(torch.isfinite(tau).all())
                        taus["finite" if finite else "neg_inf"] += 1
                        self.compare(
                            "fused_dense_top_k",
                            k.fused_dense_top_k_torch(rows, q[:b], kk, mask),
                            k.fused_dense_top_k(rows, q[:b], kk, mask), atol)
                        cases["k1"] += 1
                padded = torch.cat([emb, emb[: npad - n]])
                for rows in (padded, self.odd_address(padded)):
                    for name in ("full", "partial", "dynamic"):
                        table, n_real = tables[name]
                        for i, b in enumerate(self.EDGE_FLOAT_B):
                            kk = (1, 16, 128, 256)[(i + cases["k3"]) % 4]
                            kw = dict(tile_n=t, n_real=n_real)
                            self.compare(
                                "ivf_dense_top_k",
                                k.ivf_dense_top_k_torch(rows, q[:b], table,
                                                        kk, **kw),
                                k.ivf_dense_top_k(rows, q[:b], table, kk,
                                                  **kw), atol)
                            cases["k3"] += 1
                del emb, padded
        if not (taus["finite"] and taus["neg_inf"]):
            raise AssertionError(f"the edges missed a tau kind: {taus}")
        log(phase="float_edges_vs_plain", k1_cases=cases["k1"],
            k3_cases=cases["k3"], tau_cases=taus,
            edge_d=list(self.EDGE_FLOAT_D), edge_b=list(self.EDGE_FLOAT_B),
            ok=True, max_abs_err_k1=self.max_err["fused_dense_top_k"],
            max_abs_err_k3=self.max_err["ivf_dense_top_k"],
            tie_swaps_k1=self.swaps["fused_dense_top_k"],
            tie_swaps_k3=self.swaps["ivf_dense_top_k"])

    def k4_edges(self) -> int:
        """K4 on phase 2's edge rows: each depth, aligned and at an odd
        address, over the full, partial and dynamic tables of EDGE_TILE
        (a ragged last tile), every B of EDGE_B, k cycling through 1, 25,
        128 and 256."""
        k, t = self.p.kernels, self.EDGE_TILE
        n = self.N_EDGE
        npad = -(-n // t) * t
        tables = self.ivf_tables(n, t)
        ks = (1, 25, 128, 256)
        count = 0
        for d in self.EDGE_D:
            values, scales, qv, qs, _ = self.edge_rows(d)
            vals = torch.cat([values, values[: npad - n]])
            scl = torch.cat([scales, scales[: npad - n]])
            for rows, what in ((vals, "aligned"),
                               (self.odd_address(vals), "odd address")):
                for name in ("full", "partial", "dynamic"):
                    table, n_real = tables[name]
                    for b in self.EDGE_B:
                        kk = ks[count % len(ks)]
                        args = (rows, scl, qv[:b], qs[:b], table, kk)
                        kw = dict(tile_n=t, n_real=n_real)
                        self.equal_int8(
                            k.ivf_dense_top_k_int8(*args, **kw),
                            k.ivf_dense_top_k_int8_torch(*args, **kw),
                            f"K4, D={d}, {what}, {name}, B={b}, k={kk}")
                        count += 1
            del values, vals
        return count

    def stage_a_index(self):
        """bench.py's 2M configuration, built on the device."""
        return self.b.scale_2m_data(self.b.Scale2MConfig(
            n=self.N_A, dim=self.D_A, batch=self.B, t=self.T, vocab=self.V,
            df=self.DF), self.dev)

    def make_index(self, emb, bm25, n, sources=()):
        return self.b.array_index(n, dense={MODEL: emb}, bm25=bm25,
                                  df=self.DF, sources=sources)

    def phase4_stage_a(self):
        p = self.p
        emb, gold, q, bm25, terms = self.stage_a_index()
        n = emb.shape[0]
        index = self.make_index(emb, bm25, n)
        kw = dict(similarity_k=32, common_sections_n=32, budget=1024)
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=True, **kw)
        assert retr.use_kernel, "2M-doc config must route to the kernels"
        assert retr._two_tier is None
        qd = {MODEL: q}
        w_h = {MODEL: 5.0, "BM25": 1.0}

        runs, counts = self.main_path(lambda: [
            retr.retrieve_device(qd, terms, w, None, 40.0)
            for w in (w_h, {MODEL: 1.0, "BM25": 0.0},
                      {MODEL: 0.0, "BM25": 1.0})
        ])
        self.expect("stage A", counts, fused_dense_top_k=3)
        r_h, r_d, r_b = (self.b.recall_at_10(r[0], gold) for r in runs)
        assert r_h >= 0.99, f"2M hybrid recall@10 {r_h} below 0.99"
        assert r_d >= 0.95 and r_b >= 0.95, (r_d, r_b)

        ref_retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                    dense_backend="torch", **kw)
        assert not ref_retr.use_kernel
        ref = ref_retr.retrieve_device(qd, terms, w_h, None, 40.0)
        routes = self.b.assert_route_parity(
            runs[0], ref,
            [lambda ids: self.b.exact_dense(emb, q, ids),
             lambda ids: self.b.exact_bm25_uniform(bm25, terms, self.DF,
                                                   ids)],
            [F32_ATOL, BM25_ATOL],
        )
        self.retrieve_ms["A"] = p.cuda_event_ms(
            lambda: retr.retrieve_device(qd, terms, w_h, None, 40.0))
        log(stage="A_2M_hybrid", recall10_hybrid=r_h, recall10_dense=r_d,
            recall10_bm25=r_b, k1_launches=counts["fused_dense_top_k"],
            retrieve_ms=self.retrieve_ms["A"], **routes)
        del ref, ref_retr, runs
        return emb, gold, q, bm25, terms

    def phase5_stage_b(self, emb, q, bm25, terms):
        p = self.p
        n = emb.shape[0]
        sources = [("CG" if i % 2 == 0 else "NG") + str(i // 2)
                   for i in range(n)]
        index = self.make_index(emb, bm25, n, sources)
        kw = dict(similarity_k=32, common_sections_n=32, budget=1024)
        # A float32 common tier: bf16 would round the impacts by up to
        # 2^-9 relative, moving BM25 scores by ~1e-3, past the 1e-4 the
        # comparison with the CSR route holds.
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                two_tier_common=self.V_COMMON,
                                two_tier_dtype="float32", **kw)
        assert retr.use_kernel and retr._two_tier is not None
        assert retr._two_tier.v_common == self.V_COMMON
        # Half of each query's terms planted, half drawn from the common
        # tier, so the common-tier K1 call carries real counts.
        common = torch.nonzero(retr._two_tier.common_map[:-1] >= 0).flatten()
        g = self.seed(12)
        b = terms.shape[0]
        pick = torch.rand((b, common.numel()), generator=g,
                          device=self.dev).argsort(dim=1)[:, :8]
        terms_b = torch.cat([terms[:, :8],
                             common[pick].to(torch.int32)], dim=1)
        qd = {MODEL: q}
        w = {MODEL: 5.0, "BM25": 1.0}
        out, counts = self.main_path(
            lambda: retr.retrieve_device(qd, terms_b, w, "CG", 40.0))
        self.expect("stage B", counts, fused_dense_top_k=2)
        mask = index.filter_mask("CG")
        assert int(mask.sum()) == n // 2
        for ids in (out[0], out[2].reshape(-1, out[2].shape[-1])):
            live = ids[ids >= 0].long()
            assert bool(mask[live].all()), "an id outside the filter mask"
        ref_retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                    dense_backend="torch", **kw)
        ref = ref_retr.retrieve_device(qd, terms_b, w, "CG", 40.0)
        routes = self.b.assert_route_parity(
            out, ref,
            [lambda ids: self.b.exact_dense(emb, q, ids),
             lambda ids: self.b.exact_bm25_uniform(bm25, terms_b, self.DF,
                                                   ids)],
            [F32_ATOL, BM25_ATOL],
        )
        log(stage="B_2M_filtered_two_tier",
            k1_launches=counts["fused_dense_top_k"], masked_fraction=0.5,
            retrieve_ms=p.cuda_event_ms(
                lambda: retr.retrieve_device(qd, terms_b, w, "CG", 40.0)),
            **routes)

    def phase17_search_engine(self, emb, gold, q, bm25, terms) -> None:
        """SearchEngine (the reference-parity API, plain torch routes, no
        kernel) on stage A's index with ids, sources and a vocabulary:
        hybrid retrieve with return_docs, its planted recall, its dense
        lists against K1's, and its host-clock time beside the fused
        retriever's on the same queries."""
        t0 = time.perf_counter()
        p = self.p
        n = emb.shape[0]
        ids = [str(i) for i in range(n)]
        meta = p.CorpusMeta(ids=ids, sources=["CG"] * n, contents=[""] * n,
                            urls=[], n_docs=n, n_docs_padded=n)
        vocab = {f"t{v}": v for v in range(bm25.vocab_size)}
        index = p.ArrayIndex(
            meta=meta, dense={MODEL: emb}, bm25=bm25, vocab=vocab,
            bm25_stats={"max_df": self.DF},
            bm25_doc_mask=np.ones(n, dtype=bool))
        tokens = [[f"t{v}" for v in row if v >= 0] for row in terms.tolist()]
        eng = p.SearchEngine(index)
        w = {MODEL: 5.0, "BM25": 1.0}
        kw = dict(query_token_lists=tokens, similarity_k=32,
                  common_sections_n=15, model_weights=w,
                  use_hybrid_search=True, return_docs=True)

        def retrieve():
            return eng.retrieve({MODEL: q}, **kw)

        docs, counts = self.main_path(retrieve)
        if any(counts.values()):
            raise AssertionError(f"SearchEngine launched kernels: {counts}")
        gold_ids = [str(g) for g in gold.tolist()]
        assert all(len(d) == 15 for d in docs), "15 docs per query"
        recall = sum(g in [d["id"] for d in ds[:10]]
                     for g, ds in zip(gold_ids, docs)) / len(gold_ids)
        assert recall >= 0.99, f"SearchEngine recall@10 {recall} below 0.99"
        vals, rows = eng.similarity_search_batch(q, MODEL, 32)
        kv, ki = p.kernels.fused_dense_top_k(emb, q, 32)
        torch.cuda.synchronize()
        swaps = p.check_top_k(kv, ki, vals, rows, BF16_ATOL)
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                similarity_k=32, common_sections_n=15)
        assert retr.use_kernel
        term_ids = torch.as_tensor(index.pad_term_ids(tokens, self.T),
                                   device=self.dev)
        host_ms = {
            "search_engine_retrieve": self.host_call_ms(retrieve),
            "fused_retrieve_device": self.host_call_ms(
                lambda: retr.retrieve_device({MODEL: q}, term_ids, w, None,
                                             60.0)),
        }
        log(stage="A_search_engine", batch=q.shape[0], similarity_k=32,
            common_sections_n=15, weights=[5, 1], recall10_planted=recall,
            kernel_launches=0, dense_lists_vs_k1_swaps=swaps,
            dense_lists_atol=BF16_ATOL, host_ms=host_ms, card=self.card,
            method="host clock around one call ending in a synchronize, "
            "median of 3 after a warm-up", seconds=time.perf_counter() - t0)
        del eng, index, retr

    @staticmethod
    def host_call_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return sorted(samples)[1]

    def time_k1(self, emb, q) -> None:
        """K1 at stage A's shape: kernel, plain version, yardstick, bound."""
        k = self.p.kernels
        self.time_pair(
            "fused_dense_top_k",
            lambda: k.fused_dense_top_k(emb, q, 32),
            lambda: k.fused_dense_top_k_torch(emb, q, 32),
            "2^21 x 256 bf16, B=256, k=32, no mask",
        )
        self.time_library(
            "fused_dense_top_k",
            lambda: torch.topk(q @ emb.float().T, 32, dim=1),
            "torch.topk(q @ emb.float().T): upcast, f32 matmul, top-k",
        )
        (n, d), b = emb.shape, q.shape[0]
        self.bound("fused_dense_top_k", n * d * 2 + b * d * 4 + b * 32 * 8,
                   QUERY_PIECES * 2 * b * n * d, BF16_FLOP_S)
        log(timing="fused_dense_top_k_bound", bound_ms=self.bounds[
            "fused_dense_top_k"][0], ffma_bound_ms=2 * b * n * d / F32_FLOP_S
            * 1e3, what="bf16 MMA on three query pieces at 989 TFLOP/s; "
            "the same product on FFMA at 67 TFLOP/s beside it")
        got = k.fused_dense_top_k(emb, q, 32)
        self.compare("fused_dense_top_k",
                     k.fused_dense_top_k_torch(emb, q, 32), got, BF16_ATOL)

    def stage_d_index(self):
        """bench.py's 2M IVF configuration: 2048 planted unit centres,
        sigma = 0.08 doc noise, bf16; BATCHES_D x B_MICRO planted queries
        (gold + 0.05 noise) with planted BM25 terms."""
        n, d, c = self.N_D, self.D_D, self.CENTRES_D
        g = self.seed(41)
        cent = self.b.unit(torch.randn((c, d), generator=g, device=self.dev))
        which = torch.randint(0, c, (n,), generator=g, device=self.dev)
        emb = self.b.unit(cent[which] + 0.08 * torch.randn(
            (n, d), generator=g, device=self.dev)).to(torch.bfloat16)
        del cent, which
        n_q = self.BATCHES_D * self.B_MICRO
        gold = torch.randint(0, n, (n_q,), generator=g, device=self.dev)
        q = emb[gold].float()
        q = self.b.unit(q + 0.05 * torch.randn(q.shape, generator=g,
                                             device=self.dev))
        bm25, terms = self.b.planted_bm25(g, n, gold, self.V_D, self.T,
                                          self.DF)
        return emb, gold, q, bm25, terms

    def phase6_stage_d(self):
        p = self.p
        emb, gold, q, bm25, terms = self.stage_d_index()
        n = emb.shape[0]
        sources = [("CG" if i % 2 == 0 else "NG") + str(i // 2)
                   for i in range(n)]
        index = self.make_index(emb, bm25, n, sources)
        assert index.filter_mask_or_none(None) is None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iv = p.attach_ivf(index, MODEL, tile_n=self.TILE_D, n_iters=10,
                          seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        log(stage="D_ivf_build", seconds=build_s, n_clusters=iv.n_clusters,
            n_tiles=iv.n_tiles, max_cluster_tiles=iv.max_cluster_tiles,
            tile_n=iv.tile_n)
        kw = dict(use_bm25=True, similarity_k=self.K_D,
                  common_sections_n=self.K_D, budget=1024)
        retr = p.FusedRetriever(index, (MODEL,), nprobe=self.NPROBE_D, **kw)
        exact = p.FusedRetriever(index, (MODEL,), **kw)
        assert retr.use_kernel and exact.use_kernel
        w = {MODEL: 5.0, "BM25": 1.0}
        bm, nb = self.B_MICRO, self.BATCHES_D

        def call(r, i0, b, filt=None):
            return r.retrieve_device({MODEL: q[i0:i0 + b]},
                                     terms[i0:i0 + b], w, filt, 40.0)

        runs, counts = self.main_path(
            lambda: [call(retr, i * bm, bm) for i in range(nb)])
        self.expect("stage D, B=8", counts, ivf_dense_top_k=nb,
                    fused_dense_top_k=0)
        dense = torch.cat([r[2][0] for r in runs])
        fused = torch.cat([r[0] for r in runs])
        r_dense = self.b.recall_at_10(dense, gold)
        r_fused = self.b.recall_at_10(fused, gold)
        assert r_dense >= 0.90, f"2M IVF recall@10 {r_dense} below 0.90"

        wide, c_wide = self.main_path(lambda: call(retr, 0, self.B))
        self.expect("stage D, B=256", c_wide, fused_dense_top_k=1,
                    ivf_dense_top_k=0)
        filt, c_filt = self.main_path(lambda: call(retr, 0, bm, "CG"))
        self.expect("stage D, filtered", c_filt, fused_dense_top_k=1,
                    ivf_dense_top_k=0)
        mask = index.filter_mask("CG")
        for ids in (filt[0], filt[2].reshape(-1, filt[2].shape[-1])):
            live = ids[ids >= 0].long()
            assert bool(mask[live].all()), "an id outside the filter mask"

        full = p.FusedRetriever(index, (MODEL,), nprobe=iv.n_clusters,
                                ivf_route="always", **kw)
        got, c_full = self.main_path(lambda: call(full, 0, bm))
        self.expect("stage D, full probe", c_full, ivf_dense_top_k=1,
                    fused_dense_top_k=0)
        ref = call(exact, 0, bm)
        qb = q[:bm]
        swaps = p.check_top_k(self.b.exact_dense(emb, qb, ref[2][0]),
                              ref[2][0],
                              self.b.exact_dense(emb, qb, got[2][0]),
                              got[2][0], FULL_PROBE_ATOL)
        log(stage="D_2M_ivf", recall10_dense_b8=r_dense,
            recall10_fused_b8=r_fused, calls_b8=nb,
            k3_launches_b8=counts["ivf_dense_top_k"],
            k1_launches_b8=counts["fused_dense_top_k"],
            recall10_dense_b256=self.b.recall_at_10(wide[2][0], gold[:self.B]),
            k1_launches_b256=c_wide["fused_dense_top_k"],
            k1_launches_filtered=c_filt["fused_dense_top_k"],
            full_probe_list_swaps_vs_exact=swaps)
        self.crossover("D_2M_bf16", index, kw, self.NPROBE_D, q, terms, w,
                       self.CROSS_B)
        self.time_ivf_d(emb, q[:bm], iv)
        return index

    def crossover(self, label, index, kw, nprobe, q, terms, w,
                  batches) -> None:
        """retrieve_device time of the IVF route (ivf_route="always") and
        of the exact route per batch size, in turns, with the measured
        tile fraction and the analytic coverage the "auto" rule reads."""
        p = self.p
        t = p.cuda_event_ms
        ivf = p.FusedRetriever(index, (MODEL,), nprobe=nprobe,
                               ivf_route="always", **kw)
        exact = p.FusedRetriever(index, (MODEL,), **kw)
        iv = index.ivf[MODEL]
        for b in batches:
            qd = {MODEL: q[:b]}
            tb = None if terms is None else terms[:b]

            def run(r):
                return lambda: r.retrieve_device(qd, tb, w, None, 40.0)

            e1, i1, i2, e2 = t(run(exact)), t(run(ivf)), t(run(ivf)), \
                t(run(exact))
            _, n_unique = p.build_tile_table(
                iv.centroids, iv.cluster_start, q[:b], nprobe=nprobe,
                max_tiles=iv.n_tiles, tile_n=iv.tile_n,
                mct=iv.max_cluster_tiles)
            cov = p.ivf_coverage(b, nprobe, iv.n_clusters)
            log(crossover=label, B=b, ivf_ms=min(i1, i2),
                exact_ms=min(e1, e2), ivf_ms_runs=[i1, i2],
                exact_ms_runs=[e1, e2],
                tile_fraction=int(n_unique) / iv.n_tiles, coverage=cov,
                auto_route="ivf" if cov <= 0.25 else "exact",
                card=self.card)

    def scheduled_rows(self, table, iv) -> torch.Tensor:
        """The real rows the table schedules, ascending."""
        real = table[table >= 0].long()
        rows = (real[:, None] * iv.tile_n
                + torch.arange(iv.tile_n, device=self.dev)).reshape(-1)
        return rows[rows < iv.n_real]

    def time_ivf_d(self, emb, q8, iv) -> None:
        """K3 at stage D's B = 8 table: kernel, plain version, yardstick,
        bound; and K1 at the same B = 8 over the whole corpus."""
        p, k = self.p, self.p.kernels
        table, n_unique = p.build_tile_table(
            iv.centroids, iv.cluster_start, q8, nprobe=self.NPROBE_D,
            max_tiles=p.default_max_tiles(iv, q8.shape[0], self.NPROBE_D),
            tile_n=iv.tile_n, mct=iv.max_cluster_tiles)
        kw = dict(tile_n=iv.tile_n, n_real=iv.n_real)
        kk = self.K_D
        table_ms = p.cuda_event_ms(lambda: p.build_tile_table(
            iv.centroids, iv.cluster_start, q8, nprobe=self.NPROBE_D,
            max_tiles=table.numel(), tile_n=iv.tile_n,
            mct=iv.max_cluster_tiles))
        log(timing="build_tile_table", shape="2^21 x 256 IVF, 1448 "
            f"clusters, B=8, nprobe={self.NPROBE_D}", ms=table_ms,
            card=self.card)
        self.compare("ivf_dense_top_k",
                     k.ivf_dense_top_k_torch(iv.emb, q8, table, kk, **kw),
                     k.ivf_dense_top_k(iv.emb, q8, table, kk, **kw),
                     BF16_ATOL)
        rows = self.scheduled_rows(table, iv)
        shape = (f"2^21 x 256 bf16 IVF, B=8, nprobe={self.NPROBE_D}, "
                 f"k={kk}, {int(n_unique)} of {table.numel()} table slots "
                 f"real, {rows.numel()} rows")
        self.time_pair(
            "ivf_dense_top_k",
            lambda: k.ivf_dense_top_k(iv.emb, q8, table, kk, **kw),
            lambda: k.ivf_dense_top_k_torch(iv.emb, q8, table, kk, **kw),
            shape,
        )

        def library():
            v, i = torch.topk(q8 @ iv.emb.index_select(0, rows).float().T,
                              kk, dim=1)
            return v, rows[i]

        self.time_library(
            "ivf_dense_top_k", library,
            "index_select of the scheduled rows, upcast, f32 matmul, "
            "torch.topk")
        r, (b, d) = rows.numel(), q8.shape
        self.bound("ivf_dense_top_k",
                   r * d * 2 + b * d * 4 + table.numel() * 4 + b * kk * 8,
                   QUERY_PIECES * 2 * b * r * d, BF16_FLOP_S)
        self.time_pair(
            "fused_dense_top_k_b8",
            lambda: k.fused_dense_top_k(emb, q8, kk),
            lambda: k.fused_dense_top_k_torch(emb, q8, kk),
            f"2^21 x 256 bf16 exact, B=8, k={kk} (K1 beside K3)",
        )

    def stage_c_index(self):
        """bench.py's int8 configuration: 4096 cluster centres, doc noise
        0.042, quantized chunk by chunk so the 43 GB f32 matrix never
        exists. Rows are cluster-major: row r belongs to centre r // per."""
        values, scales, cent, g = self.b.int8_corpus(self.b.Int8Config(
            n=self.N_C, dim=self.D_C, clusters=self.CLUSTERS,
            chunks=self.CHUNKS), self.dev)
        gold = torch.randint(0, self.N_C, (self.B,), generator=g,
                             device=self.dev)
        q = self.b.planted_int8_queries(values, scales, gold, g)
        return values, scales, gold, q, cent

    def phase7_stage_c(self):
        p = self.p
        values, scales, gold, q, cent = self.stage_c_index()
        n = values.shape[0]
        meta = p.CorpusMeta(ids=[], sources=[], contents=[], urls=[],
                            n_docs=n, n_docs_padded=n)
        index = p.ArrayIndex(
            meta=meta, dense={}, bm25=None, vocab=None, bm25_stats=None,
            dense_q={MODEL: p.QuantizedDense(values=values, scales=scales)},
        )
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=False,
                                similarity_k=25, common_sections_n=25)
        assert retr.use_kernel, "10.5M int8 config must route to the kernels"
        (fids, _, lists), counts = self.main_path(
            lambda: retr.retrieve_device({MODEL: q}, None, {MODEL: 1.0},
                                         None, 40.0))
        self.expect("stage C", counts, fused_dense_top_k_int8=1)
        r10 = self.b.recall_at_10(fids, gold)
        assert r10 >= 0.95, f"10.5M int8 recall@10 {r10} below 0.95"
        qv, qs = p.quantize_queries(q[:8])
        ref = p.kernels.fused_dense_top_k_int8_torch(values, scales, qv, qs, 25)
        if not torch.equal(lists[0][:8], ref[1]):
            raise AssertionError("stage C ids differ from the plain version")
        got8 = p.kernels.fused_dense_top_k_int8(values, scales, qv, qs, 25)
        self.compare("fused_dense_top_k_int8", ref, got8, 0.0)
        # SearchEngine's plain int8 route at B = 8 ([8, N] f32 scores,
        # 0.34 GB) against K2 on the same queries.
        t0 = time.perf_counter()
        sv, si = p.SearchEngine(index).similarity_search_batch(
            q[:8], MODEL, 25)
        se_swaps = p.check_top_k(got8[0], got8[1], sv, si, INT8_ATOL)
        se_seconds = time.perf_counter() - t0
        self.retrieve_ms["C"] = p.cuda_event_ms(lambda: retr.retrieve_device(
            {MODEL: q}, None, {MODEL: 1.0}, None, 40.0))
        log(stage="C_10.5M_int8", recall10=r10,
            k2_launches=counts["fused_dense_top_k_int8"],
            ids_equal_plain_8_queries=True,
            retrieve_ms=self.retrieve_ms["C"],
            search_engine_b8_vs_k2_swaps=se_swaps,
            search_engine_b8_atol=INT8_ATOL,
            search_engine_b8_seconds=se_seconds)
        return index, q, cent

    def phase8_stage_e(self, index, cent):
        """bench.py's 10.5M int8 IVF: the corpus is already cluster-major,
        so the IVF is free: identity permutation, equal cluster spans, the
        planted centres as centroids; no second copy of the matrix."""
        p = self.p
        qd = index.dense_q[MODEL]
        n, c = qd.values.shape[0], cent.shape[0]
        per = n // c
        iv = p.IVFDense(
            centroids=cent,
            perm=torch.arange(n, dtype=torch.int32, device=self.dev),
            cluster_start=torch.arange(c + 1, dtype=torch.int32,
                                       device=self.dev) * per,
            tile_n=self.TILE_E, n_real=n,
            max_cluster_tiles=per // self.TILE_E + 2,
            values=qd.values, scales=qd.scales,
        )
        index.ivf = {MODEL: iv}
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=False,
                                similarity_k=self.K_E,
                                common_sections_n=self.K_E,
                                nprobe=self.NPROBE_E)
        g = self.seed(29)
        bm, nb = self.B_MICRO, self.BATCHES_E
        gold = torch.randint(0, n, (nb * bm,), generator=g, device=self.dev)
        q = self.b.planted_int8_queries(qd.values, qd.scales, gold, g)
        w = {MODEL: 1.0}
        runs, counts = self.main_path(lambda: [
            retr.retrieve_device({MODEL: q[i * bm:(i + 1) * bm]}, None, w,
                                 None, 40.0) for i in range(nb)])
        self.expect("stage E, B=8", counts, ivf_dense_top_k_int8=nb,
                    fused_dense_top_k_int8=0)
        r10 = self.b.recall_at_10(torch.cat([r[0] for r in runs]), gold)
        assert r10 >= 0.95, f"10.5M int8 IVF recall@10 {r10} below 0.95"
        # All BATCHES_E x B_MICRO = 256 queries at once.
        _, c_wide = self.main_path(lambda: retr.retrieve_device(
            {MODEL: q}, None, w, None, 40.0))
        self.expect(f"stage E, B={q.shape[0]}", c_wide, fused_dense_top_k_int8=1,
                    ivf_dense_top_k_int8=0)
        q8 = q[:bm]
        table, n_unique = p.build_tile_table(
            iv.centroids, iv.cluster_start, q8, nprobe=self.NPROBE_E,
            max_tiles=p.default_max_tiles(iv, bm, self.NPROBE_E),
            tile_n=iv.tile_n, mct=iv.max_cluster_tiles)
        qv, qs = p.quantize_queries(q8)
        args = (iv.values, iv.scales, qv, qs, table, self.K_E)
        kw = dict(tile_n=iv.tile_n, n_real=iv.n_real)
        ref = p.kernels.ivf_dense_top_k_int8_torch(*args, **kw)
        got = p.kernels.ivf_dense_top_k_int8(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])):
            raise AssertionError("stage E: K4 differs from its plain version")
        self.compare("ivf_dense_top_k_int8", ref, got, 0.0)
        self.crossover("E_10.5M_int8", index,
                       dict(use_bm25=False, similarity_k=self.K_E,
                            common_sections_n=self.K_E),
                       self.NPROBE_E, q, None, w, (bm,))
        log(stage="E_10.5M_int8_ivf", recall10_b8=r10, calls_b8=nb,
            k4_launches_b8=counts["ivf_dense_top_k_int8"],
            k2_launches_b8=counts["fused_dense_top_k_int8"],
            k2_launches_b256=c_wide["fused_dense_top_k_int8"],
            ids_equal_plain_8_queries=True)
        self.time_ivf_e(iv, qv, qs, table, n_unique)

    def time_ivf_e(self, iv, qv, qs, table, n_unique) -> None:
        """K4 at stage E's B = 8 table: kernel, plain version, yardstick,
        bound; and K2 at the same B = 8 over the whole corpus."""
        k = self.p.kernels
        kk, b = self.K_E, qv.shape[0]
        args = (iv.values, iv.scales, qv, qs, table, kk)
        kw = dict(tile_n=iv.tile_n, n_real=iv.n_real)
        rows = self.scheduled_rows(table, iv)
        self.time_pair(
            "ivf_dense_top_k_int8",
            lambda: k.ivf_dense_top_k_int8(*args, **kw),
            lambda: k.ivf_dense_top_k_int8_torch(*args, **kw),
            f"10,485,760 x 1024 int8 IVF, B=8, nprobe={self.NPROBE_E}, "
            f"k={kk}, {int(n_unique)} of {table.numel()} table slots real, "
            f"{rows.numel()} rows",
        )
        # torch._int_mm needs more than 16 rows: the 8 queries are padded
        # with zero rows to 32.
        qv32 = torch.cat([qv, qv.new_zeros((32 - b, qv.shape[1]))])

        def library():
            acc = torch._int_mm(qv32, iv.values.index_select(0, rows).T)[:b]
            v, i = torch.topk(acc.float() * iv.scales[rows][None, :], kk,
                              dim=1)
            return v * qs[:, None], rows[i]

        self.time_library(
            "ivf_dense_top_k_int8", library,
            "index_select of the scheduled rows, torch._int_mm (queries "
            "padded to 32 rows), row scales, torch.topk, query scales")
        r, d = rows.numel(), qv.shape[1]
        self.bound("ivf_dense_top_k_int8",
                   r * d + r * 4 + b * (d + 4) + table.numel() * 4
                   + b * kk * 8, 2 * b * r * d, INT8_OP_S)
        self.time_pair(
            "fused_dense_top_k_int8_b8",
            lambda: k.fused_dense_top_k_int8(iv.values, iv.scales, qv, qs,
                                             kk),
            lambda: k.fused_dense_top_k_int8_torch(iv.values, iv.scales, qv,
                                                   qs, kk),
            f"10,485,760 x 1024 int8 exact, B=8, k={kk} (K2 beside K4)",
        )

    def time_k2(self, values, scales, q) -> None:
        """K2 at stage C's shape: kernel, plain version, yardstick, bound."""
        k = self.p.kernels
        qv, qs = self.p.quantize_queries(q)
        self.time_pair(
            "fused_dense_top_k_int8",
            lambda: k.fused_dense_top_k_int8(values, scales, qv, qs, 25),
            lambda: k.fused_dense_top_k_int8_torch(values, scales, qv, qs, 25),
            "10,485,760 x 1024 int8, B=256, k=25, no mask",
        )
        (n, d), b = values.shape, q.shape[0]
        step = 1 << 21

        def library():
            # Chunked over the doc axis: the [256, 10.5M] int32 and f32
            # score matrices would take 21 GB at once.
            vs, ids = [], []
            for s0 in range(0, n, step):
                acc = torch._int_mm(qv, values[s0:s0 + step].T)
                v, i = torch.topk(acc.float() * scales[s0:s0 + step][None],
                                  25, dim=1)
                vs.append(v)
                ids.append(i + s0)
            v, i = torch.topk(torch.cat(vs, dim=1), 25, dim=1)
            return v * qs[:, None], torch.take_along_dim(
                torch.cat(ids, dim=1), i, dim=1)

        self.time_library(
            "fused_dense_top_k_int8", library,
            f"torch._int_mm, row scales, torch.topk per {step}-row chunk of "
            f"the doc axis, torch.topk over the chunks, query scales")
        self.bound("fused_dense_top_k_int8",
                   n * d + n * 4 + b * (d + 4) + b * 25 * 8, 2 * b * n * d,
                   INT8_OP_S)

    def time_pair(self, name, kernel_fn, plain_fn, shape,
                  plain_n=10) -> None:
        """plain_n < 10 for plain versions that take a tenth of a second
        or more: their median of plain_n calls after one warm-up, or, for
        plain_n = 1 (seconds a call), one call without a warm-up."""
        t = self.p.cuda_event_ms
        warmup = 0 if plain_n == 1 else 1

        def plain():
            return t(plain_fn) if plain_n == 10 else t(plain_fn, n=plain_n,
                                                       warmup=warmup)
        # plain, kernel, kernel, plain: drift shows as a gap between pairs.
        p1 = plain()
        k1 = t(kernel_fn)
        k2 = t(kernel_fn)
        p2 = plain()
        ms, plain_ms = min(k1, k2), min(p1, p2)
        self.times[name] = (ms, plain_ms)
        log(timing=name, shape=shape, ms=ms, plain_ms=plain_ms,
            ms_runs=[k1, k2], plain_ms_runs=[p1, p2], card=self.card,
            method="CUDA events, median of 10 after 3 warm-ups"
            + ("" if plain_n == 10 else
               f" (plain: median of {plain_n} after {warmup} warm-up)"))

    def time_library(self, name, fn, what) -> None:
        t = self.p.cuda_event_ms
        runs = [t(fn), t(fn)]
        self.library[name] = min(runs)
        log(timing=name + "_library", what=what, ms=min(runs), ms_runs=runs,
            card=self.card)

    def no_library(self, name, why) -> None:
        self.library[name] = None
        log(timing=name + "_library", ms=None, what="none: " + why)

    # -- the bench's paths: stream kernels, stage F, floors, overlap -------

    def stream_parts(self, g, dtype, m, rows, cols):
        if dtype == torch.int8:
            return [torch.randint(-127, 128, (rows, cols), generator=g,
                                  device=self.dev, dtype=torch.int8)
                    for _ in range(m)]
        return [torch.randn((rows, cols), generator=g,
                            device=self.dev).to(dtype) for _ in range(m)]

    def check_stream(self, parts, bias=None, **launch) -> None:
        err = self.p.check_stream_sum(parts, bias, **launch)
        self.max_err["stream_sum"] = max(self.max_err["stream_sum"], err)

    def phase9_stream_kernels(self) -> None:
        """stream_sum and stream_sum_busy against their plain versions."""
        k = self.p.kernels
        g = self.seed(61)
        rows, d = self.STREAM_ROWS, self.STREAM_D
        bias = torch.tensor([3.25], device=self.dev)
        cases = 0
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for m in (1, 2, 8):
                parts = self.stream_parts(g, dtype, m, rows, d)
                for b in (None, bias):
                    self.check_stream(parts, b)
                    cases += 1
            self.check_stream(self.stream_parts(g, dtype, 1, 1, 7), bias)
            flat = parts[0].reshape(-1)
            for start in (1, 3):  # views that start mid-vector
                assert flat[start:].data_ptr() % 16 != 0
                self.check_stream(flat[start:])
            cases += 3
        # Every partial sum below 2^24: float32 holds it exactly, so a
        # dropped or doubled tile would show.
        x = torch.randint(0, 2, (self.EXACT_ROWS, 15), generator=g,
                          device=self.dev, dtype=torch.int8)
        want = int(x.sum(dtype=torch.int64))
        assert want < 2 ** 24
        if float(k.stream_sum(x)) != float(want):
            raise AssertionError("the int8 exact case is not exact")
        # One launch a call, its partials and ticket kept across calls:
        # every launch shape against the plain version, and two calls of
        # each the same bits.
        y = self.stream_parts(g, torch.bfloat16, 1, rows, d)[0]
        shapes = [dict(ctas_per_sm=c, unroll=u)
                  for c in self.STREAM_CTAS for u in k.stream.UNROLLS]
        for launch in shapes:
            self.check_stream([y, y[1:]], **launch)
            before = k.stream_sum.launches
            first = k.stream_sum(y, **launch)
            second = k.stream_sum(y, **launch)
            if k.stream_sum.launches != before + 2:
                raise AssertionError("stream_sum counted other than one "
                                     "launch a call")
            if not torch.equal(first, second):
                raise AssertionError(f"stream_sum {launch}: two calls differ")
        cases += len(shapes)
        grid = self.p.sm_grid(self.dev)
        seed = torch.tensor(0.5, device=self.dev)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            (emb,) = self.stream_parts(g, dtype, 1, rows, d)
            for xi in self.BUSY_X:
                err = self.p.check_stream_sum_busy(emb, seed, xi, grid, 16)
                self.max_err["stream_sum_busy"] = max(
                    self.max_err["stream_sum_busy"], err)
        log(phase="stream_vs_plain", cases=cases, int8_exact=True,
            launch_shapes=len(shapes), two_calls_bit_equal=True,
            busy_cases=3 * len(self.BUSY_X), busy_chains_bit_equal=True,
            ok=True, max_abs_err=self.max_err["stream_sum"],
            max_abs_err_busy=self.max_err["stream_sum_busy"])

    def phase10_stage_f(self) -> None:
        """The bench's headline stage at full width, through its own
        function: recall guards and route parity inside."""
        b = self.p.bench
        cfg = b.HeadlineConfig(**self.HEADLINE)
        out, counts = self.main_path(
            lambda: b.headline_stage(self.dev, 1, self.timer, cfg))
        # 9,728 docs are below the kernel threshold: both routes are torch.
        self.expect("stage F", counts, fused_dense_top_k=0)
        assert not out["kernel_route_headline"]
        log(stage="F_headline", card=self.card,
            **{key: v for key, v in out.items() if not key.endswith("_runs")})

    def phase11_floor(self, stage, mat) -> None:
        """The bench's stream floor over a stage's matrix, against the
        stage's retrieve_device time, beside the library's sum."""
        out, counts = self.main_path(
            lambda: self.p.bench.stream_floor(mat, self.timer, repeats=2))
        if counts["stream_sum"] < 1:
            raise AssertionError("the floor never launched stream_sum")
        lib = self.p.cuda_event_ms(lambda: torch.sum(mat, dtype=torch.float32))
        n, d = mat.shape
        log(floor=stage, shape=f"{n} x {d} {str(mat.dtype)[6:]}",
            stream_ms=out["stream_ms"],
            stream_ms_runs=[out["stream_ms_runs"]["min"],
                            out["stream_ms_runs"]["max"]],
            gb_s=out["stream_gb_s"], retrieve_ms=self.retrieve_ms[stage],
            pct_of_floor=out["stream_ms"] / self.retrieve_ms[stage],
            library_sum_ms=lib, library="torch.sum(x, dtype=torch.float32)",
            stream_sum_launches=counts["stream_sum"], card=self.card)

    def phase12_overlap(self, emb) -> None:
        """The overlap probe on stage A's matrix: ms against X."""
        grid = self.p.sm_grid(self.dev)
        lines, counts = self.main_path(lambda: self.p.dma_overlap.run(
            emb, self.timer.device_ms, grid, xs=self.OVERLAP_X, n_loop=10))
        if counts["stream_sum_busy"] < 1:
            raise AssertionError("the probe never launched stream_sum_busy")
        n, d = emb.shape
        log(probe="dma_overlap", shape=f"{n} x {d} bf16, tiles of "
            f"{lines[0]['tile_rows']} rows, grid {grid}",
            x_iters=[r["x_iters"] for r in lines],
            ms=[r["ms"] for r in lines],
            added_ms=[r["added_ms"] for r in lines],
            ns_per_step_per_cta=[r["ns_per_step_per_cta"] for r in lines],
            stream_gb_s=[r["stream_gb_s"] for r in lines],
            chains_bit_equal=True, card=self.card)

    def time_stream(self, emb) -> None:
        """stream_sum and stream_sum_busy (X = 8) at stage A's matrix:
        kernel, plain version, yardstick, bound."""
        k = self.p.kernels
        n, d = emb.shape
        self.time_pair("stream_sum", lambda: k.stream_sum(emb),
                       lambda: k.stream_sum_torch(emb),
                       f"{n} x {d} bf16 (stage A's matrix)")
        self.time_library("stream_sum",
                          lambda: torch.sum(emb, dtype=torch.float32),
                          "torch.sum(x, dtype=torch.float32)")
        self.bound("stream_sum", n * d * 2 + 4, n * d, F32_FLOP_S)
        grid, xi, tile_rows = self.p.sm_grid(self.dev), 8, 16
        seed = torch.zeros((), device=self.dev)
        self.time_pair(
            "stream_sum_busy",
            lambda: k.stream_sum_busy(emb, seed, xi, grid, tile_rows),
            lambda: k.stream_sum_busy_torch(emb, seed, xi, grid, tile_rows),
            f"{n} x {d} bf16, X={xi}, tiles of {tile_rows} rows, "
            f"grid {grid}")
        self.no_library("stream_sum_busy",
                        "no PyTorch call computes the per-CTA chains")
        tiles = -(-n // tile_rows)
        # Each tile: n*d/tiles adds; every thread of its CTA: X chain steps
        # of a multiply and an add.
        self.bound("stream_sum_busy", n * d * 2 + 4 + grid * 4,
                   n * d + 2 * xi * tiles * 256, F32_FLOP_S)

    # -- the probes of K1/K2, the keys and int4 (P4-P7, T1) --------------

    def probe_ms(self, fn, n):
        return self.p.cuda_event_ms(fn, n=n, warmup=1)

    def exact_rows(self, n, d):
        """Integer-valued rows and queries: every f32 score is an exact
        integer, so the kernels' sums and the plain versions' agree bit
        for bit, and exact ties are everywhere. Also int8 rows with
        scales (float(acc) * scale is one rounding in both)."""
        g = self.seed(131)
        dev = self.dev
        emb = torch.randint(-2, 3, (n, d), generator=g,
                            device=dev).to(torch.bfloat16)
        q = torch.randint(-2, 3, (self.B, d), generator=g, device=dev).float()
        i8 = dict(generator=g, device=dev, dtype=torch.int8)
        int8 = (torch.randint(-127, 128, (n, d), **i8),
                torch.rand(n, generator=g, device=dev) + 0.5,
                torch.randint(-127, 128, (self.B, d), **i8),
                torch.rand(self.B, generator=g, device=dev) + 0.5)
        return emb, q, int8

    def counted_check(self, name, counted, plain, kernel, tau_fn) -> None:
        """The counted fold equal to its plain version (values, ids and
        every counter) and to the kernel it counts, with and without
        tau."""
        ref = kernel()
        for tau in (None, tau_fn()):
            got, want = counted(tau), plain(tau)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"(tau={tau is not None})")
            if not (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                raise AssertionError(f"{name} differs from the kernel it "
                                     f"counts (tau={tau is not None})")

    def phase13_14_probe_checks(self) -> None:
        """P4's modes and P5's counted fold against their plain versions
        at N_KERNEL, on exact rows."""
        t0 = time.perf_counter()
        k, a = self.p.kernels, self.p.anatomy
        emb, q, (values, scales, qv, qs) = self.exact_rows(self.N_KERNEL,
                                                           self.D_KERNEL)
        self.max_err["anatomy_top_k"] = self.p.kernel_anatomy.check(emb, q, 32)
        self.max_err["anatomy_top_k_int8"] = self.p.kernel_anatomy.check(
            values, qv, 25, scales, qs)
        self.counted_check(
            "fused_top_k_counted",
            lambda t: k.fused_top_k_counted(emb, q, 32, t),
            lambda t: k.fused_top_k_counted_torch(emb, q, 32, t),
            lambda: k.fused_dense_top_k(emb, q, 32),
            lambda: a.subsample_tau(emb, q, 32))
        args = (values, scales, qv, qs, 25)
        self.counted_check(
            "fused_top_k_counted_int8",
            lambda t: k.fused_top_k_counted_int8(*args, t),
            lambda t: k.fused_top_k_counted_int8_torch(*args, t),
            lambda: k.fused_dense_top_k_int8(*args),
            lambda: a.subsample_tau_int8(values, scales, qv, 25))
        log(phase="probes_vs_plain", n=self.N_KERNEL, d=self.D_KERNEL,
            b=self.B, anatomy_modes=["stage", "score", "compare", "full"],
            anatomy_score_max_abs_err=self.max_err["anatomy_top_k"],
            counted_equal_plain_and_kernel=True, tau=[False, True], ok=True,
            seconds=time.perf_counter() - t0)

    def phase13_anatomy(self, label, rows, q, kk, scales=None,
                        q_scales=None) -> None:
        """Every mode held against its plain version on a stage's matrix,
        the ablation's times there, and the anatomy row's timing (its
        "score" mode) beside its plain version and yardstick. The probe's
        K1/K2 calls (its "full" mode) are reported in the anatomy line,
        not in the kernels line."""
        t0 = time.perf_counter()
        int8 = scales is not None
        name = "anatomy_top_k_int8" if int8 else "anatomy_top_k"
        full = "fused_dense_top_k_int8" if int8 else "fused_dense_top_k"
        err = self.p.kernel_anatomy.check(rows, q, kk, scales, q_scales)
        self.max_err[name] = max(self.max_err[name], err)
        line, counts = self.main_path(lambda: self.p.kernel_anatomy.run(
            rows, q, kk, self.probe_ms, scales, q_scales), probed=(full,))
        self.expect(f"anatomy {label}", counts, **{name: 3 * counts[full]})
        (n, d), b = rows.shape, q.shape[0]
        shape = (f"{n} x {d} {line['rows']}, B={b}, k={kk}, "
                 f"{line['splits']} splits")
        log(anatomy=label, shape=shape, **{key: line[key] for key in (
            "ms", "loads_ms", "scoring_ms", "compare_ms", "insert_merge_ms",
            "tau_pass_ms", "stage_gb_s", "byte_floor_ms")}, modes_equal_plain=True,
            score_max_abs_err=err, full_mode_launches=counts[full],
            card=self.card, seconds=time.perf_counter() - t0)
        k = self.p.kernels
        if int8:
            args = (rows, scales, q, q_scales, kk, "score")
            self.time_pair(name, lambda: k.anatomy_top_k_int8(*args),
                           lambda: k.anatomy_top_k_int8_torch(*args),
                           shape + ", mode score", plain_n=2)
            self.time_library(name, lambda: self.int8_row_max(rows, q,
                                                              scales),
                              "torch._int_mm, row scales, amax per 2^21-row "
                              "chunk, then the max over chunks")
            self.bound(name, n * d + n * 4 + b * d + b * 4, 2 * b * n * d,
                       INT8_OP_S)
        else:
            args = (rows, q, kk, "score")
            self.time_pair(name, lambda: k.anatomy_top_k(*args),
                           lambda: k.anatomy_top_k_torch(*args),
                           shape + ", mode score")
            self.time_library(name, lambda: torch.amax(
                q.float() @ rows.float().T, dim=1),
                "torch.amax(q @ emb.float().T, dim=1)")
            self.bound(name, n * d * 2 + b * d * 4 + b * 4,
                       QUERY_PIECES * 2 * b * n * d, BF16_FLOP_S)

    @staticmethod
    def int8_row_max(values, qv, scales=None, step=1 << 21):
        """Each row's best int8 product (times the row scales, if given):
        torch._int_mm per chunk of the doc axis, whose [256, N] int32
        product would take 10.7 GB at once."""
        best = None
        for s0 in range(0, values.shape[0], step):
            acc = torch._int_mm(qv, values[s0:s0 + step].T)
            m = (acc if scales is None else
                 acc.float() * scales[s0:s0 + step][None]).amax(dim=1)
            best = m if best is None else torch.maximum(best, m)
        return best

    def phase14_counted(self, label, rows, q, kk, scales=None,
                        q_scales=None) -> None:
        """The counted fold on a stage's matrix with and without tau, its
        values, ids and every counter equal to its plain version's and its
        ids to K1's / K2's (inside the probe), and its timing row. The
        probe's K1/K2 call (the reference) is reported in the counted
        line, not in the kernels line; tau comes from K1/K2's own tau
        pass (subsample_tau)."""
        t0 = time.perf_counter()
        int8 = scales is not None
        name = "fused_top_k_counted_int8" if int8 else "fused_top_k_counted"
        full = "fused_dense_top_k_int8" if int8 else "fused_dense_top_k"
        lines, counts = self.main_path(lambda: self.p.iteration_count.run(
            rows, q, kk, self.probe_ms, scales, q_scales), probed=(full,))
        self.expect(f"counted {label}", counts, at_least=True, **{name: 2})
        (n, d), b = rows.shape, q.shape[0]
        shape = (f"{n} x {d} {'int8' if int8 else str(rows.dtype)[6:]}, "
                 f"B={b}, k={kk}, {lines[0]['splits']} splits")
        keys = ("insertions_per_row", "insertions_early_per_row",
                "insertions_late_per_row", "insertions_per_row_split",
                "fired_windows_per_row", "windows_per_row", "fired_share",
                "counters_off_plain", "ms")
        # One list per key: without tau, then with it.
        log(counted=label, shape=shape, ids_equal_kernel=True,
            equal_plain=True, tau=[False, True],
            reference_launches=counts[full],
            **{key: [line[key] for line in lines] for key in keys},
            card=self.card, seconds=time.perf_counter() - t0)
        shape += ", no tau"
        k = self.p.kernels
        if int8:
            args = (rows, scales, q, q_scales, kk)
            self.time_pair(name, lambda: k.fused_top_k_counted_int8(*args),
                           lambda: k.fused_top_k_counted_int8_torch(*args),
                           shape, plain_n=1)
            self.bound(name, n * d + n * 4 + b * (d + 4)
                       + b * lines[0]["splits"] * 16 + b * kk * 8,
                       2 * b * n * d, INT8_OP_S)
        else:
            self.time_pair(name, lambda: k.fused_top_k_counted(rows, q, kk),
                           lambda: k.fused_top_k_counted_torch(rows, q, kk),
                           shape, plain_n=1)
            self.bound(name, n * d * rows.element_size() + b * d * 4
                       + b * lines[0]["splits"] * 16 + b * kk * 8,
                       QUERY_PIECES * 2 * b * n * d, BF16_FLOP_S)
        self.no_library(name, "no PyTorch call counts a top-k's insertions")

    def phase15_keys(self) -> None:
        """T1 bit for bit over the JAX package's special values and 2^24
        normals; P6 through its probe."""
        t0 = time.perf_counter()
        k = self.p.kernels
        inf = float("inf")
        special = torch.tensor(
            [-inf, -3.3e38, -1.0, -2e-38, -1e-45, -0.0, 0.0, 1e-45, 2e-38,
             0.5, 1.0, 3.3e38, inf], dtype=torch.float32, device=self.dev)
        g = self.seed(151)
        x = torch.cat([special, 10 * torch.randn(
            self.KEY_NORMALS, generator=g, device=self.dev)])

        def keys_and_back():
            keys = k.xpack_keys(x)
            return keys, k.xpack_values(keys)

        (keys, back), counts = self.main_path(keys_and_back)
        self.expect("keys", counts, xpack_keys=1, xpack_values=1)
        if not (torch.equal(keys, k.xpack_keys_torch(x))
                and torch.equal(back.view(torch.int32), x.view(torch.int32))
                and torch.equal(k.xpack_values_torch(keys).view(torch.int32),
                                x.view(torch.int32))):
            raise AssertionError("the key map is not bit-exact")
        ordered = x[torch.argsort(keys)]
        if not bool((ordered[1:] >= ordered[:-1]).all()):
            raise AssertionError("the keys do not order as the floats")
        for name in ("xpack_keys", "xpack_values"):
            self.max_err[name] = 0.0
        lines, c6 = self.main_path(lambda: self.p.bf16_fold.run(
            self.dev, self.probe_ms, self.BF16_SHAPES))
        self.expect("bf16 fold", c6, at_least=True,
                    bf16_row_reduce=len(lines))
        self.max_err["bf16_row_reduce"] = 0.0
        t1 = time.perf_counter()
        edges = self.p.bf16_fold.check_edges(
            self.dev, *(() if self.BF16_EDGE_SHAPES is None
                        else (self.BF16_EDGE_SHAPES,)))
        log(probe="bf16_row_reduce_edges", **edges, card=self.card,
            seconds=time.perf_counter() - t1)
        log(probe="keys", elements=x.numel(), special_values=13,
            bit_equal_plain=True, round_trip_bit_equal=True, monotone=True,
            bf16_fold=[{key: line[key] for key in (
                "shape", "ms", "plain_ms", "packed_argmax_agreement",
                "packed_value_agreement")} for line in lines],
            card=self.card, seconds=time.perf_counter() - t0)
        n = x.numel()
        self.time_pair("xpack_keys", lambda: k.xpack_keys(x),
                       lambda: k.xpack_keys_torch(x),
                       f"{n} float32 (13 special + normals)")
        self.time_pair("xpack_values", lambda: k.xpack_values(keys),
                       lambda: k.xpack_values_torch(keys),
                       f"{n} int32 keys")
        for name in ("xpack_keys", "xpack_values"):
            self.no_library(name, "no PyTorch call maps floats to "
                            "order-preserving int32 keys")
            self.bound(name, 8 * n, n, F32_FLOP_S)
        self.time_row_reduce(g)
        r, w = self.BF16_SHAPES[-1]
        xr = torch.randn((r, w), generator=g, device=self.dev)
        self.time_pair("bf16_row_reduce", lambda: k.bf16_row_reduce(xr),
                       lambda: k.bf16_row_reduce_torch(xr),
                       f"[{r}, {w}] float32")
        self.no_library("bf16_row_reduce", "torch.max gives the max and an "
                        "argmax only, not the masked max or the packed key")
        self.bound("bf16_row_reduce", r * w * 4 + r * 16, 6 * r * w,
                   F32_FLOP_S)

    def time_row_reduce(self, g) -> None:
        """P6 at both probe shapes, warm (one input, which stays in the 50
        MB L2) and cold (copies filling twice the L2, taken in turn): the
        event pair around one call (median of 10; the wrapper's host work
        falls inside it), 50 calls back to back between one pair of events
        (the device loop; host-bound where the wrapper outlasts the
        kernel), the kernel alone (torch.profiler, mean of 50 launches)
        and the wrapper's host time, beside the HBM bound."""
        k, p = self.p.kernels, self.p
        shapes = []
        for r, w in self.BF16_SHAPES:
            xs = p.bf16_fold.cold_inputs(r, w, g, self.dev)
            turn = itertools.cycle(xs)

            def warm(x=xs[0]):
                return k.bf16_row_reduce(x)

            def cold():
                return k.bf16_row_reduce(next(turn))

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                warm()
            host_ms = (time.perf_counter() - t0) / 50 * 1e3
            shapes.append({
                "shape": [r, w], "cold_copies": len(xs),
                "plan": {"threads_per_row": p.row_plan(w)},
                "event_ms": p.cuda_event_ms(warm),
                "event_cold_ms": p.cuda_event_ms(cold),
                "device_ms": p.device_loop_ms(warm, n_loop=50, trials=3),
                "kernel_ms": p.profiled_kernel_ms(warm, "row_reduce", n=50),
                "kernel_cold_ms": p.profiled_kernel_ms(cold, "row_reduce",
                                                       n=50),
                "host_ms": host_ms,
                "plain_event_ms": p.cuda_event_ms(
                    lambda: k.bf16_row_reduce_torch(xs[0])),
                "bound_ms": (r * w * 4 + r * 16) / HBM_BYTES_S * 1e3,
            })
            del xs, turn
        log(timing="bf16_row_reduce_shapes", shapes=shapes,
            predicted_event_ms=list(self.P6_PREDICTED_MS), card=self.card,
            method="event_ms: CUDA events around one call, median of 10 "
            "after 3 warm-ups; device_ms: 50 calls between one pair of "
            "events, best of 3; kernel_ms: torch.profiler device time per "
            "launch over 50 calls; host_ms: host clock over 50 calls "
            "without a synchronize")

    def phase16_int4_exact(self) -> None:
        """P7 stages 1 and 3: exact at the probe's small shape."""
        t0 = time.perf_counter()
        probe = self.p.int4_probe
        line, counts = self.main_path(lambda: probe.check_exact(self.dev))
        self.expect("int4 exact", counts, at_least=True, int4_scores=2,
                    int4_fold_max=2, int8_fold_max=1)
        for name in ("int4_scores", "int4_fold_max", "int8_fold_max"):
            self.max_err[name] = 0.0
        q8, e4, packed = probe.small_case(self.dev)
        k = self.p.kernels
        (n, d), b = e4.shape, q8.shape[0]
        self.time_pair("int4_scores", lambda: k.int4_scores(q8, packed),
                       lambda: k.int4_scores_torch(q8, packed),
                       f"{n} x {d} int4 ({n} x {d // 2} packed), B={b}")
        self.no_library("int4_scores", "no PyTorch call multiplies packed "
                        "int4 rows")
        self.bound("int4_scores", b * d + n * d // 2 + b * n * 4,
                   2 * b * n * d, INT8_OP_S)
        log(probe="int4_exact", **line, card=self.card,
            seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        edges = probe.check_edges(self.dev, self.FOLD_EDGE_N,
                                  self.FOLD_EDGE_D, self.FOLD_EDGE_B)
        log(probe="int4_edges", **edges, card=self.card,
            seconds=time.perf_counter() - t0)

    def phase16_int4_stage2(self, values) -> None:
        """P7 stage 2: the int8 fold over stage C's resident matrix, the
        int4 fold over a seeded packed matrix of as many rows."""
        t0 = time.perf_counter()
        probe, k = self.p.int4_probe, self.p.kernels
        n, d = values.shape
        q8, packed = probe.stage2_inputs(self.dev, self.INT4_N, d, self.B)
        checks = [("int8_fold_max", k.int8_fold_max(q8, values),
                   k.int8_fold_max_torch(q8, values))]
        for unpack in ("mask", "shift"):
            checks.append((f"int4_fold_max ({unpack})",
                           k.int4_fold_max(q8, packed, unpack),
                           k.int4_fold_max_torch(q8, packed, unpack)))
        for what, got, want in checks:
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{what} is not exact at full size")
        del checks
        for unpack in ("mask", "shift"):
            # [256, N] int32 at once; the plain version a slice at a time.
            got = k.int4_scores(q8, packed, unpack)
            step = 1 << 21
            for s0 in range(0, packed.shape[0], step):
                if not torch.equal(got[:, s0:s0 + step], k.int4_scores_torch(
                        q8, packed[s0:s0 + step], unpack)):
                    raise AssertionError(f"int4_scores ({unpack}) is not "
                                         f"exact at full size")
            del got
        lines, counts = self.main_path(lambda: probe.run_stage2(
            q8, values, packed, self.probe_ms))
        self.expect("int4 stage 2", counts, at_least=True, int8_fold_max=1,
                    int4_fold_max=1)
        anatomy, _ = self.main_path(lambda: probe.run_anatomy(
            q8, values, packed, self.probe_ms))
        log(probe="int4_anatomy", lines=anatomy, card=self.card)
        log(probe="int4_stage2", lines=lines, exact_full_size=True,
            exact_full_size_kernels=["int8_fold_max", "int4_fold_max mask",
                                     "int4_fold_max shift",
                                     "int4_scores mask", "int4_scores shift"],
            card=self.card, seconds=time.perf_counter() - t0)
        b = q8.shape[0]
        np_ = packed.shape[0]
        self.time_pair("int8_fold_max", lambda: k.int8_fold_max(q8, values),
                       lambda: k.int8_fold_max_torch(q8, values),
                       f"{n} x {d} int8, B={b}", plain_n=2)
        self.time_library("int8_fold_max",
                          lambda: self.int8_row_max(values, q8),
                          "torch._int_mm and amax per 2^21-row chunk, then "
                          "the max over chunks")
        self.bound("int8_fold_max", n * d + b * d + b * 4, 2 * b * n * d,
                   INT8_OP_S)
        self.time_pair("int4_fold_max", lambda: k.int4_fold_max(q8, packed),
                       lambda: k.int4_fold_max_torch(q8, packed),
                       f"{np_} x {d} int4 ({np_} x {d // 2} packed), B={b}",
                       plain_n=2)
        self.no_library("int4_fold_max", "no PyTorch call multiplies packed "
                        "int4 rows")
        self.bound("int4_fold_max", np_ * d // 2 + b * d + b * 4,
                   2 * b * np_ * d, INT8_OP_S)

    def kernels_line(self) -> None:
        rows = []
        for name, (source, replaces) in KERNELS.items():
            ms, plain_ms = self.times[name]
            bound_ms, bound_by = self.bounds[name]
            rows.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": self.main_launches[name],
                "max_abs_err": self.max_err[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": self.library[name],
            })
        for row in rows:
            if row["launches"] < 1:
                raise AssertionError(f"{row['name']} never ran on the main path")
        print(json.dumps({"kernels": rows}), flush=True)

    def run(self) -> None:
        self.phase0_build()
        self.phase1_k1()
        self.phase2_k2()
        self.phase3_ivf_kernels()
        self.phase9_stream_kernels()
        self.phase13_14_probe_checks()
        self.phase15_keys()
        self.phase16_int4_exact()
        torch.cuda.empty_cache()
        self.phase10_stage_f()
        torch.cuda.empty_cache()
        emb, gold, q, bm25, terms = self.phase4_stage_a()
        self.phase5_stage_b(emb, q, bm25, terms)
        self.phase17_search_engine(emb, gold, q, bm25, terms)
        self.time_k1(emb, q)
        self.phase11_floor("A", emb)
        self.phase12_overlap(emb)
        self.time_stream(emb)
        self.phase13_anatomy("A", emb, q, 32)
        self.phase14_counted("A", emb, q, 32)
        del emb, gold, q, bm25, terms
        torch.cuda.empty_cache()
        self.phase6_stage_d()
        torch.cuda.empty_cache()
        index, q, cent = self.phase7_stage_c()
        qd = index.dense_q[MODEL]
        self.phase11_floor("C", qd.values)
        torch.cuda.empty_cache()
        self.phase8_stage_e(index, cent)
        self.time_k2(qd.values, qd.scales, q)
        qv, qs = self.p.quantize_queries(q)
        self.phase13_anatomy("C", qd.values, qv, 25, qd.scales, qs)
        self.phase14_counted("C", qd.values, qv, 25, qd.scales, qs)
        self.phase16_int4_stage2(qd.values)
        log(phase="done", seconds=time.perf_counter() - self.t0)
        self.kernels_line()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)


class _Port:
    """The port's entry points, imported only after the checks above."""

    def __init__(self):
        from a_nice_rag_tpu_torch import bench, require_cuda
        from a_nice_rag_tpu_torch.index.array_index import (
            ArrayIndex,
            CorpusMeta,
        )
        from a_nice_rag_tpu_torch.index.ivf import (
            IVFDense,
            attach_ivf,
            build_tile_table,
            default_max_tiles,
        )
        from a_nice_rag_tpu_torch.ops import kernels
        from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays
        from a_nice_rag_tpu_torch.ops.kernels._build import build_log
        from a_nice_rag_tpu_torch.ops.kernels.keys import row_plan
        from a_nice_rag_tpu_torch.ops.kernels.stream import sm_grid
        from a_nice_rag_tpu_torch.ops.kernels import anatomy, topk_plan
        from a_nice_rag_tpu_torch.ops.kernels import int4 as int4_kernels
        from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
            _sm_count,
            float_smem_bytes,
            int8_smem_bytes,
        )
        from a_nice_rag_tpu_torch.probes import (
            bf16_fold,
            dma_overlap,
            int4,
            iteration_count,
            kernel_anatomy,
        )
        from a_nice_rag_tpu_torch.ops.quantized import (
            QuantizedDense,
            quantize_embeddings,
            quantize_queries,
        )
        from a_nice_rag_tpu_torch.retrieval import (
            FusedRetriever,
            SearchEngine,
        )
        from a_nice_rag_tpu_torch.retrieval.engine import _ivf_coverage
        from a_nice_rag_tpu_torch.testing import (
            chained_ms,
            cuda_event_ms,
            device_loop_ms,
            profiled_kernel_ms,
        )
        from a_nice_rag_tpu_torch.testing.parity import (
            check_stream_sum,
            check_stream_sum_busy,
            check_top_k,
        )

        self.require_cuda = require_cuda
        self.bench, self.dma_overlap = bench, dma_overlap
        self.anatomy, self.kernel_anatomy = anatomy, kernel_anatomy
        self.iteration_count, self.bf16_fold = iteration_count, bf16_fold
        self.int4_probe = int4
        self.int4_kernels = int4_kernels
        self.fold_smem_bytes = int4_kernels.source_smem_bytes
        self.fold_active_clusters = int4_kernels.active_clusters
        self.topk_plan, self.int8_smem_bytes = topk_plan, int8_smem_bytes
        self.float_smem_bytes, self.sm_count = float_smem_bytes, _sm_count
        self.row_plan = row_plan
        self.sm_grid = sm_grid
        self.check_stream_sum = check_stream_sum
        self.check_stream_sum_busy = check_stream_sum_busy
        self.device_loop_ms, self.chained_ms = device_loop_ms, chained_ms
        self.profiled_kernel_ms = profiled_kernel_ms
        self.ArrayIndex, self.CorpusMeta = ArrayIndex, CorpusMeta
        self.IVFDense, self.attach_ivf = IVFDense, attach_ivf
        self.build_tile_table = build_tile_table
        self.default_max_tiles = default_max_tiles
        self.kernels = kernels
        self.Bm25Arrays = Bm25Arrays
        self.build_log = build_log
        self.QuantizedDense = QuantizedDense
        self.quantize_embeddings = quantize_embeddings
        self.quantize_queries = quantize_queries
        self.FusedRetriever = FusedRetriever
        self.SearchEngine = SearchEngine
        self.ivf_coverage = _ivf_coverage
        self.cuda_event_ms = cuda_event_ms
        self.check_top_k = check_top_k


def main() -> int:
    if not (REPO / "a_nice_rag_tpu_torch" / "csrc" / "fused_topk.cu").is_file():
        print("chip_smoke.py must run from a checkout of the repository "
              "(a_nice_rag_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA GPU visible: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    Smoke(_Port()).run()
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
