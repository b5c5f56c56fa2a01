#!/usr/bin/env python3
"""Smoke run of the PyTorch port (a_nice_rag_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc (one nvcc per source,
started together), holds each against its plain PyTorch version, then
drives the port's main path, ``FusedRetriever.retrieve_device``, at the
corpus sizes the repository was built for at scale:

  0. device check, card name and power limit, kernel build;
  1. K1 (fused_dense_top_k) against its plain version: f32 and bf16 rows,
     with and without a mask, N = 2^20 + 37, k in {1, 32, 128},
     B in {1, 7, 256}, duplicated rows (exact ties across doc splits),
     and k larger than the count of valid docs;
  2. K2 (fused_dense_top_k_int8) against its plain version, same cases;
  3. K3/K4 (ivf_dense_top_k, ivf_dense_top_k_int8) against their plain
     versions on the same matrix in f32, bf16 and int8: tile_n 1024 and
     2048, a ragged last tile, static and dynamic (trailing-slot) row
     counts, -1 padded tables, k in {1, 16, 128, 256}, B in {1, 8, 256};
  4. stage A: 2^21 x 256 bf16 dense + CSR BM25 hybrid (bench.py's 2M
     configuration), planted recall and id equality with the torch route;
  5. stage B: the same index with a filter mask over half the docs and
     two-tier BM25 (128 common terms, so K1 runs masked twice per call);
  6. stage D: 2^21 x 256 bf16 with a k-means IVF (bench.py's 2M IVF
     configuration): micro-batches of B = 8 through K3, B = 256 and a
     filtered call through K1, a full probe against the exact route, and
     the IVF/exact crossover record for B in {8, 16, 32, 64};
  7. stage C: 10.5M x 1024 int8 dense-only (bench.py's int8 configuration);
  8. stage E: stage C's matrix with a cluster-major IVF: micro-batches of
     B = 8 through K4, B = 256 through K2.

Stages A-C also print the retrieve_device time of one call (CUDA
events, median of 10). Each kernel, its plain version and a one-call
PyTorch yardstick
(library_ms) are timed with CUDA events at the main path's shapes, and
each kernel's bound (the larger of its bytes over the HBM rate and its
operations over the peak rate of their type) is computed from the run's
inputs. Prints one JSON object per phase or timing line, the kernels
line, and, as the last line, {"ok": true, "device": {...}}. Any failed
check raises, so the exit code is nonzero and no result line is printed.
All data is made on the device from seeded torch.Generator streams.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
MODEL = "voyage-3-large"
K1_SOURCE = "a_nice_rag_tpu_torch/csrc/fused_topk.cu"
K3_SOURCE = "a_nice_rag_tpu_torch/csrc/ivf_topk.cu"
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fused_dense_top_k": (K1_SOURCE,
                          "a_nice_rag_tpu/ops/pallas/fused_topk.py:1440"),
    "fused_dense_top_k_int8": (K1_SOURCE,
                               "a_nice_rag_tpu/ops/pallas/fused_topk.py:1218"),
    "ivf_dense_top_k": (K3_SOURCE,
                        "a_nice_rag_tpu/ops/pallas/ivf_topk.py:143"),
    "ivf_dense_top_k_int8": (K3_SOURCE,
                             "a_nice_rag_tpu/ops/pallas/ivf_topk.py:174"),
}
F32_ATOL = 1e-5
BF16_ATOL = 1e-4
BM25_ATOL = 1e-4
FULL_PROBE_ATOL = 1e-4
# One H100 SXM (NVIDIA data sheet, dense rates): HBM bytes/s, FFMA f32
# FLOP/s (the kernels' f32 contract is IEEE, off the tensor cores), int8
# tensor-core OP/s.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
INT8_OP_S = 1979e12


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Smoke:
    # Sizes of the phases (bench.py's configurations for stages A-E).
    N_KERNEL, D_KERNEL = (1 << 20) + 37, 256
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

    def __init__(self, port):
        self.p = port
        self.dev = port.require_cuda()
        self.card = card_line()
        self.gen = torch.Generator(device=self.dev)
        self.max_err = {name: 0.0 for name in KERNELS}
        self.swaps = {name: 0 for name in KERNELS}
        self.main_launches = {name: 0 for name in KERNELS}
        self.times = {}
        self.library = {}
        self.bounds = {}

    # -- helpers ----------------------------------------------------------

    def seed(self, s: int) -> torch.Generator:
        return self.gen.manual_seed(s)

    def unit(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + 1e-12)

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

    def main_path(self, fn):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after: the counts of the port's main path alone."""
        k = self.p.kernels
        torch.cuda.synchronize()
        k.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {name: getattr(k, name).launches for name in KERNELS}
        for name, n in got.items():
            self.main_launches[name] += n
        return out, got

    @staticmethod
    def expect(stage, counts, **want) -> None:
        for name, n in want.items():
            if counts[name] != n:
                raise AssertionError(f"{stage}: launches {counts}, expected "
                                     f"{name} = {n}")

    def bound(self, name, n_bytes, ops, op_rate) -> None:
        """The least time the card could take: bytes over the HBM rate or
        operations over their peak rate, whichever is larger."""
        t_bytes = n_bytes / HBM_BYTES_S * 1e3
        t_ops = ops / op_rate * 1e3
        self.bounds[name] = (max(t_bytes, t_ops),
                             "bytes" if t_bytes >= t_ops else "operations")

    def recall10(self, ids, gold) -> float:
        return float((ids[:, :10] == gold[:, None]).any(dim=1).float().mean())

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
            for line in report.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}:", line.strip(), flush=True)
        log(phase="build", seconds=round(seconds, 3),
            sources=list(self.p.kernels.SOURCES),
            torch=torch.__version__, cuda=torch.version.cuda)

    def kernel_cases(self, n, d, dtype):
        g = self.seed(101)
        emb = self.unit(torch.randn((n, d), generator=g, device=self.dev))
        # Exact ties across doc splits: the first rows again further on.
        for start in (n // 3, n // 2, n - 300):
            emb[start:start + 256] = emb[:256]
        q = self.unit(torch.randn((self.B, d), generator=g, device=self.dev))
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
        log(phase="k2_vs_plain", cases=len(cases), ok=True,
            max_abs_err=self.max_err["fused_dense_top_k_int8"])

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
        log(phase="k3_k4_vs_plain", cases=count, ok=True,
            max_abs_err_k3=self.max_err["ivf_dense_top_k"],
            tie_swaps_k3=self.swaps["ivf_dense_top_k"],
            max_abs_err_k4=self.max_err["ivf_dense_top_k_int8"])

    def planted_bm25(self, g, n, gold, v):
        """CSR postings of v terms x DF docs; term j * T + t of query j
        (t < T) holds that query's gold doc, so BM25 finds it."""
        p = self.p
        b, t, df = gold.shape[0], self.T, self.DF
        doc_mat = torch.randint(0, n, (v, df), generator=g, device=self.dev,
                                dtype=torch.int32)
        doc_mat[: b * t, 0] = gold.to(torch.int32).repeat_interleave(t)
        doc_mat = doc_mat.sort(dim=1).values
        impact = torch.rand((v, df), generator=g, device=self.dev) + 0.5
        bm25 = p.Bm25Arrays(
            indptr=torch.arange(v + 1, device=self.dev, dtype=torch.int32) * df,
            doc_ids=torch.cat([doc_mat.reshape(-1),
                               torch.tensor([n], device=self.dev,
                                            dtype=torch.int32)]),
            impact=torch.cat([impact.reshape(-1),
                              torch.zeros(1, device=self.dev)]),
            n_docs_padded=n,
        )
        terms = torch.arange(b * t, device=self.dev,
                             dtype=torch.int32).reshape(b, t)
        return bm25, terms

    def stage_a_index(self):
        """bench.py's 2M configuration, built on the device."""
        n, d, b = self.N_A, self.D_A, self.B
        g = self.seed(11)
        emb = self.unit(torch.randn((n, d), generator=g, device=self.dev))
        emb = emb.to(torch.bfloat16)
        gold = torch.randint(0, n, (b,), generator=g, device=self.dev)
        q = emb[gold].float()
        # cos(q, gold) ~ 1/sqrt(1 + 0.1^2 * 256) ~ 0.53: planted, not trivial.
        q = self.unit(q + 0.10 * torch.randn(q.shape, generator=g,
                                             device=self.dev))
        bm25, terms = self.planted_bm25(g, n, gold, self.V)
        return emb, gold, q, bm25, terms

    def make_index(self, emb, bm25, n, sources=()):
        p = self.p
        meta = p.CorpusMeta(ids=[], sources=list(sources), contents=[],
                            urls=[], n_docs=n, n_docs_padded=n)
        return p.ArrayIndex(
            meta=meta, dense={MODEL: emb}, bm25=bm25, vocab=None,
            bm25_stats={"max_df": self.DF}, bm25_doc_mask=np.ones(n, dtype=bool),
        )

    def exact_dense(self, emb, q, ids):
        rows = emb[ids.clamp(min=0).long()].double()  # [B, k, D]
        s = torch.einsum("bkd,bd->bk", rows, q.double())
        return torch.where(ids >= 0, s, float("-inf"))

    def exact_bm25(self, bm25, terms, ids):
        df = self.DF
        starts = bm25.indptr[terms.clamp(min=0).long()].long()  # [B, T]
        pos = starts[:, :, None] + torch.arange(df, device=self.dev)
        live = (terms >= 0)[:, :, None].expand_as(pos)
        docs = bm25.doc_ids[pos].reshape(terms.shape[0], -1)
        imp = torch.where(live, bm25.impact[pos], 0.0).reshape(docs.shape)
        hit = docs[:, None, :] == ids[:, :, None]
        s = (hit.double() * imp[:, None, :].double()).sum(dim=-1)
        return torch.where(ids >= 0, s, float("-inf"))

    def compare_routes(self, got, ref, exact_fns, atols) -> int:
        """Per-list ids of the kernel route against the torch route, up to
        swaps between exact scores within the tolerance; then the fused
        ids, exactly when no list swapped."""
        (fids, fvals, lists), (rfids, rfvals, rlists) = got, ref
        swaps = 0
        for li, (fn, atol) in enumerate(zip(exact_fns, atols)):
            swaps += self.p.check_top_k(fn(rlists[li]), rlists[li],
                                        fn(lists[li]), lists[li], atol)
        equal = torch.equal(fids, rfids)
        if swaps == 0 and not equal:
            raise AssertionError("fused ids differ from the torch route")
        self.p.check_top_k(rfvals, rfids, fvals, fids, 1e-6)
        return {"list_swaps": swaps, "fused_ids_equal_torch_route": equal}

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
        r_h, r_d, r_b = (self.recall10(r[0], gold) for r in runs)
        assert r_h >= 0.99, f"2M hybrid recall@10 {r_h} below 0.99"
        assert r_d >= 0.95 and r_b >= 0.95, (r_d, r_b)

        ref_retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                    dense_backend="torch", **kw)
        assert not ref_retr.use_kernel
        ref = ref_retr.retrieve_device(qd, terms, w_h, None, 40.0)
        routes = self.compare_routes(
            runs[0], ref,
            [lambda ids: self.exact_dense(emb, q, ids),
             lambda ids: self.exact_bm25(bm25, terms, ids)],
            [F32_ATOL, BM25_ATOL],
        )
        log(stage="A_2M_hybrid", recall10_hybrid=r_h, recall10_dense=r_d,
            recall10_bm25=r_b, k1_launches=counts["fused_dense_top_k"],
            retrieve_ms=p.cuda_event_ms(
                lambda: retr.retrieve_device(qd, terms, w_h, None, 40.0)),
            **routes)
        del ref, ref_retr, runs
        return emb, q, bm25, terms

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
        routes = self.compare_routes(
            out, ref,
            [lambda ids: self.exact_dense(emb, q, ids),
             lambda ids: self.exact_bm25(bm25, terms_b, ids)],
            [F32_ATOL, BM25_ATOL],
        )
        log(stage="B_2M_filtered_two_tier",
            k1_launches=counts["fused_dense_top_k"], masked_fraction=0.5,
            retrieve_ms=p.cuda_event_ms(
                lambda: retr.retrieve_device(qd, terms_b, w, "CG", 40.0)),
            **routes)

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
                   2 * b * n * d, F32_FLOP_S)
        got = k.fused_dense_top_k(emb, q, 32)
        self.compare("fused_dense_top_k",
                     k.fused_dense_top_k_torch(emb, q, 32), got, BF16_ATOL)

    def stage_d_index(self):
        """bench.py's 2M IVF configuration: 2048 planted unit centres,
        sigma = 0.08 doc noise, bf16; BATCHES_D x B_MICRO planted queries
        (gold + 0.05 noise) with planted BM25 terms."""
        n, d, c = self.N_D, self.D_D, self.CENTRES_D
        g = self.seed(41)
        cent = self.unit(torch.randn((c, d), generator=g, device=self.dev))
        which = torch.randint(0, c, (n,), generator=g, device=self.dev)
        emb = self.unit(cent[which] + 0.08 * torch.randn(
            (n, d), generator=g, device=self.dev)).to(torch.bfloat16)
        del cent, which
        n_q = self.BATCHES_D * self.B_MICRO
        gold = torch.randint(0, n, (n_q,), generator=g, device=self.dev)
        q = emb[gold].float()
        q = self.unit(q + 0.05 * torch.randn(q.shape, generator=g,
                                             device=self.dev))
        bm25, terms = self.planted_bm25(g, n, gold, self.V_D)
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
        r_dense, r_fused = self.recall10(dense, gold), self.recall10(fused,
                                                                     gold)
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
        swaps = p.check_top_k(self.exact_dense(emb, qb, ref[2][0]), ref[2][0],
                              self.exact_dense(emb, qb, got[2][0]),
                              got[2][0], FULL_PROBE_ATOL)
        log(stage="D_2M_ivf", recall10_dense_b8=r_dense,
            recall10_fused_b8=r_fused, calls_b8=nb,
            k3_launches_b8=counts["ivf_dense_top_k"],
            k1_launches_b8=counts["fused_dense_top_k"],
            recall10_dense_b256=self.recall10(wide[2][0], gold[:self.B]),
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
                   2 * b * r * d, F32_FLOP_S)
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
        n, d, b, c = self.N_C, self.D_C, self.B, self.CLUSTERS
        per, chunks = n // c, self.CHUNKS
        chunk = n // chunks
        g = self.seed(23)
        cent = self.unit(torch.randn((c, d), generator=g, device=self.dev))
        values = torch.empty((n, d), dtype=torch.int8, device=self.dev)
        scales = torch.empty((n,), dtype=torch.float32, device=self.dev)
        for i in range(chunks):
            rows = i * chunk + torch.arange(chunk, device=self.dev)
            e = cent[rows // per] + 0.042 * torch.randn(
                (chunk, d), generator=g, device=self.dev)
            qd = self.p.quantize_embeddings(e)
            values[i * chunk:(i + 1) * chunk] = qd.values
            scales[i * chunk:(i + 1) * chunk] = qd.scales
            del e, qd
        gold = torch.randint(0, n, (b,), generator=g, device=self.dev)
        q = self.planted_int8_queries(values, scales, gold, g)
        return values, scales, gold, q, cent

    def planted_int8_queries(self, values, scales, gold, g):
        gq = self.unit(values[gold].float() * scales[gold][:, None])
        # cos(q, gold) ~ 0.78.
        return self.unit(gq + 0.025 * torch.randn(gq.shape, generator=g,
                                                  device=self.dev))

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
        r10 = self.recall10(fids, gold)
        assert r10 >= 0.95, f"10.5M int8 recall@10 {r10} below 0.95"
        qv, qs = p.quantize_queries(q[:8])
        ref = p.kernels.fused_dense_top_k_int8_torch(values, scales, qv, qs, 25)
        if not torch.equal(lists[0][:8], ref[1]):
            raise AssertionError("stage C ids differ from the plain version")
        got8 = p.kernels.fused_dense_top_k_int8(values, scales, qv, qs, 25)
        self.compare("fused_dense_top_k_int8", ref, got8, 0.0)
        log(stage="C_10.5M_int8", recall10=r10,
            k2_launches=counts["fused_dense_top_k_int8"],
            ids_equal_plain_8_queries=True,
            retrieve_ms=p.cuda_event_ms(lambda: retr.retrieve_device(
                {MODEL: q}, None, {MODEL: 1.0}, None, 40.0)))
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
        q = self.planted_int8_queries(qd.values, qd.scales, gold, g)
        w = {MODEL: 1.0}
        runs, counts = self.main_path(lambda: [
            retr.retrieve_device({MODEL: q[i * bm:(i + 1) * bm]}, None, w,
                                 None, 40.0) for i in range(nb)])
        self.expect("stage E, B=8", counts, ivf_dense_top_k_int8=nb,
                    fused_dense_top_k_int8=0)
        r10 = self.recall10(torch.cat([r[0] for r in runs]), gold)
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

    def time_pair(self, name, kernel_fn, plain_fn, shape) -> None:
        t = self.p.cuda_event_ms
        # plain, kernel, kernel, plain: drift shows as a gap between pairs.
        p1 = t(plain_fn)
        k1 = t(kernel_fn)
        k2 = t(kernel_fn)
        p2 = t(plain_fn)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        self.times[name] = (ms, plain_ms)
        log(timing=name, shape=shape, ms=ms, plain_ms=plain_ms,
            ms_runs=[k1, k2], plain_ms_runs=[p1, p2], card=self.card,
            method="CUDA events, median of 10 after 3 warm-ups")

    def time_library(self, name, fn, what) -> None:
        t = self.p.cuda_event_ms
        runs = [t(fn), t(fn)]
        self.library[name] = min(runs)
        log(timing=name + "_library", what=what, ms=min(runs), ms_runs=runs,
            card=self.card)

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
        torch.cuda.empty_cache()
        emb, q, bm25, terms = self.phase4_stage_a()
        self.phase5_stage_b(emb, q, bm25, terms)
        self.time_k1(emb, q)
        del emb, q, bm25, terms
        torch.cuda.empty_cache()
        self.phase6_stage_d()
        torch.cuda.empty_cache()
        index, q, cent = self.phase7_stage_c()
        qd = index.dense_q[MODEL]
        self.phase8_stage_e(index, cent)
        self.time_k2(qd.values, qd.scales, q)
        self.kernels_line()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)


class _Port:
    """The port's entry points, imported only after the checks above."""

    def __init__(self):
        from a_nice_rag_tpu_torch import require_cuda
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
        from a_nice_rag_tpu_torch.ops.quantized import (
            QuantizedDense,
            quantize_embeddings,
            quantize_queries,
        )
        from a_nice_rag_tpu_torch.retrieval import FusedRetriever
        from a_nice_rag_tpu_torch.retrieval.engine import _ivf_coverage
        from a_nice_rag_tpu_torch.testing import cuda_event_ms
        from a_nice_rag_tpu_torch.testing.parity import check_top_k

        self.require_cuda = require_cuda
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
