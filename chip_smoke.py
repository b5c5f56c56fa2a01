#!/usr/bin/env python3
"""Smoke run of the PyTorch port (a_nice_rag_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc, holds each against
its plain PyTorch version, then drives the port's main path,
``FusedRetriever.retrieve_device``, at the corpus sizes the repository was
built for at scale:

  0. device check, card name and power limit, kernel build;
  1. K1 (fused_dense_top_k) against its plain version: f32 and bf16 rows,
     with and without a mask, N = 2^20 + 37, k in {1, 32, 128},
     B in {1, 7, 256}, duplicated rows (exact ties across doc splits),
     and k larger than the count of valid docs;
  2. K2 (fused_dense_top_k_int8) against its plain version, same cases;
  3. stage A: 2^21 x 256 bf16 dense + CSR BM25 hybrid (bench.py's 2M
     configuration), planted recall and id equality with the torch route;
  4. stage B: the same index with a filter mask over half the docs and
     two-tier BM25 (128 common terms, so K1 runs masked twice per call);
  5. stage C: 10.5M x 1024 int8 dense-only (bench.py's int8 configuration).

Each kernel and its plain version are timed at the stage A and C shapes
with CUDA events. Prints one JSON object per kernel summary line and, as
the last line, {"ok": true, "device": {...}}. Any failed check raises,
so the exit code is nonzero and no result line is printed. All data is
made on the device from seeded torch.Generator streams.
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
K1_REPLACES = "a_nice_rag_tpu/ops/pallas/fused_topk.py:1440"
K2_REPLACES = "a_nice_rag_tpu/ops/pallas/fused_topk.py:1218"
F32_ATOL = 1e-5
BF16_ATOL = 1e-4
BM25_ATOL = 1e-4


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Smoke:
    # Sizes of the phases (bench.py's configurations for stages A-C).
    N_KERNEL, D_KERNEL = (1 << 20) + 37, 256
    N_A, D_A, B, T, V, DF = 1 << 21, 256, 256, 16, 1 << 17, 16
    N_C, D_C, CLUSTERS, CHUNKS = 10_485_760, 1024, 4096, 40
    V_COMMON = 128

    def __init__(self, port):
        self.p = port
        self.dev = port.require_cuda()
        self.card = card_line()
        self.gen = torch.Generator(device=self.dev)
        self.max_err = {"fused_dense_top_k": 0.0, "fused_dense_top_k_int8": 0.0}
        self.swaps = {"fused_dense_top_k": 0, "fused_dense_top_k_int8": 0}
        self.main_launches = {"fused_dense_top_k": 0,
                              "fused_dense_top_k_int8": 0}
        self.times = {}

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
        got = {"fused_dense_top_k": k.fused_dense_top_k.launches,
               "fused_dense_top_k_int8": k.fused_dense_top_k_int8.launches}
        for name, n in got.items():
            self.main_launches[name] += n
        return out, got

    # -- phases -----------------------------------------------------------

    def phase0_build(self) -> None:
        print(self.card, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        self.p.kernels.build_kernels()
        seconds = time.perf_counter() - t0
        report = self.p.build_log.get("fused_topk", (seconds, ""))[1]
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip(), flush=True)
        log(phase="build", seconds=round(seconds, 3),
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

    def stage_a_index(self):
        """bench.py's 2M configuration, built on the device."""
        p = self.p
        n, d, b, t, v, df = self.N_A, self.D_A, self.B, self.T, self.V, self.DF
        g = self.seed(11)
        emb = self.unit(torch.randn((n, d), generator=g, device=self.dev))
        emb = emb.to(torch.bfloat16)
        gold = torch.randint(0, n, (b,), generator=g, device=self.dev)
        q = emb[gold].float()
        # cos(q, gold) ~ 1/sqrt(1 + 0.1^2 * 256) ~ 0.53: planted, not trivial.
        q = self.unit(q + 0.10 * torch.randn(q.shape, generator=g,
                                             device=self.dev))
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

    def phase3_stage_a(self):
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

        def recall10(fids):
            top = fids[:, :10]
            return float((top == gold[:, None]).any(dim=1).float().mean())

        runs, counts = self.main_path(lambda: [
            retr.retrieve_device(qd, terms, w, None, 40.0)
            for w in (w_h, {MODEL: 1.0, "BM25": 0.0},
                      {MODEL: 0.0, "BM25": 1.0})
        ])
        if counts["fused_dense_top_k"] != 3:
            raise AssertionError(f"stage A: K1 launched {counts} for 3 calls")
        r_h, r_d, r_b = (recall10(r[0]) for r in runs)
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
            **routes)
        del ref, ref_retr, runs
        return emb, q, bm25, terms

    def phase4_stage_b(self, emb, q, bm25, terms):
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
        if counts["fused_dense_top_k"] != 2:
            raise AssertionError(f"stage B: K1 launched {counts} for 1 call")
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
            **routes)

    def stage_c_index(self):
        """bench.py's int8 configuration: 4096 cluster centres, doc noise
        0.042, quantized chunk by chunk so the 43 GB f32 matrix never
        exists."""
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
        gq = self.unit(values[gold].float() * scales[gold][:, None])
        # cos(q, gold) ~ 0.78.
        q = self.unit(gq + 0.025 * torch.randn(gq.shape, generator=g,
                                               device=self.dev))
        return values, scales, gold, q

    def phase5_stage_c(self):
        p = self.p
        values, scales, gold, q = self.stage_c_index()
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
        if counts["fused_dense_top_k_int8"] != 1:
            raise AssertionError(f"stage C: K2 launched {counts} for 1 call")
        r10 = float((fids[:, :10] == gold[:, None]).any(dim=1).float().mean())
        assert r10 >= 0.95, f"10.5M int8 recall@10 {r10} below 0.95"
        qv, qs = p.quantize_queries(q[:8])
        ref = p.kernels.fused_dense_top_k_int8_torch(values, scales, qv, qs, 25)
        if not torch.equal(lists[0][:8], ref[1]):
            raise AssertionError("stage C ids differ from the plain version")
        got8 = p.kernels.fused_dense_top_k_int8(values, scales, qv, qs, 25)
        self.compare("fused_dense_top_k_int8", ref, got8, 0.0)
        log(stage="C_10.5M_int8", recall10=r10,
            k2_launches=counts["fused_dense_top_k_int8"],
            ids_equal_plain_8_queries=True)
        return values, scales, q

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

    def kernels_line(self) -> None:
        rows = []
        for name, replaces in (("fused_dense_top_k", K1_REPLACES),
                               ("fused_dense_top_k_int8", K2_REPLACES)):
            ms, plain_ms = self.times[name]
            rows.append({
                "name": name, "route": "cuda", "source": K1_SOURCE,
                "replaces": replaces, "launches": self.main_launches[name],
                "max_abs_err": self.max_err[name], "ms": ms,
                "plain_ms": plain_ms,
            })
        for row in rows:
            if row["launches"] < 1:
                raise AssertionError(f"{row['name']} never ran on the main path")
        print(json.dumps({"kernels": rows}), flush=True)

    def run(self) -> None:
        k = self.p.kernels
        self.phase0_build()
        self.phase1_k1()
        self.phase2_k2()
        emb, q, bm25, terms = self.phase3_stage_a()
        self.phase4_stage_b(emb, q, bm25, terms)
        self.time_pair(
            "fused_dense_top_k",
            lambda: k.fused_dense_top_k(emb, q, 32),
            lambda: k.fused_dense_top_k_torch(emb, q, 32),
            "2^21 x 256 bf16, B=256, k=32, no mask",
        )
        got = k.fused_dense_top_k(emb, q, 32)
        self.compare("fused_dense_top_k",
                     k.fused_dense_top_k_torch(emb, q, 32), got, BF16_ATOL)
        del emb, q, bm25, terms, got
        torch.cuda.empty_cache()
        values, scales, q = self.phase5_stage_c()
        qv, qs = self.p.quantize_queries(q)
        self.time_pair(
            "fused_dense_top_k_int8",
            lambda: k.fused_dense_top_k_int8(values, scales, qv, qs, 25),
            lambda: k.fused_dense_top_k_int8_torch(values, scales, qv, qs, 25),
            "10,485,760 x 1024 int8, B=256, k=25, no mask",
        )
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
        from a_nice_rag_tpu_torch.ops import kernels
        from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays
        from a_nice_rag_tpu_torch.ops.kernels._build import build_log
        from a_nice_rag_tpu_torch.ops.quantized import (
            QuantizedDense,
            quantize_embeddings,
            quantize_queries,
        )
        from a_nice_rag_tpu_torch.retrieval import FusedRetriever
        from a_nice_rag_tpu_torch.testing import cuda_event_ms
        from a_nice_rag_tpu_torch.testing.parity import check_top_k

        self.require_cuda = require_cuda
        self.ArrayIndex, self.CorpusMeta = ArrayIndex, CorpusMeta
        self.kernels = kernels
        self.Bm25Arrays = Bm25Arrays
        self.build_log = build_log
        self.QuantizedDense = QuantizedDense
        self.quantize_embeddings = quantize_embeddings
        self.quantize_queries = quantize_queries
        self.FusedRetriever = FusedRetriever
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
