"""The port's benchmark: the repository's bench.py retrieval stages on one
CUDA GPU.

    python -m a_nice_rag_tpu_torch.bench [--repeats R]

Counterpart of ``bench.py`` (the JAX package on one TPU chip), at its
widths. Five stages, each a function of (device, repeats, timer, config):

  headline   reference scale: ``synth_corpus`` 9,728 x 2048 f32 with BM25
             built from its tokens, B = 2048, similarity_k 25, top 15
             (bench.py:21-53, :1141-1316);
  2m         2^21 x 256 bf16 dense + CSR BM25 (V = 2^17, df 16), B = 256,
             k = 32, hybrid through K1 (``at_scale_metrics``, :56-329);
  int8       10,485,760 x 1024 int8 around 4096 planted centres, B = 256,
             k = 25 through K2, and its cluster-major IVF at B = 8,
             nprobe 8 through K4 (``int8_scale_metrics``, :332-582);
  ivf        2^21 x 256 bf16 around 2048 planted centres, k-means IVF,
             B = 8, nprobe 16, k = 16: K3 against K1 (``ivf_scale_metrics``,
             :585-718);
  crossover  the ivf stage's corpus at B in {1, 2, ..., 256}: the IVF and
             exact routes in turns (``scripts/sweep_ivf_batch_crossover.py``).

Every stage asserts its recall floors and, on the device, that its
kernel-route ids equal its torch-route ids up to ties within the
tolerance (``check_top_k``): ``FusedRetriever(dense_backend="torch")``
on the same index for the exact routes, and the plain versions of K3/K4
on the same tile table for the IVF routes. The int8 stage holds K2's ids
against K2's plain version on 8 queries: the torch route would upcast
the 10.7 GB matrix to 43 GB of f32. The 2m and int8 stages also time
``stream_sum`` over their matrix, the stage's stream floor: the least
time one pass over the matrix takes in the same run (``pct_of_floor`` =
stream ms / batch ms).

Every timed key ``x`` is the median of R repeats, with ``x_runs`` its
min, median and max. Timers (``testing/timing.py``): ``*_true_ms`` keys
and stream floors put one pair of CUDA events around back-to-back calls
(``device_loop_ms``); batch QPS and ``p50_device_ms`` use the host clock
around back-to-back calls ending in a synchronize (``chained_ms``);
``qps_host_sync`` and ``p50_latency_ms`` read the result to the host
after every call.

Not carried over from bench.py: the ``packed`` and ``iterate`` fold rows
and ``xpack_ids_equal_iterate`` (:242-308) time TPU folds that the port
does not have; the CPU fallback, platform probe and re-exec (:1121-1165)
and the round-trip de-bias and stream clamp (:199-237) work around a
remote TPU backend; its TPU-calibrated IVF speed-up floors are reported,
not asserted. ``gen_serving_metrics`` (:721) and ``served_qps_metrics``
(:816-1118) wait for the port's generation and serving.

Prints ONE JSON line. Raises without a GPU: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import require_cuda
from a_nice_rag_tpu_torch.index.array_index import (
    ArrayIndex,
    CorpusMeta,
    build_index,
)
from a_nice_rag_tpu_torch.index.ivf import (
    IVFDense,
    attach_ivf,
    build_tile_table,
    default_max_tiles,
)
from a_nice_rag_tpu_torch.ops import kernels
from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays, postings_required
from a_nice_rag_tpu_torch.ops.quantized import (
    QuantizedDense,
    quantize_embeddings,
    quantize_queries,
)
from a_nice_rag_tpu_torch.retrieval.engine import FusedRetriever, _ivf_coverage
from a_nice_rag_tpu_torch.testing.parity import (
    check_stream_sum,
    check_top_k,
)
from a_nice_rag_tpu_torch.testing.synth import synth_corpus
from a_nice_rag_tpu_torch.testing.timing import chained_ms, device_loop_ms

MODEL = "voyage-3-large"
# Tolerances of the route comparisons: f32 dense scores of unit-norm
# operands summed in another order (bf16 rows: f32 products of rounded
# rows); BM25 totals of f32 impacts; WRRF sums.
F32_ATOL = 1e-5
BF16_ATOL = 1e-4
BM25_ATOL = 1e-4
FUSED_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Timer:
    """How a stage times a call: ``device_ms(fn, n)`` and ``host_ms(fn,
    n)`` give milliseconds per call over ``n`` back-to-back calls."""

    device_ms: Callable[[Callable[[], object], int], float]
    host_ms: Callable[[Callable[[], object], int], float]


def cuda_timer() -> Timer:
    require_cuda()
    return Timer(
        device_ms=lambda fn, n: device_loop_ms(fn, n_loop=n, trials=1),
        host_ms=lambda fn, n: chained_ms(fn, n=n, trials=1),
    )


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _timed(out: dict, key: str, measure: Callable[[], float],
           repeats: int) -> float:
    """``out[key]`` = the median of ``repeats`` measurements, and
    ``out[key + "_runs"]`` their min, median and max."""
    xs = [float(measure()) for _ in range(repeats)]
    med = statistics.median(xs)
    out[key] = med
    out[key + "_runs"] = {"min": min(xs), "median": med, "max": max(xs)}
    return med


def unit(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit norm."""
    return x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + 1e-12)


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def recall_at_10(ids: torch.Tensor, gold: torch.Tensor) -> float:
    return float((ids[:, :10] == gold[:, None]).any(dim=1).float().mean())


# -- id parity of the routes -------------------------------------------


def exact_dense(emb: torch.Tensor, q: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """float64 scores [B, k] of the given rows; -inf where the id is -1.
    Row chunks of the batch bound the [b, k, D] gather."""
    out = []
    for b0 in range(0, ids.shape[0], 256):
        i = ids[b0:b0 + 256]
        rows = emb[i.clamp(min=0).long()].double()
        out.append(torch.einsum("bkd,bd->bk", rows,
                                q[b0:b0 + 256].double()))
    s = torch.cat(out)
    return torch.where(ids >= 0, s, float("-inf"))


def exact_bm25_uniform(bm25: Bm25Arrays, terms: torch.Tensor, df: int,
                       ids: torch.Tensor) -> torch.Tensor:
    """float64 BM25 totals [B, k] of the given docs over CSR postings of
    uniform length ``df``."""
    starts = bm25.indptr[terms.clamp(min=0).long()].long()  # [B, T]
    pos = starts[:, :, None] + torch.arange(df, device=terms.device)
    live = (terms >= 0)[:, :, None].expand_as(pos)
    docs = bm25.doc_ids[pos].reshape(terms.shape[0], -1)
    imp = torch.where(live, bm25.impact[pos], 0.0).reshape(docs.shape)
    hit = docs[:, None, :] == ids[:, :, None]
    s = (hit.double() * imp[:, None, :].double()).sum(dim=-1)
    return torch.where(ids >= 0, s, float("-inf"))


def exact_bm25_dense(impact: torch.Tensor, terms: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """float64 BM25 totals [B, k] from a dense [V, N] impact matrix;
    a term repeated in a query counts each time."""
    t = terms.clamp(min=0).long()[:, :, None]
    d = ids.clamp(min=0).long()[:, None, :]
    imp = impact[t, d].double()  # [B, T, k]
    s = torch.where((terms >= 0)[:, :, None], imp, 0.0).sum(dim=1)
    return torch.where(ids >= 0, s, float("-inf"))


def assert_route_parity(got, ref, rescore: Sequence[Callable],
                        atols: Sequence[float]) -> dict:
    """``got`` and ``ref`` are ``retrieve_device`` outputs of the kernel
    and the torch route. Each list's ids must agree up to swaps between
    docs whose exact scores (``rescore[li](ids)``) lie within its
    tolerance; the fused ids then agree exactly when no list swapped, and
    up to fused-score ties otherwise."""
    (fids, fvals, lists), (rfids, rfvals, rlists) = got, ref
    swaps = 0
    for li, (fn, atol) in enumerate(zip(rescore, atols)):
        swaps += check_top_k(fn(rlists[li]), rlists[li], fn(lists[li]),
                             lists[li], atol)
    equal = torch.equal(fids, rfids)
    if swaps == 0 and not equal:
        raise AssertionError("fused ids differ from the torch route")
    check_top_k(rfvals, rfids, fvals, fids, FUSED_ATOL)
    return {"list_swaps": swaps, "fused_ids_equal_torch_route": equal}


def assert_ivf_parity(iv: IVFDense, q: torch.Tensor, nprobe: int, k: int,
                      ids: torch.Tensor) -> int:
    """The IVF kernel (K3 or K4) against its plain version on the batch's
    tile table, and the retriever's IVF list ``ids`` against the kernel's
    ids mapped through the permutation. Returns the tie swaps."""
    table, _ = build_tile_table(
        iv.centroids, iv.cluster_start, q, nprobe=nprobe,
        max_tiles=default_max_tiles(iv, q.shape[0], nprobe),
        tile_n=iv.tile_n, mct=iv.max_cluster_tiles)
    kw = dict(tile_n=iv.tile_n, n_real=iv.n_real)
    if iv.emb is not None:
        got = kernels.ivf_dense_top_k(iv.emb, q, table, k, **kw)
        ref = kernels.ivf_dense_top_k_torch(iv.emb, q, table, k, **kw)
        swaps = check_top_k(*ref, *got, BF16_ATOL)
    else:
        qv, qs = quantize_queries(q)
        args = (iv.values, iv.scales, qv, qs, table, k)
        got = kernels.ivf_dense_top_k_int8(*args, **kw)
        ref = kernels.ivf_dense_top_k_int8_torch(*args, **kw)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError("K4 differs from its plain version")
        swaps = 0
    mapped = torch.where(got[1] >= 0, iv.perm[got[1].clamp(min=0).long()],
                         -1)
    if not torch.equal(mapped.to(ids.dtype), ids):
        raise AssertionError("the IVF route's ids differ from its kernel's")
    return swaps


def stream_floor(mat: torch.Tensor, timer: Timer, repeats: int,
                 n_loop: int = 10) -> dict:
    """``stream_sum`` over ``mat``: held against its plain version, then
    timed. Returns stream_ms (+ runs) and stream_gb_s."""
    check_stream_sum(mat)
    out: dict = {}
    ms = _timed(out, "stream_ms", lambda: timer.device_ms(
        lambda: kernels.stream_sum(mat), n_loop), repeats)
    out["stream_gb_s"] = mat.numel() * mat.element_size() / 1e9 / ms * 1e3
    return out


def _floor_keys(out: dict, floor: dict, tag: str, batch_ms: float,
                n_bytes: int) -> None:
    out[f"stream_{tag}_ms"] = floor["stream_ms"]
    out[f"stream_{tag}_ms_runs"] = floor["stream_ms_runs"]
    out[f"stream_gb_s_{tag}"] = floor["stream_gb_s"]
    out[f"pct_of_floor_{tag}"] = floor["stream_ms"] / batch_ms
    out[f"fused_gb_s_{tag}"] = n_bytes / 1e9 / batch_ms * 1e3


# -- headline ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadlineConfig:
    n_docs: int = 9728  # the reference corpus scale
    dim: int = 2048  # voyage-3-large output_dimension
    batch: int = 2048
    vocab: int = 20000
    t_max: int = 16
    iters: int = 15
    single_iters: int = 50
    p50_samples: int = 30
    recall_queries: int = 256
    seed: int = 7


def headline_setup(cfg: HeadlineConfig, device):
    """bench.py's reference-scale index on ``device``: (corpus, index,
    retriever, queries [B, D], term ids [B, t_max]). The noise is
    calibrated at dim 2048 so that hybrid recall beats both rankers."""
    c = synth_corpus(
        n_docs=cfg.n_docs, dim=cfg.dim, n_queries=cfg.batch,
        vocab_size=cfg.vocab, seed=cfg.seed, model_noise={MODEL: 0.22},
        query_token_noise=0.15,
    )
    index = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                        embeddings=c.embeddings, token_lists=c.tokens,
                        device=device)
    terms = torch.as_tensor(index.pad_term_ids(c.query_tokens, cfg.t_max),
                            device=index.device)
    need = int(postings_required(index.bm25, terms).max())
    budget = 1 << int(np.ceil(np.log2(max(need, 1024))))
    retr = FusedRetriever(index, (MODEL,), use_bm25=True, similarity_k=25,
                          common_sections_n=15, budget=budget)
    q = torch.as_tensor(c.query_embeddings[MODEL], device=index.device)
    return c, index, retr, q, terms


def _recall_valid10(fids: np.ndarray, gold_rows: np.ndarray) -> float:
    """bench.py's recall: the gold row among the first 10 valid ids."""
    hits = [gold_rows[b] in row[row >= 0][:10] for b, row in enumerate(fids)]
    return float(np.mean(hits))


def headline_stage(device, repeats: int, timer: Timer,
                   cfg: HeadlineConfig = HeadlineConfig()) -> dict:
    c, index, retr, q, terms = headline_setup(cfg, device)
    hybrid = {MODEL: 5.0, "BM25": 1.0}
    qd = {MODEL: q}
    nr = min(cfg.recall_queries, cfg.batch)
    gold_rows = np.array([index.meta.id_to_row[g] for g in c.gold_ids[:nr]])

    def recall(w):
        fids = retr.retrieve_device(qd, terms, w, None, 40.0)[0]
        return _recall_valid10(fids[:nr].cpu().numpy(), gold_rows)

    r_h = recall(hybrid)
    r_d = recall({MODEL: 1.0, "BM25": 0.0})
    r_b = recall({MODEL: 0.0, "BM25": 1.0})
    if r_h < 0.90:
        raise AssertionError(f"hybrid recall@10 {r_h} below 0.90 (dense "
                             f"{r_d}, bm25 {r_b})")
    if r_h < max(r_d, r_b):
        raise AssertionError(f"hybrid recall@10 {r_h} below its best ranker "
                             f"(dense {r_d}, bm25 {r_b})")
    ref_retr = FusedRetriever(index, (MODEL,), use_bm25=True,
                              similarity_k=25, common_sections_n=15,
                              budget=retr.budget, dense_backend="torch")
    emb = index.dense[MODEL]
    parity = assert_route_parity(
        retr.retrieve_device(qd, terms, hybrid, None, 40.0),
        ref_retr.retrieve_device(qd, terms, hybrid, None, 40.0),
        [lambda ids: exact_dense(emb, q, ids),
         lambda ids: exact_bm25_dense(index.bm25_dense.impact, terms, ids)],
        [F32_ATOL, BM25_ATOL])
    del ref_retr

    def batch():
        return retr.retrieve_device(qd, terms, hybrid, None, 40.0)

    q1, t1 = {MODEL: q[:1]}, terms[:1]

    def single():
        return retr.retrieve_device(q1, t1, hybrid, None, 40.0)

    def host_sync_qps():
        t0 = time.perf_counter()
        for _ in range(cfg.iters):
            batch()[0].cpu()
        return cfg.batch * cfg.iters / (time.perf_counter() - t0)

    def p50_ms():
        lat = []
        for _ in range(cfg.p50_samples):
            t0 = time.perf_counter()
            single()[0][0, 0].item()
            lat.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(lat)

    out = {
        "batch": cfg.batch, "n_docs": cfg.n_docs, "dim": cfg.dim,
        "bm25_budget": retr.budget, "kernel_route_headline": retr.use_kernel,
        "recall@10_planted": r_h, "recall@10_dense_only": r_d,
        "recall@10_bm25_only": r_b,
        **{"headline_" + k: v for k, v in parity.items()},
    }
    _timed(out, "value", lambda: cfg.batch / timer.host_ms(
        batch, cfg.iters) * 1e3, repeats)
    _timed(out, "qps_host_sync", host_sync_qps, repeats)
    _timed(out, "p50_latency_ms", p50_ms, repeats)
    _timed(out, "p50_device_ms", lambda: timer.host_ms(
        single, cfg.single_iters), repeats)
    _timed(out, "p50_device_true_ms", lambda: timer.device_ms(
        single, cfg.single_iters), repeats)
    _timed(out, "batch_headline_true_ms", lambda: timer.device_ms(
        batch, cfg.iters), repeats)
    return out


# -- 2M bf16 hybrid --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scale2MConfig:
    n: int = 1 << 21
    dim: int = 256
    batch: int = 256
    t: int = 16
    vocab: int = 1 << 17
    df: int = 16
    k: int = 32
    seed: int = 11
    n_loop: int = 20


def planted_bm25(g: torch.Generator, n: int, gold: torch.Tensor, v: int,
                 t: int, df: int) -> Tuple[Bm25Arrays, torch.Tensor]:
    """CSR postings of v terms x df docs (doc-sorted, impacts in [0.5,
    1.5)); term j * t + i of query j (i < t) holds that query's gold doc.
    Returns the arrays and the [B, t] query term ids."""
    dev = gold.device
    b = gold.shape[0]
    doc_mat = torch.randint(0, n, (v, df), generator=g, device=dev,
                            dtype=torch.int32)
    doc_mat[: b * t, 0] = gold.to(torch.int32).repeat_interleave(t)
    doc_mat = doc_mat.sort(dim=1).values
    impact = torch.rand((v, df), generator=g, device=dev) + 0.5
    bm25 = Bm25Arrays(
        indptr=torch.arange(v + 1, device=dev, dtype=torch.int32) * df,
        doc_ids=torch.cat([doc_mat.reshape(-1),
                           torch.tensor([n], device=dev, dtype=torch.int32)]),
        impact=torch.cat([impact.reshape(-1), torch.zeros(1, device=dev)]),
        n_docs_padded=n,
    )
    terms = torch.arange(b * t, device=dev, dtype=torch.int32).reshape(b, t)
    return bm25, terms


def array_index(n: int, dense=None, bm25=None, df: Optional[int] = None,
                dense_q=None, sources: Sequence[str] = ()) -> ArrayIndex:
    """An index over device arrays made in place (no host build): n docs,
    no padding; ``sources`` feed the filter masks."""
    meta = CorpusMeta(ids=[], sources=list(sources), contents=[], urls=[],
                      n_docs=n, n_docs_padded=n)
    return ArrayIndex(
        meta=meta, dense=dense or {}, bm25=bm25, vocab=None,
        bm25_stats=None if df is None else {"max_df": df},
        bm25_doc_mask=None if bm25 is None else np.ones(n, dtype=bool),
        dense_q=dense_q,
    )


def scale_2m_data(cfg: Scale2MConfig, device):
    """bench.py's 2M configuration, made on the device: unit bf16 rows,
    planted queries and CSR postings. Returns (emb, gold, q, bm25,
    terms)."""
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    n, b = cfg.n, cfg.batch
    emb = unit(torch.randn((n, cfg.dim), generator=g, device=device))
    emb = emb.to(torch.bfloat16)
    gold = torch.randint(0, n, (b,), generator=g, device=device)
    # cos(q, gold) ~ 1/sqrt(1 + 0.1^2 * 256) ~ 0.53: planted, not trivial.
    q = unit(emb[gold].float() + 0.10 * torch.randn(
        (b, cfg.dim), generator=g, device=device))
    bm25, terms = planted_bm25(g, n, gold, cfg.vocab, cfg.t, cfg.df)
    return emb, gold, q, bm25, terms


def scale_2m_stage(device, repeats: int, timer: Timer,
                   cfg: Scale2MConfig = Scale2MConfig()) -> dict:
    emb, gold, q, bm25, terms = scale_2m_data(cfg, device)
    n, b = cfg.n, cfg.batch
    index = array_index(n, dense={MODEL: emb}, bm25=bm25, df=cfg.df)
    kw = dict(similarity_k=cfg.k, common_sections_n=cfg.k, budget=1024)
    retr = FusedRetriever(index, (MODEL,), use_bm25=True, **kw)
    if not retr.use_kernel:
        raise AssertionError("the 2M stage must route to the kernels")
    qd = {MODEL: q}
    hybrid = {MODEL: 5.0, "BM25": 1.0}

    def call(w=hybrid):
        return retr.retrieve_device(qd, terms, w, None, 40.0)

    r_h = recall_at_10(call()[0], gold)
    r_d = recall_at_10(call({MODEL: 1.0, "BM25": 0.0})[0], gold)
    r_b = recall_at_10(call({MODEL: 0.0, "BM25": 1.0})[0], gold)
    if r_h < 0.99 or r_d < 0.95 or r_b < 0.95:
        raise AssertionError(f"2M recall@10 hybrid {r_h} (floor 0.99), "
                             f"dense {r_d}, bm25 {r_b} (floors 0.95)")
    ref_retr = FusedRetriever(index, (MODEL,), use_bm25=True,
                              dense_backend="torch", **kw)
    parity = assert_route_parity(
        call(), ref_retr.retrieve_device(qd, terms, hybrid, None, 40.0),
        [lambda ids: exact_dense(emb, q, ids),
         lambda ids: exact_bm25_uniform(bm25, terms, cfg.df, ids)],
        [BF16_ATOL, BM25_ATOL])
    del ref_retr
    _free()
    out = {"n_docs_2m": n, "dim_2m": cfg.dim, "batch_2m": b,
           "kernel_route_2m": True, "recall@10_2m_hybrid": r_h,
           "recall@10_2m_dense": r_d, "recall@10_2m_bm25": r_b,
           **{k + "_2m": v for k, v in parity.items()}}
    qps = _timed(out, "qps_2m", lambda: b / timer.host_ms(
        call, cfg.n_loop) * 1e3, repeats)
    true_ms = _timed(out, "batch_2m_true_ms", lambda: timer.device_ms(
        call, cfg.n_loop), repeats)
    out["batch_2m_ms"] = b / qps * 1e3
    out["qps_2m_true"] = b / true_ms * 1e3
    _floor_keys(out, stream_floor(emb, timer, repeats), "2m", true_ms,
                emb.numel() * emb.element_size())
    return out


# -- 10.5M int8 ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Int8Config:
    n: int = 10_485_760
    dim: int = 1024
    batch: int = 256
    k: int = 25
    clusters: int = 4096
    chunks: int = 40  # 1.07 GB of f32 per chunk
    seed: int = 23
    n_loop: int = 5
    ivf_batch: int = 8
    ivf_batches: int = 32
    nprobe: int = 8
    tile_n: int = 2048
    ivf_loop: int = 20


def int8_corpus(cfg: Int8Config, device):
    """The clustered int8 corpus, cluster-major (row r belongs to centre
    r // (n / clusters)), quantized chunk by chunk so the 43 GB f32 matrix
    never exists. Returns (values, scales, centres, generator)."""
    n, d, c = cfg.n, cfg.dim, cfg.clusters
    per, chunk = n // c, n // cfg.chunks
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    cent = unit(torch.randn((c, d), generator=g, device=device))
    values = torch.empty((n, d), dtype=torch.int8, device=device)
    scales = torch.empty((n,), dtype=torch.float32, device=device)
    for i in range(cfg.chunks):
        rows = i * chunk + torch.arange(chunk, device=device)
        # sigma 0.042: within-cluster cosine ~0.6 at D = 1024.
        e = cent[rows // per] + 0.042 * torch.randn(
            (chunk, d), generator=g, device=device)
        qd = quantize_embeddings(e)
        values[i * chunk:(i + 1) * chunk] = qd.values
        scales[i * chunk:(i + 1) * chunk] = qd.scales
        del e, qd
    return values, scales, cent, g


def planted_int8_queries(values, scales, gold, g) -> torch.Tensor:
    gq = unit(values[gold].float() * scales[gold][:, None])
    # cos(q, gold) ~ 0.78.
    return unit(gq + 0.025 * torch.randn(gq.shape, generator=g,
                                          device=gq.device))


def int8_stage(device, repeats: int, timer: Timer,
               cfg: Int8Config = Int8Config()) -> dict:
    values, scales, cent, g = int8_corpus(cfg, device)
    n, b = cfg.n, cfg.batch
    gold = torch.randint(0, n, (b,), generator=g, device=device)
    q = planted_int8_queries(values, scales, gold, g)
    index = array_index(n, dense_q={MODEL: QuantizedDense(values, scales)})
    kw = dict(use_bm25=False, similarity_k=cfg.k, common_sections_n=cfg.k)
    retr = FusedRetriever(index, (MODEL,), **kw)
    if not retr.use_kernel:
        raise AssertionError("the int8 stage must route to the kernels")
    w = {MODEL: 1.0}

    def call():
        return retr.retrieve_device({MODEL: q}, None, w, None, 40.0)

    fids, _, lists = call()
    r10 = recall_at_10(fids, gold)
    if r10 < 0.95:
        raise AssertionError(f"10.5M int8 recall@10 {r10} below 0.95")
    qv, qs = quantize_queries(q[:8])
    ref = kernels.fused_dense_top_k_int8_torch(values, scales, qv, qs, cfg.k)
    if not torch.equal(lists[0][:8], ref[1]):
        raise AssertionError("int8 kernel-route ids differ from K2's plain "
                             "version")
    out = {"n_docs_10m_int8": n, "dim_10m_int8": cfg.dim,
           "batch_10m_int8": b, "kernel_route_10m_int8": True,
           "recall@10_10m_int8": r10, "ids_equal_plain_10m_int8": True}
    qps = _timed(out, "qps_10m_int8", lambda: b / timer.host_ms(
        call, cfg.n_loop) * 1e3, repeats)
    out["batch_10m_int8_ms"] = b / qps * 1e3
    true_ms = _timed(out, "batch_10m_int8_true_ms", lambda: timer.device_ms(
        call, cfg.n_loop), repeats)
    out["qps_10m_int8_true"] = b / true_ms * 1e3
    _floor_keys(out, stream_floor(values, timer, repeats, n_loop=5), "10m",
                true_ms, values.numel())
    out["fused_gb_s_10m_int8"] = out.pop("fused_gb_s_10m")
    out.update(_int8_ivf(index, values, scales, cent, g, repeats, timer,
                         cfg))
    return out


def _int8_ivf(index, values, scales, cent, g, repeats, timer,
              cfg: Int8Config) -> dict:
    """The same corpus is already cluster-major, so its IVF is free:
    identity permutation, equal cluster spans, the planted centres as
    centroids; no second copy of the matrix."""
    n, c = cfg.n, cfg.clusters
    per = n // c
    dev = values.device
    iv = IVFDense(
        centroids=cent, perm=torch.arange(n, dtype=torch.int32, device=dev),
        cluster_start=torch.arange(c + 1, dtype=torch.int32,
                                   device=dev) * per,
        tile_n=cfg.tile_n, n_real=n,
        max_cluster_tiles=per // cfg.tile_n + 2, values=values,
        scales=scales,
    )
    index.ivf = {MODEL: iv}
    kw = dict(use_bm25=False, similarity_k=cfg.k, common_sections_n=cfg.k)
    retr = FusedRetriever(index, (MODEL,), nprobe=cfg.nprobe, **kw)
    exact = FusedRetriever(index, (MODEL,), **kw)
    bm, nb = cfg.ivf_batch, cfg.ivf_batches
    if _ivf_coverage(bm, cfg.nprobe, c) > retr.ivf_max_coverage:
        raise AssertionError("B = 8 must take the IVF route")
    gold = torch.randint(0, n, (nb * bm,), generator=g, device=dev)
    q = planted_int8_queries(values, scales, gold, g)
    w = {MODEL: 1.0}

    def call(r, i):
        return r.retrieve_device({MODEL: q[i * bm:(i + 1) * bm]}, None, w,
                                 None, 40.0)

    runs = [call(retr, i) for i in range(nb)]
    r10 = recall_at_10(torch.cat([r[0] for r in runs]), gold)
    if r10 < 0.95:
        raise AssertionError(f"10.5M int8 IVF recall@10 {r10} below 0.95")
    assert_ivf_parity(iv, q[:bm], cfg.nprobe, cfg.k, runs[0][2][0])
    out = {"recall@10_10m_int8_ivf": r10, "ivf_nprobe_10m": cfg.nprobe,
           "ivf_clusters_10m": c, "ivf_ids_equal_plain_10m_int8": True}
    ivf_ms = _timed(out, "ivf_10m_int8_b8_true_ms", lambda: timer.device_ms(
        lambda: call(retr, 0), cfg.ivf_loop), repeats)
    exact_ms = _timed(out, "exact_10m_int8_b8_true_ms",
                      lambda: timer.device_ms(lambda: call(exact, 0),
                                              cfg.n_loop), repeats)
    out["ivf_speedup_10m_int8_b8"] = exact_ms / ivf_ms
    out["qps_10m_int8_ivf"] = bm / ivf_ms * 1e3
    index.ivf = None
    return out


# -- 2M IVF and the crossover ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class IvfConfig:
    n: int = 1 << 21
    dim: int = 256
    centres: int = 2048
    tile_n: int = 1024
    nprobe: int = 16
    k: int = 16
    batch: int = 8
    batches: int = 64
    pool: int = 2048  # planted queries
    seed: int = 13
    n_loop: int = 50  # back-to-back calls per timing, both stages
    crossover_batches: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@dataclasses.dataclass
class IvfCorpus:
    index: ArrayIndex
    iv: IVFDense
    emb: torch.Tensor
    q: torch.Tensor  # [pool, D] planted queries
    gold: torch.Tensor  # [pool]
    build_s: float


def ivf_corpus(cfg: IvfConfig, device) -> IvfCorpus:
    """2048 planted unit centres, sigma 0.08 doc noise (within-cluster
    cosine ~0.61), bf16; a k-means IVF (10 Lloyd iterations); a pool of
    planted queries (gold + 0.05 noise: cosine to gold ~0.78)."""
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    n, d = cfg.n, cfg.dim
    cent = unit(torch.randn((cfg.centres, d), generator=g, device=device))
    which = torch.randint(0, cfg.centres, (n,), generator=g, device=device)
    emb = unit(cent[which] + 0.08 * torch.randn(
        (n, d), generator=g, device=device)).to(torch.bfloat16)
    del cent, which
    gold = torch.randint(0, n, (cfg.pool,), generator=g, device=device)
    q = unit(emb[gold].float() + 0.05 * torch.randn(
        (cfg.pool, d), generator=g, device=device))
    index = array_index(n, dense={MODEL: emb})
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    iv = attach_ivf(index, MODEL, tile_n=cfg.tile_n, n_iters=10, seed=0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return IvfCorpus(index, iv, emb, q, gold, time.perf_counter() - t0)


def _ivf_retrievers(corpus: IvfCorpus, cfg: IvfConfig, **ivf_kw):
    kw = dict(use_bm25=False, similarity_k=cfg.k, common_sections_n=cfg.k)
    return (FusedRetriever(corpus.index, (MODEL,), nprobe=cfg.nprobe,
                           **ivf_kw, **kw),
            FusedRetriever(corpus.index, (MODEL,), **kw),
            FusedRetriever(corpus.index, (MODEL,), dense_backend="torch",
                           **kw))


def _dense_call(r: FusedRetriever, q: torch.Tensor):
    return r.retrieve_device({MODEL: q}, None, {MODEL: 1.0}, None, 40.0)


def _exact_parity(corpus: IvfCorpus, exact, torch_route, q) -> int:
    got, ref = _dense_call(exact, q), _dense_call(torch_route, q)
    return assert_route_parity(
        got, ref, [lambda ids: exact_dense(corpus.emb, q, ids)],
        [BF16_ATOL])["list_swaps"]


def _tile_fraction(corpus: IvfCorpus, q: torch.Tensor, nprobe: int) -> float:
    iv = corpus.iv
    _, n_unique = build_tile_table(
        iv.centroids, iv.cluster_start, q, nprobe=nprobe,
        max_tiles=default_max_tiles(iv, q.shape[0], nprobe),
        tile_n=iv.tile_n, mct=iv.max_cluster_tiles)
    return int(n_unique) / iv.n_tiles


def ivf_stage(device, repeats: int, timer: Timer,
              cfg: IvfConfig = IvfConfig(),
              corpus: Optional[IvfCorpus] = None) -> dict:
    corpus = corpus or ivf_corpus(cfg, device)
    iv, b = corpus.iv, cfg.batch
    nprobe = min(cfg.nprobe, iv.n_clusters)
    retr, exact, torch_route = _ivf_retrievers(corpus, cfg)
    if not exact.use_kernel:
        raise AssertionError("the 2M exact route must take K1")
    if _ivf_coverage(b, nprobe, iv.n_clusters) > retr.ivf_max_coverage:
        raise AssertionError(f"B = {b} must take the IVF route")
    batches = [corpus.q[i * b:(i + 1) * b] for i in range(cfg.batches)]
    runs = [_dense_call(retr, qb) for qb in batches]
    r10 = recall_at_10(torch.cat([r[2][0] for r in runs]),
                       corpus.gold[:b * cfg.batches])
    if r10 < 0.90:
        raise AssertionError(f"2M IVF recall@10 {r10} below 0.90")
    q0 = batches[0]
    out = {
        "recall@10_2m_ivf": r10, "ivf_nprobe": nprobe,
        "ivf_clusters_2m": iv.n_clusters, "ivf_build_s_2m": corpus.build_s,
        "ivf_tile_fraction_2m": float(np.mean(
            [_tile_fraction(corpus, qb, nprobe) for qb in batches])),
        "ivf_list_swaps_2m": assert_ivf_parity(iv, q0, nprobe, cfg.k,
                                               runs[0][2][0]),
        "exact_list_swaps_2m_b8": _exact_parity(corpus, exact, torch_route,
                                                q0),
    }
    ivf_ms = _timed(out, "ivf_2m_b8_true_ms", lambda: timer.device_ms(
        lambda: _dense_call(retr, q0), cfg.n_loop), repeats)
    exact_ms = _timed(out, "exact_2m_b8_true_ms", lambda: timer.device_ms(
        lambda: _dense_call(exact, q0), cfg.n_loop), repeats)
    out["ivf_speedup_2m_b8"] = exact_ms / ivf_ms
    return out


def crossover_stage(device, repeats: int, timer: Timer,
                    cfg: IvfConfig = IvfConfig(),
                    corpus: Optional[IvfCorpus] = None) -> dict:
    """IVF (``ivf_route="always"``) against exact per batch size, timed
    in turns exact, IVF, IVF, exact; a repeat's time per route is the
    mean of its two samples, so a linear drift cancels. Also per B: the
    measured tile fraction, the analytic coverage the "auto" rule reads,
    recall@10, and both routes' id parity."""
    corpus = corpus or ivf_corpus(cfg, device)
    iv = corpus.iv
    nprobe = min(cfg.nprobe, iv.n_clusters)
    retr, exact, torch_route = _ivf_retrievers(corpus, cfg,
                                               ivf_route="always")
    rows: List[dict] = []
    for b in cfg.crossover_batches:
        n_check = max(2, min(16, corpus.q.shape[0] // b))
        checks = [corpus.q[t * b:(t + 1) * b] for t in range(n_check)]
        ids = torch.cat([_dense_call(retr, qb)[2][0] for qb in checks])
        r10 = recall_at_10(ids, corpus.gold[:n_check * b])
        q0 = checks[0]
        row = {
            "B": b, "recall10_ivf": r10,
            "tile_fraction": float(np.mean(
                [_tile_fraction(corpus, qb, nprobe) for qb in checks])),
            "coverage": _ivf_coverage(b, nprobe, iv.n_clusters),
            "ivf_list_swaps": assert_ivf_parity(
                iv, q0, nprobe, cfg.k, _dense_call(retr, q0)[2][0]),
            "exact_list_swaps": _exact_parity(corpus, exact, torch_route,
                                              q0),
        }
        pair: Dict[str, List[float]] = {"ivf": [], "exact": []}

        def one_repeat():
            t = {name: lambda r=r: timer.device_ms(
                lambda: _dense_call(r, q0), cfg.n_loop)
                for name, r in (("ivf", retr), ("exact", exact))}
            e1, i1, i2, e2 = t["exact"](), t["ivf"](), t["ivf"](), \
                t["exact"]()
            pair["ivf"].append((i1 + i2) / 2)
            pair["exact"].append((e1 + e2) / 2)

        for _ in range(repeats):
            one_repeat()
        for name, xs in pair.items():
            med = statistics.median(xs)
            row[name + "_ms"] = med
            row[name + "_ms_runs"] = {"min": min(xs), "median": med,
                                      "max": max(xs)}
        row["winner"] = "ivf" if row["ivf_ms"] < row["exact_ms"] else "exact"
        row["ivf_won_every_repeat"] = all(
            i < e for i, e in zip(pair["ivf"], pair["exact"]))
        row["auto_route"] = ("ivf" if row["coverage"]
                             <= retr.ivf_max_coverage else "exact")
        rows.append(row)
    wins = [r["B"] for r in rows if r["winner"] == "ivf"]
    return {"crossover_2m": rows, "ivf_max_coverage": retr.ivf_max_coverage,
            "ivf_wins_up_to_b": max(wins, default=0)}


# -- main -------------------------------------------------------------------


STAGES = ("headline", "2m", "int8", "ivf", "crossover")


def run_stages(device, repeats: int, timer: Timer,
               names: Sequence[str] = STAGES) -> dict:
    """The named stages in turn (the ivf and crossover stages share one
    corpus), each stage's seconds beside its keys."""
    shared: Dict[str, IvfCorpus] = {}

    def ivf_corpus_once() -> IvfCorpus:
        if "ivf" not in shared:
            shared["ivf"] = ivf_corpus(IvfConfig(), device)
        return shared["ivf"]

    stages = {
        "headline": lambda: headline_stage(device, repeats, timer),
        "2m": lambda: scale_2m_stage(device, repeats, timer),
        "int8": lambda: int8_stage(device, repeats, timer),
        "ivf": lambda: ivf_stage(device, repeats, timer,
                                 corpus=ivf_corpus_once()),
        "crossover": lambda: crossover_stage(device, repeats, timer,
                                             corpus=ivf_corpus_once()),
    }
    out: dict = {}
    for name in names:
        stage = stages[name]
        t0 = time.perf_counter()
        out.update(stage())
        out[f"stage_seconds_{name}"] = time.perf_counter() - t0
        print(f"bench: stage {name} done in "
              f"{out[f'stage_seconds_{name}']:.1f} s", file=sys.stderr,
              flush=True)
        _free()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5,
                    help="repeats R of every timed key (default 5)")
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated stages to run, in the bench's "
                         f"order (default all: {','.join(STAGES)})")
    args = ap.parse_args(argv)
    if args.repeats < 1:
        ap.error("repeats must be at least 1")
    names = args.stages.split(",")
    if not names or not set(names) <= set(STAGES):
        ap.error(f"--stages takes names from {','.join(STAGES)}")
    names = [n for n in STAGES if n in names]
    device = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build_kernels()
    out = {
        "metric": "hybrid_retrieval_qps_per_chip", "unit": "queries/s",
        "platform": "gpu", "device_kind": torch.cuda.get_device_name(device),
        "device_count": torch.cuda.device_count(), "card": card_line(),
        "repeats": args.repeats, "stages": names,
    }
    out.update(run_stages(device, args.repeats, cuda_timer(), names))
    out["bench_seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
