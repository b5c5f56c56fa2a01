"""The port's bench (a_nice_rag_tpu_torch.bench) rehearsed on the CPU.

The bench itself needs a GPU. Here each stage runs at a tiny size on CPU
tensors, where the kernel wrappers take their plain versions, with a
host-clock timer and the retriever's route to the kernels forced where
a stage asserts it. The headline stage's index and fused ids are held
against the JAX package's on the same ``synth_corpus``; the port's copy
of ``synth_corpus`` is held against the JAX package's byte for byte.
What the bench says about the card comes only from the card.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.retrieval.engine import FusedRetriever as JaxRetriever
from a_nice_rag_tpu.testing import synth_corpus as jax_synth_corpus
from a_nice_rag_tpu_torch import bench
from a_nice_rag_tpu_torch.retrieval import FusedRetriever
from a_nice_rag_tpu_torch.testing import synth_corpus
from a_nice_rag_tpu_torch.testing.parity import check_top_k

CPU = torch.device("cpu")
HEADLINE = bench.HeadlineConfig(n_docs=600, dim=2048, batch=64, vocab=20000,
                                iters=2, single_iters=2, p50_samples=3,
                                recall_queries=64)
SCALE_2M = bench.Scale2MConfig(n=4096, dim=32, batch=16, vocab=1024, n_loop=2)
INT8 = bench.Int8Config(n=8192, dim=1024, batch=16, clusters=512, chunks=4,
                        n_loop=2, tile_n=16, ivf_batches=8, ivf_loop=2)
IVF = bench.IvfConfig(n=16384, dim=32, centres=128, tile_n=128, nprobe=4,
                      batches=16, pool=512, n_loop=2,
                      crossover_batches=(1, 8, 64))


def _host_ms(fn, n):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


TIMER = bench.Timer(device_ms=_host_ms, host_ms=_host_ms)


@pytest.fixture
def kernel_route(monkeypatch):
    """The route a CUDA device takes at scale, forced on CPU tensors."""
    monkeypatch.setattr(
        FusedRetriever, "_route_kernel",
        classmethod(lambda cls, backend, n_pad, k, device: backend != "torch"),
    )


def _assert_timed(out, *keys):
    for key in keys:
        runs = out[key + "_runs"]
        assert runs["min"] <= runs["median"] <= runs["max"], key
        assert out[key] == runs["median"] and out[key] > 0, key


@pytest.mark.parametrize("seed", [0, 7])
def test_synth_corpus_matches_jax_byte_for_byte(seed):
    kw = dict(n_docs=300, dim=16, n_queries=40, vocab_size=500, seed=seed,
              model_noise={"voyage-3-large": 0.22}, query_token_noise=0.15,
              models=["voyage-3-large", "Qwen3"])
    got, want = synth_corpus(**kw), jax_synth_corpus(**kw)
    for field in ("ids", "sources", "contents", "urls", "tokens",
                  "query_tokens", "gold_ids"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("embeddings", "query_embeddings"):
        for m, arr in getattr(want, field).items():
            assert getattr(got, field)[m].tobytes() == arr.tobytes()


def test_headline_fused_ids_match_jax():
    c, index, retr, q, terms = bench.headline_setup(HEADLINE, CPU)
    jc = jax_synth_corpus(
        n_docs=HEADLINE.n_docs, dim=HEADLINE.dim, n_queries=HEADLINE.batch,
        vocab_size=HEADLINE.vocab, seed=HEADLINE.seed,
        model_noise={bench.MODEL: 0.22}, query_token_noise=0.15)
    jidx = jax_build_index(ids=jc.ids, sources=jc.sources,
                           contents=jc.contents, embeddings=jc.embeddings,
                           token_lists=jc.tokens)
    jterms = jidx.pad_term_ids(jc.query_tokens, HEADLINE.t_max)
    np.testing.assert_array_equal(terms.numpy(), jterms)
    jr = JaxRetriever(jidx, (bench.MODEL,), use_bm25=True, similarity_k=25,
                      common_sections_n=15, budget=retr.budget,
                      dense_backend="xla")
    w = {bench.MODEL: 5.0, "BM25": 1.0}
    jf, jv, jl = jr({bench.MODEL: jc.query_embeddings[bench.MODEL]}, jterms,
                    w, None, 40.0)
    jl = np.array(jl)
    tf, tv, tl = retr.retrieve_device({bench.MODEL: q}, terms, w, None, 40.0)
    emb = index.dense[bench.MODEL]
    swaps = check_top_k(bench.exact_dense(emb, q, torch.as_tensor(jl[0])),
                        jl[0], bench.exact_dense(emb, q, tl[0]), tl[0], 1e-5)
    impact = index.bm25_dense.impact
    swaps += check_top_k(
        bench.exact_bm25_dense(impact, terms, torch.as_tensor(jl[1])), jl[1],
        bench.exact_bm25_dense(impact, terms, tl[1]), tl[1], 1e-4)
    if swaps == 0:
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    check_top_k(np.asarray(jv), np.asarray(jf), tv, tf, 1e-6)


def test_headline_stage_keys_on_cpu():
    out = bench.headline_stage(CPU, 2, TIMER, HEADLINE)
    assert out["recall@10_planted"] >= max(out["recall@10_dense_only"],
                                           out["recall@10_bm25_only"])
    assert out["recall@10_planted"] >= 0.90
    assert out["headline_fused_ids_equal_torch_route"]
    assert not out["kernel_route_headline"]
    _assert_timed(out, "value", "qps_host_sync", "p50_latency_ms",
                  "p50_device_ms", "p50_device_true_ms",
                  "batch_headline_true_ms")


def test_scale_2m_stage_keys_on_cpu(kernel_route):
    out = bench.scale_2m_stage(CPU, 2, TIMER, SCALE_2M)
    assert out["recall@10_2m_hybrid"] >= 0.99
    assert out["kernel_route_2m"] and out["list_swaps_2m"] == 0
    _assert_timed(out, "qps_2m", "batch_2m_true_ms", "stream_2m_ms",
                  "batch_2m_true_packed_ms")
    assert out["recall@10_2m_packed"] >= 0.99
    for key in ("stream_gb_s_2m", "fused_gb_s_2m", "pct_of_floor_2m",
                "qps_2m_true", "batch_2m_ms", "qps_2m_true_packed"):
        assert out[key] > 0, key


def test_int8_stage_keys_on_cpu(kernel_route):
    out = bench.int8_stage(CPU, 2, TIMER, INT8)
    assert out["recall@10_10m_int8"] >= 0.95
    assert out["recall@10_10m_int8_ivf"] >= 0.95
    _assert_timed(out, "qps_10m_int8", "batch_10m_int8_true_ms",
                  "stream_10m_ms", "ivf_10m_int8_b8_true_ms",
                  "exact_10m_int8_b8_true_ms")
    for key in ("stream_gb_s_10m", "pct_of_floor_10m", "fused_gb_s_10m_int8",
                "ivf_speedup_10m_int8_b8", "batch_10m_int8_ms"):
        assert out[key] > 0, key


def test_ivf_and_crossover_stages_on_cpu(kernel_route):
    corpus = bench.ivf_corpus(IVF, CPU)
    out = bench.ivf_stage(CPU, 2, TIMER, IVF, corpus)
    assert out["recall@10_2m_ivf"] >= 0.90
    assert 0 < out["ivf_tile_fraction_2m"] < 1
    _assert_timed(out, "ivf_2m_b8_true_ms", "exact_2m_b8_true_ms")
    cross = bench.crossover_stage(CPU, 2, TIMER, IVF, corpus)
    rows = cross["crossover_2m"]
    assert [r["B"] for r in rows] == [1, 8, 64]
    fractions = [r["tile_fraction"] for r in rows]
    assert fractions == sorted(fractions)
    assert [r["auto_route"] for r in rows] == ["ivf", "ivf", "exact"]
    for r in rows:
        assert r["recall10_ivf"] >= 0.90
        for route in ("ivf", "exact"):
            runs = r[route + "_ms_runs"]
            assert runs["min"] <= r[route + "_ms"] <= runs["max"]
    assert cross["ivf_max_coverage"] == 0.25


def test_served_stage_on_cpu():
    """The served stage end to end on CPU tensors at a tiny size: every
    front answers every request in full and the int8 wire's overlap
    holds. Its QPS floor is the card's, so the rehearsal sets its own;
    a floor the run misses raises."""
    cfg = bench.ServedConfig(n_docs=600, batch=32, clients=2, rounds=2,
                             per=2, max_batch=64, qps_floor=1.0)
    out = bench.served_stage(CPU, 1, TIMER, cfg)
    assert out["served_kernel_route"] is False
    for name in ("served_http", "served_native_f32", "served_native_bf16",
                 "served_native_int8"):
        r = out[name]
        assert r["requests"] == 2 * 2 * 2 and r["rows"] == 32
        assert r["qps_min"] <= r["qps_median"] <= r["qps_max"]
        assert 0 < r["p50_batch_ms"] <= r["p99_batch_ms"]
        assert 1 <= r["mean_device_batch"] <= 64
    assert out["served_native_int8_overlap10_vs_f32"] >= 0.97
    with pytest.raises(AssertionError, match="QPS median"):
        bench.served_stage(CPU, 1, TIMER, dataclasses.replace(
            cfg, rounds=1, qps_floor=1e12))


def test_drive_front_raises_on_a_failed_client():
    class Broken:
        def __enter__(self):
            def send():
                raise ConnectionError("front gone")
            return send

        def __exit__(self, *exc):
            pass

    with pytest.raises(ConnectionError, match="front gone"):
        bench.drive_front(Broken, clients=2, rounds=1, per=1, rows=4)


def test_bench_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        bench.cuda_timer()
    for timer in (bench.device_loop_ms, bench.chained_ms):
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            timer(lambda: None)


def test_bench_refuses_unknown_stages():
    with pytest.raises(SystemExit):
        bench.main(["--stages", "2m,nope"])
    assert bench.STAGES == ("headline", "2m", "int8", "ivf", "crossover",
                            "served", "gen")


def test_stage_configs_default_to_bench_widths():
    assert (bench.HeadlineConfig().n_docs, bench.HeadlineConfig().dim,
            bench.HeadlineConfig().batch) == (9728, 2048, 2048)
    assert (bench.Scale2MConfig().n, bench.Scale2MConfig().dim) == (1 << 21,
                                                                     256)
    assert (bench.Int8Config().n, bench.Int8Config().dim) == (10_485_760,
                                                              1024)
    assert dataclasses.astuple(bench.IvfConfig())[:6] == (
        1 << 21, 256, 2048, 1024, 16, 16)
    assert bench.IvfConfig().crossover_batches == (1, 2, 4, 8, 16, 32, 64,
                                                   128, 256)
    # bench.py:840-868: the headline corpus, 8 clients of 512-row frames,
    # floors 1500 QPS; 8 x 5 x 5 = 200 requests a front.
    served = bench.ServedConfig()
    assert (served.n_docs, served.dim, served.batch, served.clients,
            served.qps_floor) == (9728, 2048, 512, 8, 1500.0)
    assert served.clients * served.rounds * served.per >= 200


def test_gen_stage_on_cpu():
    """The gen stage end to end on CPU tensors at a tiny width: the JAX
    bench's keys (gen_serving_metrics), its floor asserted, the TTFT and
    tick timings on the host clock, the card-only keys None; the floor
    raises when missed."""
    cfg = bench.GenConfig(vocab=259, hidden=64, layers=2, heads=4,
                          kv_heads=2, head_dim=16, mlp=128,
                          dtype=torch.float32, max_len=64, n_new=24,
                          prompt=8, stream_chunk=8, slots=8, chunk=4,
                          requests=8, ttft_requests=2, ticks=2, floor=0.0)
    def profile(fn):
        fn()
        return [{"kernel": "a", "ms": 0.75, "launches": 5.0},
                {"kernel": "b", "ms": 0.25, "launches": 2.0}]

    out = bench.gen_stage(CPU, 1, TIMER, cfg, profile=profile)
    for key in ("gen_stream_tok_s", "gen_batched_tok_s",
                "gen_batched_vs_stream", "gen_ttft_p50_ms",
                "gen_tick_host_ms", "gen_step_bound_ms"):
        assert out[key] > 0, key
    assert out["gen_model"] == "qwen3-0.6B-arch-2L-64h-float32"
    assert (out["gen_slots"], out["gen_chunk"], out["gen_requests"]) == (
        8, 4, 8)
    assert out["gen_tick_launches"] == 7.0
    assert out["gen_tick_device_busy_ms"] == 1.0
    assert [k["kernel"] for k in out["gen_tick_top_kernels"]] == ["a", "b"]
    assert out["gen_tick_event_ms"] is None and out["gen_wave_peak_gib"] \
        is None and out["gen_tick_idle_share"] is None
    assert out["gen_tick_bound_ms"] == 4 * out["gen_step_bound_ms"]
    with pytest.raises(AssertionError, match="continuous batching"):
        bench.gen_stage(CPU, 1, TIMER, dataclasses.replace(cfg, floor=1e9))


def test_gen_config_defaults_to_the_jax_bench():
    """bench.py:741-787: Qwen3-0.6B's widths, 64 slots, chunk 16, 64
    requests of 160 tokens after a 64-id prompt, max_len 256; stream
    chunk 32; floor 2.5."""
    g = bench.GenConfig()
    assert (g.vocab, g.hidden, g.layers, g.heads, g.kv_heads, g.head_dim,
            g.mlp) == (151_936, 1024, 28, 16, 8, 128, 3072)
    assert g.dtype == torch.bfloat16
    assert (g.slots, g.chunk, g.requests, g.n_new, g.prompt, g.max_len,
            g.stream_chunk, g.floor) == (64, 16, 64, 160, 64, 256, 32, 2.5)
