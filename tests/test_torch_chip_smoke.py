"""chip_smoke.py's phases, rehearsed on the CPU at tiny sizes.

The smoke run itself needs a GPU. Here its phases run on CPU tensors,
where the kernel wrappers take their plain versions, with four fakes:
each plain-version call through a wrapper counts as a launch (and the
sources' shared-memory sums are topk_plan's), the
retriever's route to the kernels is forced at the stages' sizes (stage
F's reference-scale corpus stays below it, as on the card), CUDA
synchronisation is a no-op, and the CUDA timers are a host clock. The
tiny stage D and E sizes keep the IVF coverage rule's routes (IVF at
B = 8, exact at B = 256). This keeps the script's control flow, shapes and checks working
between chip runs; what it says about the kernels themselves comes only
from the card.
"""

import json
import statistics
import time

import pytest
import torch

import chip_smoke
from a_nice_rag_tpu_torch.ops.kernels import anatomy as an
from a_nice_rag_tpu_torch.ops.kernels import fused_topk as ft
from a_nice_rag_tpu_torch.ops.kernels import int4 as i4
from a_nice_rag_tpu_torch.ops.kernels import ivf_topk as it
from a_nice_rag_tpu_torch.ops.kernels import keys as ks
from a_nice_rag_tpu_torch.ops.kernels import stream as st
from a_nice_rag_tpu_torch.ops.kernels import topk_plan
from a_nice_rag_tpu_torch.ops.kernels._launches import count_launch
from a_nice_rag_tpu_torch.probes import bf16_fold

WRAPPED = ((ft, "fused_dense_top_k"), (ft, "fused_dense_top_k_int8"),
           (it, "ivf_dense_top_k"), (it, "ivf_dense_top_k_int8"),
           (st, "stream_sum"), (st, "stream_sum_busy"),
           (an, "anatomy_top_k"), (an, "anatomy_top_k_int8"),
           (an, "fused_top_k_counted"), (an, "fused_top_k_counted_int8"),
           (ks, "xpack_keys"), (ks, "xpack_values"),
           (ks, "bf16_row_reduce"), (i4, "int4_scores"),
           (i4, "int8_fold_max"), (i4, "int4_fold_max"))


class TinySmoke(chip_smoke.Smoke):
    N_KERNEL, D_KERNEL = 3000 + 37, 32
    N_EDGE, EDGE_D, EDGE_TILE = 3000 + 37, (1, 33, 37, 64), 256
    EDGE_FLOAT_D = (1, 33, 37, 64)
    IVF_TILES = (128, 256)
    N_A, D_A, B, T, V, DF = 4096, 32, 16, 16, 1024, 16
    # 512 clusters of 16 rows: nprobe 8 covers 0.12 of them at B = 8.
    N_C, D_C, CLUSTERS, CHUNKS = 8192, 1024, 512, 4
    # 128 k-means clusters, nprobe 4: coverage 0.22 at B = 8.
    N_D, D_D, CENTRES_D, TILE_D, NPROBE_D, K_D, V_D = (
        16384, 32, 128, 128, 4, 16, 8192)
    BATCHES_D = 64
    # Phase 19: 64 k-means clusters in each of 4 shards of 4096 rows,
    # nprobe 2: coverage 0.22 at B = 8.
    NPROBE_SHARDED = 2
    TILE_E, NPROBE_E, K_E, BATCHES_E = 16, 8, 25, 32
    STREAM_ROWS, STREAM_D, EXACT_ROWS = 1003, 16, 4096
    HEADLINE = dict(n_docs=600, dim=2048, batch=64, vocab=20000, iters=2,
                    single_iters=2, p50_samples=3, recall_queries=64)
    INT4_N, BF16_SHAPES, KEY_NORMALS = 4096, ((8, 512), (16, 1024)), 4096
    BF16_EDGE_SHAPES = ((1, 1), (7, 3), (4, 1025))
    FOLD_EDGE_N, FOLD_EDGE_D, FOLD_EDGE_B = (100, 301), (8, 40, 1024), (1, 65)
    # Phase 18: the calibrated corpus at a tiny size (its expected rows
    # come from the JAX package's evaluator, see _sweep_csv); the CPU
    # profile holds operator events, no CUDA kernels.
    SWEEP = dict(n_docs=300, dim=16, n_queries=64, vocab_size=500, seed=42)
    RAG_QUERIES, TUNE_CALLS, TRACE_EVENTS = 4, 2, "cpu_op"
    # Phase 20: 2 clients x 2 rounds x 2 frames of B = 16 rows a front.
    SERVED_CLIENTS, SERVED_ROUNDS, SERVED_PER, SERVED_LATENCY = 2, 2, 2, 4
    # The limit is the card host's; here the workers share the CPU, so the
    # rehearsal checks the record and test_served_latency_limit the check.
    SERVED_LIMITS_MS = {"p50_ms": float("inf"), "p99_ms": float("inf")}
    # Phase 21: a Qwen3 of the same shape rules (GQA 4:2, head_dim 16
    # decoupled from 64 / 4), 8 rows of 16 ids, an index past the forced
    # kernel route's 1024 rows, 32 pairs.
    QWEN3 = dict(vocab_size=512, hidden_size=64, num_layers=3, num_heads=4,
                 num_kv_heads=2, head_dim=16, intermediate_size=128,
                 rope_theta=1_000_000.0, rms_eps=1e-6)
    QWEN3_B, QWEN3_S, N_MODELS, MODEL_PAIRS = 8, 16, 4096, 32
    # Phase 22: a decoder of the same shape rules (GQA 4:2, head_dim 16
    # decoupled from 64 / 4, tied embeddings; bf16 as on the card), 8 slots
    # of 96 rows, chunk 4; the ratio floor is the card's, so the rehearsal
    # sets none. The cut's EOS sits inside the 512-token vocab.
    GEN = dict(vocab=512, hidden=64, layers=3, heads=4, kv_heads=2,
               head_dim=16, mlp=128, max_len=96, n_new=24, prompt=8,
               stream_chunk=8, slots=8, chunk=4, requests=8,
               ttft_requests=2, ticks=2, floor=0.0)
    GEN_PROMPT_LEN, GEN_EOS = 16, 300
    # Phase 23: tp 2 (the tiny decoder's 2 kv heads); the served encoder's
    # layers at stage A's tiny width, trained on 64 pairs over a pool of
    # 150 words, 8 rows a batch, 16 steps; the pair trainers on a small
    # calibrated corpus with no holdout floor (the floors are the card's
    # sizes'); 12 rows a parallel batch. The encoder computes in float32
    # here: the CPU's bf16 matrix products round row blocks of another
    # height (a pipeline microbatch's) differently, which the card's
    # float32-accumulating ones do not, so float32 holds the parallel
    # steps to the card's tolerances.
    TP_DEGREES, TP_NEW = (2,), 8
    TRAIN = dict(out_dim=32, dtype=torch.float32)
    TRAIN_PAIRS, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_EVERY = 64, 8, 2, 4
    TRAIN_WORDS, TRAIN_CPU_ROWS = 150, 4
    RERANK_CORPUS = dict(n_docs=128, dim=16, n_queries=32, vocab_size=500,
                         seed=42)
    RERANK_QUERIES, RERANK_EPOCHS, RERANK_FLOOR = 96, 4, 0.0
    NLI_PAIRS, NLI_EPOCHS, NLI_AUC_FLOOR = 96, 3, 0.0
    PAR_BATCH = 12
    # Phase 24: the judges' caps at (4 bytes, 1 item), 110-byte documents,
    # 4 slots, 2 chunks, short constrained questions and answers; a small
    # calibrated corpus and a one-epoch NLI scorer with no floors (the
    # floors are the card's sizes').
    EVAL_SMALL_CAPS, EVAL_CAPS = (4, 1), (4, 1)
    EVAL_CHUNK_BYTES, EVAL_SLOTS, EVAL_DECODE_CHUNK = 110, 4, 4
    EVAL_CHUNKS, EVAL_QUESTION_CHARS, EVAL_ANSWER_CHARS = 2, 16, 24
    DISCRIM_CORPUS = dict(n_docs=128, dim=16, n_queries=8, vocab_size=500,
                          seed=42)
    DISCRIM_ENCODER = dict(n_layers=1, dim=32, n_heads=2, max_len=128)
    DISCRIM_NLI = dict(n_pairs=64, seed=0, epochs=1, batch_size=32)
    DISCRIM_FLOORS = (0.0, 1.0)


def _sweep_csv(path):
    """The JAX package's sweep of TinySmoke's corpus: rows 1-7 of the
    file phase 18 holds its rows against."""
    from a_nice_rag_tpu.evals.retrieval_eval import (
        STANDARD_CONFIGURATIONS,
        RetrievalEvaluator,
        seed42_split,
    )
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.testing import (
        add_hard_distractors,
        calibrated_quality_corpus,
    )

    c = add_hard_distractors(calibrated_quality_corpus(**TinySmoke.SWEEP),
                             **TinySmoke.SWEEP_DISTRACTORS)
    idx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                      embeddings=c.embeddings, token_lists=c.tokens)
    ev, _ = seed42_split(len(c.gold_ids))
    RetrievalEvaluator(idx).run(
        [x for x in STANDARD_CONFIGURATIONS if not x.use_reranker],
        {m: v[ev] for m, v in c.query_embeddings.items()},
        [c.gold_ids[i] for i in ev],
        query_token_lists=[c.query_tokens[i] for i in ev],
        filename_type_filter=None, output_csv=str(path))
    return path


def _host_ms(fn, n=3, warmup=1):
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def test_chip_smoke_phases_on_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(TinySmoke, "SWEEP_CSV",
                        _sweep_csv(tmp_path / "sweep.csv"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 1)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for mod, name in WRAPPED:
        wrapper, plain = getattr(mod, name), getattr(mod, name + "_torch")
        # Restored at teardown, so no other test sees these launches.
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)

        def counted(*args, _wrapper=wrapper, _plain=plain, **kwargs):
            count_launch(_wrapper)
            return _plain(*args, **kwargs)

        monkeypatch.setattr(mod, name + "_torch", counted)
    port = chip_smoke._Port()
    monkeypatch.setattr(port.bench, "card_line", lambda: "cpu, n/a")
    port.require_cuda = lambda: torch.device("cpu")
    port.cuda_event_ms = _host_ms
    port.device_loop_ms = lambda fn, n_loop, trials: _host_ms(fn, n_loop)
    port.chained_ms = lambda fn, n, trials: _host_ms(fn, n)
    port.profiled_kernel_ms = lambda fn, kernel, n: _host_ms(fn, n)
    # No CUDA kernel to trace on the CPU.
    port.profiled_device_ms = lambda fn, n: (0.0, 0.0)
    port.profiled_top_kernels = lambda fn: []
    monkeypatch.setattr(port.bench, "gen_profile", lambda fn: [])
    port.sm_grid = lambda device, ctas_per_sm=4: 8
    port.int8_smem_bytes = topk_plan.smem_bytes
    port.float_smem_bytes = topk_plan.smem_bytes
    port.fold_smem_bytes = i4.fold_smem_bytes
    port.fold_active_clusters = lambda index, cl, smem: 132 // cl
    # The folds' stream alone runs only on the card.
    monkeypatch.setattr(i4, "fold_stream", lambda q8, rows, packed: None)
    monkeypatch.setattr(port.kernels, "build_kernels", lambda: None)
    monkeypatch.setattr(
        port.FusedRetriever, "_route_kernel",
        classmethod(lambda cls, backend, n_pad, k, device:
                    backend != "torch" and n_pad >= 1024),
    )

    TinySmoke(port).run()

    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 1}
    }
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kernels] == [name for _, name in WRAPPED]
    # K1: stage A 3 calls x 1 dense list, stage B dense + common tier,
    # stage D B = 256 and filtered; phase 19 on 4 slots: (a) the merge, B =
    # 256 and B = 8 (4 each), (b) dense + common tier (8), (e) 3 survivors,
    # dp = 1 and dp = 2 over 2 slots a group (3 + 2 + 4), (f) 4 RAG queries
    # (16). K2: stages C and E at B = 256, phase 19 (c) retriever and merge
    # (8). K3: 64 micro-batches + the full probe, phase 19 (d) 64 x 4 + 4.
    # K4: 32 micro-batches, phase 19 (d) 64 x 4. Stage F: none. The probes'
    # calls of K1/K2 stay out of these counts. The stream kernels and the
    # probes' own: counts of the host timer's calls.
    records = [json.loads(line) for line in lines if line.startswith("{")]
    served = {r["served"]: r for r in records if "served" in r}
    summary20 = [r for r in records if r.get("phase") == "served"][0]
    # Phase 20's K1 launches: its fronts' (a batch a launch; how frames
    # coalesce varies from run to run), its latency runs' and their
    # layers' (a call a launch), the exact route
    # at B = 8 (64 frames), and the sharded part's 4 + 3; its K3: the 64
    # frames of the IVF route.
    k1_served = (sum(f["k1_launches"] for f in summary20["fronts"].values())
                 + sum(summary20["latency"][x]["k1_launches"]
                       for x in ("json_b1", "b64_b8"))
                 + sum(x["k1_launches"]
                       for x in summary20["latency_layers"].values())
                 + summary20["latency"]["exact_b8"]["launches"] + 4 + 3)
    # Phase 21's: (a) one hybrid call on the Qwen3 vectors, (b) the
    # served text requests' device batches (a batch a launch).
    summary21 = [r for r in records if r.get("phase") == "models"][0]
    models = {r["inference"]: r for r in records if "inference" in r}
    k1_models = summary21["k1_launches"]
    assert k1_models == 1 + models["B_served_text"]["k1_launches"]
    # Phase 23's: (c) the served checkpoint's text requests (a batch a
    # launch).
    summary23 = [r for r in records if r.get("phase") == "training"][0]
    assert summary23["k1_launches"] == summary23["parts"]["C"][
        "k1_launches"] >= 1
    assert [k["launches"] for k in kernels][:4] == [
        52 + k1_served + k1_models + summary23["k1_launches"], 10,
        325 + 64, 288]
    assert all(k["launches"] >= 1 for k in kernels[4:])
    no_library = {"stream_sum_busy", "fused_top_k_counted",
                  "fused_top_k_counted_int8", "xpack_keys", "xpack_values",
                  "bf16_row_reduce", "int4_scores", "int4_fold_max"}
    for k in kernels:
        assert k["bound_by"] in ("bytes", "operations")
        assert k["route"] == "cuda" and k["source"].endswith(".cu")
        for key in ("ms", "plain_ms", "bound_ms"):
            assert k[key] > 0, (k["name"], key)
        assert k["library_ms"] is None if k["name"] in no_library \
            else k["library_ms"] > 0
        assert k["max_abs_err"] >= 0.0
    assert kernels[4]["replaces"] == "bench.py:226"
    assert kernels[6]["replaces"] == "scripts/profile_kernel_anatomy.py:138"
    probes = [r for r in records if r.get("phase") == "probes_vs_plain"]
    assert probes[0]["counted_equal_plain_and_kernel"]
    anatomy = [r for r in records if "anatomy" in r]
    assert [a["anatomy"] for a in anatomy] == ["A", "C"]
    for a in anatomy:
        assert set(a["ms"]) == {"stage", "score", "compare", "full"}
        assert a["seconds"] > 0 and a["modes_equal_plain"]
        # The "full" mode's K1/K2: a warm-up and 5 timed calls.
        assert a["full_mode_launches"] == 6
    counted = [r for r in records if "counted" in r]
    assert [c["counted"] for c in counted] == ["A", "C"]
    for c in counted:
        assert c["ids_equal_kernel"] and c["tau"] == [False, True]
        assert c["equal_plain"]
        # K1/K2 as the reference; tau comes from their own tau pass,
        # which counts no launch of its own.
        assert c["reference_launches"] == 1
        # The warm start can only remove insertions.
        assert c["insertions_per_row"][1] <= c["insertions_per_row"][0]
        assert 0 < c["fired_share"][0] <= 1
    keys = [r for r in records if r.get("probe") == "keys"]
    assert keys[0]["bit_equal_plain"] and keys[0]["special_values"] == 13
    assert [f["packed_argmax_agreement"] for f in keys[0]["bf16_fold"]] \
        == [1.0, 1.0]
    p6 = [r for r in records if r.get("probe") == "bf16_row_reduce_edges"]
    # 3 shapes x 7 kinds x 3 storage offsets.
    assert p6[0]["outputs_equal_plain"] and p6[0]["cases"] == 3 * 7 * 3
    p6t = [r for r in records if r.get("timing") == "bf16_row_reduce_shapes"]
    assert [s["shape"] for s in p6t[0]["shapes"]] == [[8, 512], [16, 1024]]
    for s in p6t[0]["shapes"]:
        for key in ("event_ms", "event_cold_ms", "device_ms", "kernel_ms",
                    "kernel_cold_ms", "host_ms", "plain_event_ms",
                    "bound_ms"):
            assert s[key] > 0, key
        # Copies of the input fill twice the L2 for the cold timings.
        assert s["cold_copies"] * s["shape"][0] * s["shape"][1] * 4 \
            > 2 * bf16_fold.L2_BYTES
    # 512 and 1024 columns: a CTA of 256 threads a row.
    assert [s["plan"] for s in p6t[0]["shapes"]] == [
        {"threads_per_row": 256}] * 2
    assert p6t[0]["predicted_event_ms"] == [0.010, 0.020]
    int4 = [r for r in records if str(r.get("probe")).startswith("int4")]
    assert [i["probe"] for i in int4] == ["int4_exact", "int4_edges",
                                          "int4_anatomy", "int4_stage2"]
    assert int4[0]["exact"] and int4[3]["exact_full_size"]
    assert [r["rows"] for r in int4[2]["lines"]] == [
        "int8", "int4 mask", "int4 shift"]
    # 3 depths x 2 batches x 3 views.
    assert int4[1]["exact"] and int4[1]["cases"] == 18
    fold = [r for r in records if r.get("phase") == "fold_plan"]
    # Stage C's B = 16 is one query block; 4096 rows are 16 tiles.
    assert [(f["cluster"], f["tma"], f["resident"]) for f in
            fold[0]["shapes"]] == [(1, True, True), (1, True, True),
                                   (2, True, True), (4, True, True),
                                   (1, False, True)]
    assert all(f["smem_bytes"] <= 232_448 for f in fold[0]["shapes"])
    se = [r for r in records if r.get("stage") == "A_search_engine"]
    assert se[0]["recall10_planted"] >= 0.99 and se[0]["kernel_launches"] == 0
    assert se[0]["dense_lists_vs_k1_swaps"] >= 0
    assert set(se[0]["host_ms"]) == {"search_engine_retrieve",
                                     "fused_retrieve_device"}
    assert all(v > 0 for v in se[0]["host_ms"].values())
    ref = {r["reference"]: r for r in records if "reference" in r}
    assert list(ref) == ["corpus", "sweep", "replay", "tune_bm25",
                         "evaluator_stage_A", "rag_stage_A"]
    # 300 docs + 2 distractors for each evaluated gold with tokens.
    assert ref["corpus"]["docs"] > 300 and ref["corpus"]["evaluated"] == 54
    sweep = ref["sweep"]
    assert len(sweep["rows"]) == 7 and sweep["rows_equal_csv"] == 7
    assert sweep["rows"] == (tmp_path / "sweep.csv").read_text(
        ).splitlines()[1:]
    assert set(sweep["config_seconds"]) == {
        row.split(",")[0] for row in sweep["rows"]}
    assert sweep["dense_vs_float64_max_err"] <= 1e-5
    replay = ref["replay"]
    assert replay["n_q"] == 54 and len(replay["rows"]) == 7
    assert replay["rows_equal_cpu"] == 7 and replay["manager_same_object"]
    assert replay["import_seconds"] > 0
    assert len(replay["config_seconds"]) == 7
    assert ref["tune_bm25"]["calls"] == 2
    assert ref["tune_bm25"]["history_equal_cpu"]
    ev = ref["evaluator_stage_A"]["configs"]
    assert list(ev) == ["Voyage-3-Large", "BM25", "Voyage-3-Large + BM25"]
    assert ev["Voyage-3-Large + BM25"]["recall10"] >= 0.99
    assert all(c["seconds"] > 0 and c["peak_gib"] > 0 for c in ev.values())
    rag = ref["rag_stage_A"]
    assert rag["queries"] == rag["gold_in_sources"] == 4
    assert rag["retrieval_span_median_ms"] > 0
    assert rag["profiled_query_kernel_events"] > 0
    phase18 = [r for r in records if r.get("phase") == "reference_path"]
    assert phase18[0]["seconds"] > 0
    stage_c = [r for r in records if r.get("stage") == "C_10.5M_int8"]
    assert stage_c[0]["search_engine_b8_vs_k2_swaps"] >= 0
    assert stage_c[0]["search_engine_b8_atol"] == chip_smoke.INT8_ATOL
    stage_f = [json.loads(line) for line in lines if '"F_headline"' in line]
    assert len(stage_f) == 1
    assert stage_f[0]["recall@10_planted"] >= 0.90
    assert stage_f[0]["headline_fused_ids_equal_torch_route"]
    floors = [json.loads(line) for line in lines if '"floor"' in line]
    assert [f["floor"] for f in floors] == ["A", "C"]
    assert all(f["pct_of_floor"] > 0 for f in floors)
    overlap = [json.loads(line) for line in lines if '"dma_overlap"' in line]
    assert overlap[0]["x_iters"] == [0, 8, 64]
    k2 = [r for r in records if r.get("phase") == "k2_vs_plain"]
    # 4 depths x 3 views x 6 batches x 3 k.
    assert k2[0]["edge_cases"] == 216 and k2[0]["edge_b"][2] == 17
    k4 = [r for r in records if r.get("phase") == "k3_k4_vs_plain"]
    assert k4[0]["k4_edge_cases"] == 4 * 2 * 3 * 6
    plan = [r for r in records if r.get("phase") == "int8_plan"]
    # The tiny B is 16: every block is the small one.
    assert [s["bq"] for s in plan[0]["shapes"]] == [16, 16, 16]
    assert all(s["ctas_per_sm"] >= 1 for s in plan[0]["shapes"])
    fplan = [r for r in records if r.get("phase") == "float_plan"]
    # B = 16 and B = 8: the small block; every tiny depth stays resident.
    assert [s["bq"] for s in fplan[0]["shapes"]] == [16] * 5
    assert all(s["resident"] and s["smem_bytes"] > 0
               for s in fplan[0]["shapes"])
    edges = [r for r in records if r.get("phase") == "float_edges_vs_plain"]
    # 2 row types x 4 depths x (3 views x 7 batches for K1, 2 views x 3
    # tables x 7 batches for K3); both kinds of tau among K1's cases.
    assert edges[0]["k1_cases"] == 2 * 4 * 3 * 7
    assert edges[0]["k3_cases"] == 2 * 4 * 2 * 3 * 7
    assert edges[0]["tau_cases"]["finite"] > 0
    assert edges[0]["tau_cases"]["neg_inf"] > 0
    stream = [json.loads(line) for line in lines
              if '"stream_vs_plain"' in line]
    # + 4 CTA counts x 4 unrolls, each called twice.
    assert stream[0]["cases"] == 27 + 16 and stream[0]["int8_exact"]
    assert stream[0]["two_calls_bit_equal"]
    crossover = [json.loads(line) for line in lines if '"crossover"' in line]
    assert [(c["crossover"], c["B"]) for c in crossover] == [
        ("D_2M_bf16", 8), ("D_2M_bf16", 16), ("D_2M_bf16", 32),
        ("D_2M_bf16", 64), ("E_10.5M_int8", 8)]
    sharded = {r["sharded"]: r for r in records if "sharded" in r}
    assert list(sharded) == ["A", "B", "E_recovery", "F_rag", "D_ivf", "C"]
    a = sharded["A"]
    assert a["n_local"] == 1024 and a["k1_launches_per_call"] == 4
    assert a["dense_ids_equal_k1"] and a["recall10_hybrid"] >= 0.99
    assert a["dense_max_abs_err"] <= chip_smoke.F32_ATOL
    for key in ("vs_unsharded", "b8_vs_torch_route"):
        assert a[key]["list_swaps"] >= 0
    assert a["merge_shape"] == [16, 4, 32]
    assert set(a["parts_ms"]) == {"k1_whole", "k1_each_shard",
                                  "dense_only_sharded",
                                  "dense_only_unsharded"}
    assert set(sharded["C"]["parts_ms"]) == {"k2_whole", "k2_each_shard"}
    for prof in a["profile"].values():  # no CUDA kernels on the CPU
        assert prof["device_ms"] == 0 and prof["kernel_launches"] == 0
        assert prof["idle_share"] == 1.0
        assert prof["enqueue_ms"] > 0 and prof["event_ms"] > 0
    for key in ("retrieve_ms", "unsharded_retrieve_ms", "merge_ms",
                "shard_index_s"):
        assert a[key] > 0, key
    assert sharded["B"]["k1_launches_per_call"] == 8
    e = sharded["E_recovery"]
    assert e["dead_slot"] == 2 and e["survivors"] == 3
    assert e["events"][-1]["recovered"] and e["events"][-1]["n_shards"] == 3
    assert e["k1_launches_per_call"] == 3 and e["dp2_ids_equal_dp1"]
    f = sharded["F_rag"]
    assert f["queries"] == f["gold_in_sources"] == 4
    assert f["k1_launches"] == 16
    d = sharded["D_ivf"]
    assert d["clusters_per_shard"] == 64 and d["nprobe"] == 2
    assert d["k3_launches"] == d["k4_launches"] == 64 * 4
    assert d["recall10_b8"] >= 0.90 and d["recall10_int8_b8"] >= 0.90
    assert d["full_probe_ids_equal_exact"] and d["saved_loaded_ids_equal"]
    cc = sharded["C"]
    assert cc["shards_are_views"] and cc["k2_launches_per_call"] == 4
    assert cc["recall10"] >= 0.95 and cc["shard_lists_equal_plain_b8"]
    summary = [r for r in records if r.get("phase") == "sharded"][0]
    assert list(summary["parts"]) == ["A", "B", "E", "F", "D", "C"]
    assert all(v["seconds"] > 0 for v in summary["parts"].values())
    assert set(summary["shard_seconds"]) == {"A", "B", "C", "D_ivf"}
    assert set(summary["retrieve_ms"]) == {"A_sharded", "A_unsharded",
                                           "C_sharded", "C_unsharded"}
    assert lines[0] == "cpu, n/a"
    assert list(served) == ["A_plan", "A_latency", "A_native_int8",
                            "C_sharded_swap", "D_rag_surface", "B_ivf_b8"]
    assert served["A_plan"]["k1_equal_default_plan_at_b"] == [1, 8, 16, 32]
    assert set(served["A_plan"]["k1_ms"]) == {
        "tuned_b16", "default_b16", "tuned_b32", "default_b32"}
    assert all(v > 0 for v in served["A_plan"]["k1_ms"].values())
    assert served["A_native_int8"]["recall10_min"] >= 0.99
    assert 0 < served["A_native_int8"]["overlap10_vs_f32"] <= 1
    fronts = summary20["fronts"]
    assert list(fronts) == ["http_b64_f32", "http_b64_bf16", "native_f32",
                            "native_bf16", "native_int8"]
    for f in fronts.values():
        # 2 clients x 2 rounds x 2 frames of 16 rows.
        assert f["requests"] == 8 and f["rows"] == 16
        assert f["qps_min"] <= f["qps_median"] <= f["qps_max"]
        assert f["k1_launches"] >= f["device_batches"] >= 1
        assert 1 <= f["mean_device_batch"] <= 32
        assert 0 < f["p50_batch_ms"] <= f["p99_batch_ms"]
    lat = summary20["latency"]
    for name in ("json_b1", "b64_b8"):
        assert lat[name]["requests"] == 4 and lat[name]["p50_ms"] > 0
    assert served["A_latency"]["limits_ms"] == TinySmoke.SERVED_LIMITS_MS
    assert lat["json_b1"]["mean_device_batch"] == 1
    layers = summary20["latency_layers"]
    assert list(layers) == ["direct_b1", "pool_b1", "direct_b8", "pool_b8"]
    for name, x in layers.items():
        assert x["requests"] == 4 and x["k1_launches"] >= 4
        assert 0 < x["p50_ms"] <= x["p99_ms"]
    assert layers["pool_b1"]["mean_device_batch"] == 1
    assert layers["pool_b8"]["mean_device_batch"] == 8
    assert served["A_latency"]["layers"] == layers
    assert lat["b64_b8"]["mean_device_batch"] == 8
    b8 = served["B_ivf_b8"]
    assert b8["ivf"]["kernel"] == "ivf_dense_top_k" and \
        b8["ivf"]["launches"] == b8["ivf"]["batches"] == 64
    assert b8["exact"]["kernel"] == "fused_dense_top_k"
    assert b8["ivf"]["recall10"] >= 0.90 and b8["exact"]["recall10"] >= 0.90
    assert lat["ivf_b8"] == b8["ivf"] and lat["exact_b8"] == b8["exact"]
    c = served["C_sharded_swap"]
    assert c["k1_launches_per_batch"] == [4, 3] and c["shards_after"] == 3
    assert c["ids_equal_unsharded"] and c["events"][-1]["recovered"]
    d = served["D_rag_surface"]
    assert d["gold_in_search"] == d["gold_in_rag"] == \
        d["gold_in_rag_sse"] == 4
    assert d["feedback_recorded"] and d["embeddings_equal_table"]
    assert list(summary20["parts"]) == ["A", "C", "D", "B"]
    assert all(v["seconds"] > 0 for v in summary20["parts"].values())
    # Phase 21: the models.
    assert list(models) == ["A_qwen3", "B_served_text", "C_pairs"]
    assert list(summary21["parts"]) == ["A", "B", "C"]
    assert [v["k1_launches"] for v in summary21["parts"].values()] == [
        1, models["B_served_text"]["k1_launches"], 0]
    a = models["A_qwen3"]
    assert a["batch"] == [8, 16] and a["widths"] == TinySmoke.QWEN3
    # Embedding 512 x 64 + 3 layers (q 64x64, k/v 64x32, o 64x64, three
    # MLP projections 64x128, four norms) + the final norm.
    per_layer = 64 * 64 * 2 + 64 * 32 * 2 + 64 * 128 * 3 + 64 * 2 + 16 * 2
    assert a["params"] == 512 * 64 + 3 * per_layer + 64
    assert a["non_embedding_params"] == 3 * per_layer + 64
    assert a["bound_flop"] == 2 * a["non_embedding_params"] * 8 * 16
    assert 8 <= a["valid_tokens"] < 8 * 16
    assert a["cos_min"] >= 0.99 and a["unit_err"] <= 1e-3
    assert a["cut_layers"] == 2 and a["cut_max_abs_err"] <= 1e-4
    assert a["k1_plan"]["bq"] == 16 and a["k1_launches"] == 1
    assert a["forward_ms"] > 0 and a["bound_ms"] > 0
    # No CUDA kernel to trace on the CPU.
    for prof in (a["profile"], models["B_served_text"]["embed_profile"]):
        assert prof["device_ms"] == 0 and prof["idle_share"] == 1.0
        assert prof["enqueue_ms"] > 0 and prof["event_ms"] > 0
        assert prof["top_kernels"] == []
    t = models["B_served_text"]
    assert t["ids_equal_direct"] and t["embeddings_equal"]
    assert t["texts"] == 16 and t["text_p50_ms"] > 0
    qps = t["served_qps_text"]
    assert 0 < qps["qps_min"] <= qps["qps_median"] <= qps["qps_max"]
    assert t["clients"]["requests"] == 8 and t["clients"]["rows"] == 1
    assert list(t["layers"]) == ["embed", "preprocess_text", "pool",
                                 "http"]
    assert all(x["requests"] == 4 and x["p50_ms"] > 0
               for x in t["layers"].values())
    assert t["k1_launches"] >= t["device_batches"] >= 1
    assert t["encoder"] == {"dim": 256, "layers": 4, "out_dim": 32}
    c = models["C_pairs"]
    assert c["pairs"] == 32 and c["atol"] == 2e-2
    for name in ("rerank", "nli"):
        assert c[name]["max_abs_err"] <= 2e-2 and c[name]["ms"] > 0
    assert c["rerank"]["device_ms"] > 0 and c["order_pairs_checked"] >= 0
    # Phase 22: generation.
    gen = {r["generation"]: r for r in records if "generation" in r}
    assert list(gen) == ["A_parity", "B_cut", "C_gen", "D_served"]
    a = gen["A_parity"]
    assert a["prompts"] == [4, 16] and a["logits_rows"] == 64
    assert a["cos_min"] >= 0.99 and a["widths"]["num_layers"] == 3
    b = gen["B_cut"]
    assert b["streams_equal_cpu"] == sorted(
        ["stream_chunk1", "stream_chunk8", "batch", "speculative",
         "server_wave", "server_per_slot", "server_chunked",
         "server_retained", "json_object"])
    assert b["retained_prefix_hits"] == 1
    assert b["json_sampled_parsed_after"] >= 1
    g = gen["C_gen"]
    assert g["gen_slots"] == 8 and g["gen_requests"] == 8
    assert g["gen_model"] == "qwen3-0.6B-arch-3L-64h-bfloat16"
    for key in ("gen_stream_tok_s", "gen_batched_tok_s", "gen_ttft_p50_ms",
                "gen_tick_host_ms", "gen_step_bound_ms"):
        assert g[key] > 0, key
    # No CUDA kernel or event on the CPU.
    assert g["gen_tick_launches"] == 0 and g["gen_tick_event_ms"] is None
    d = gen["D_served"]
    assert d["generate_equal_direct"] and d["json_chat_parsed_after"] >= 1
    assert d["rag_sources"] >= 1 and d["rag_answer_chars"] > 0
    assert d["sse_tokens"] == 48 and d["sse_tokens_per_s"] > 0
    summary22 = [r for r in records if r.get("phase") == "generation"][0]
    assert list(summary22["parts"]) == ["A", "B", "C", "D"]
    # Phase 23: tensor-parallel generation and training.
    train = {r["training"]: r for r in records if "training" in r}
    assert list(train) == ["A_tp_decode", "B_trainer", "C_served_ckpt",
                           "D_pair_trainers", "E_parallel_steps"]
    a = train["A_tp_decode"]
    assert a["tp"] == [2] and a["cos"]["2"]["min"] >= 0.99
    assert a["streams_equal_one_slot"] == ["chunked_prefix", "speculative",
                                           "staggered_wave"]
    assert set(a["tok_s"]) == {"1", "2"} and a["tok_s_tp2_over_tp1"] > 0
    b = train["B_trainer"]
    assert b["steps"] == 16 and b["checkpoints"] == [4, 8, 12, 16, 24]
    assert b["resumed_steps"] == 24 and len(b["resumed_loss"]) == 8
    assert b["loss_last"] < b["loss_first"]
    assert b["recall1"][-1][1] > b["recall1_before"]
    first = b["first_step_vs_cpu"]
    assert first["rows"] == 4 and first["param_share_past_atol"] <= 1e-3
    assert first["loss"] == pytest.approx(first["cpu_loss"], rel=1e-4)
    assert b["step_ms"] > 0 and b["tokens_per_s"] > 0
    c = train["C_served_ckpt"]
    assert c["ids_equal_direct"] and c["step"] == 24
    assert c["k1_launches"] == summary23["k1_launches"]
    d = train["D_pair_trainers"]
    for name in ("reranker", "nli"):
        assert d[name]["loss_last"] < d[name]["loss_first"]
    assert d["candidates"] == 6 and d["reranker"]["holdout_accuracy"] > 0
    e = train["E_parallel_steps"]
    assert list(e["meshes"]) == ["dp4_tp2", "dp2_tp2_sp2", "dp2_pp4_micro2",
                                 "dp2_pp4_micro3", "dp2_ep4_moe"]
    assert [m["kind"] for m in e["meshes"].values()] == [
        "tp", "tp", "pp", "pp", "ep"]
    for m in e["meshes"].values():
        kind = m["kind"]
        assert len(m["losses"]) == 4 and m["losses"][-1] < m["losses"][0]
        assert m["losses"][0] == pytest.approx(m["one_slot_loss"],
                                               rel=e["loss_rtol"][kind])
        assert m["grad_rel_err"] <= e["grad_rtol"][kind]
        assert m["param_share_past_atol"] <= e["param_share"][kind]
        assert m["param_max_abs_err"] <= 2.1e-3
    assert list(summary23["parts"]) == ["A", "B", "C", "D", "E"]
    # Phase 24: the evaluation layer.
    ev = {r["evaluation"]: r for r in records if "evaluation" in r}
    assert list(ev) == ["A_parity", "B_full_width", "C_discrimination"]
    a = ev["A_parity"]
    assert a["verdicts_equal_cpu"] and a["samples"] == 4
    assert len(a["constraints"]) == 3 and a["judge_calls"] >= 8
    b = ev["B_full_width"]
    assert b["widths"]["num_layers"] == 3 and b["widths"]["vocab_size"] == 512
    assert b["chunks"] == b["questions"] == b["rag_rows"] == b["csv_rows"] == 2
    assert b["judge_calls"] >= 2 * 2 and b["repairs"] == 0
    assert b["all_stopped"] and b["generated_tokens"] > 0
    assert b["prompt_tokens_max"] + b["max_tokens"] <= b["max_len"]
    for key in ("judge_seconds", "tok_s", "question_seconds", "rag_seconds"):
        assert b[key] > 0, key
    c = ev["C_discrimination"]
    assert c["questions"] == 8 and c["docs"] == 128
    assert set(c["faithfulness"]) == {"grounded", "corrupted"}
    summary24 = [r for r in records if r.get("phase") == "evaluation"][0]
    assert list(summary24["parts"]) == ["A", "B", "C"]


def test_smoke_needs_the_card(monkeypatch, capsys):
    """Without a GPU the smoke exits non-zero and prints no result, and
    no phase falls back to the CPU: the smoke's device check and phase
    21's models (Qwen3, the embedder, the reranker) raise instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 3
    assert capsys.readouterr().out == ""
    port = chip_smoke._Port()
    for make in (lambda: chip_smoke.Smoke(port),
                 lambda: port.init_qwen3(port.Qwen3Config(**TinySmoke.QWEN3)),
                 lambda: port.OnDeviceEmbedder(),
                 lambda: port.OnDeviceReranker()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_served_latency_limit():
    """Phase 20 fails on a one-client p50 or p99 over the limit."""
    limits = chip_smoke.Smoke.SERVED_LIMITS_MS
    assert limits == {"p50_ms": 10.0, "p99_ms": 20.0}
    ok = {"json_b1": {"p50_ms": 7.03, "p99_ms": 12.6},
          "b64_b8": {"p50_ms": 10.0, "p99_ms": 20.0}}
    assert chip_smoke.over_limits(ok, limits) == []
    slow = {"json_b1": {"p50_ms": 10.5, "p99_ms": 12.6},
            "b64_b8": {"p50_ms": 8.08, "p99_ms": 20.1}}
    assert chip_smoke.over_limits(slow, limits) == [
        ("json_b1", "p50_ms", 10.5), ("b64_b8", "p99_ms", 20.1)]


def test_profiled_timers_trace_again_when_a_trace_holds_no_kernel(
        monkeypatch):
    """A torch.profiler trace without device activity (seen right after
    another session on the card) is taken again; the timers still raise
    when no trace holds the kernel asked for."""
    from types import SimpleNamespace

    from a_nice_rag_tpu_torch.testing import timing

    def event(key, ms, count, device="CUDA"):
        return SimpleNamespace(key=key, count=count,
                               device_type=SimpleNamespace(name=device),
                               device_time_total=ms * 1e3,
                               self_device_time_total=ms * 1e3)

    traces = []

    class FakeProfile:
        def __init__(self, activities):
            self.entries = traces.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.entries

    monkeypatch.setattr(timing, "_warm", lambda fn, warmup: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    launch = [event("cudaLaunchKernel", 0.0, 4, device="CPU")]
    kernels = [event("row_reduce_kernel", 2.0, 4),  # ms over 4 launches
               event("merge_kernel", 0.25, 2)]
    traces[:] = [launch, launch, kernels]
    assert timing.profiled_kernel_ms(lambda: None, "row_reduce", n=4) == 0.5
    traces[:] = [launch, kernels]
    assert timing.profiled_device_ms(lambda: None, n=2) == (1.125, 3.0)
    traces[:] = [launch] * timing.TRACE_ATTEMPTS
    with pytest.raises(RuntimeError, match="no kernel"):
        timing.profiled_kernel_ms(lambda: None, "row_reduce", n=4)
    traces[:] = [kernels]
    with pytest.raises(RuntimeError, match="no kernel"):
        timing.profiled_kernel_ms(lambda: None, "fold", n=4)
    traces[:] = [launch, kernels]
    assert timing.profiled_top_kernels(lambda: None, n=2, top=1) == [
        {"kernel": "row_reduce_kernel", "ms": 1.0, "launches": 2.0}]
