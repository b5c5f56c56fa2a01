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

import torch

import chip_smoke
from a_nice_rag_tpu_torch.ops.kernels import anatomy as an
from a_nice_rag_tpu_torch.ops.kernels import fused_topk as ft
from a_nice_rag_tpu_torch.ops.kernels import int4 as i4
from a_nice_rag_tpu_torch.ops.kernels import ivf_topk as it
from a_nice_rag_tpu_torch.ops.kernels import keys as ks
from a_nice_rag_tpu_torch.ops.kernels import stream as st
from a_nice_rag_tpu_torch.ops.kernels import topk_plan
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
    TILE_E, NPROBE_E, K_E, BATCHES_E = 16, 8, 25, 32
    STREAM_ROWS, STREAM_D, EXACT_ROWS = 1003, 16, 4096
    HEADLINE = dict(n_docs=600, dim=2048, batch=64, vocab=20000, iters=2,
                    single_iters=2, p50_samples=3, recall_queries=64)
    INT4_N, BF16_SHAPES, KEY_NORMALS = 4096, ((8, 512), (16, 1024)), 4096
    BF16_EDGE_SHAPES = ((1, 1), (7, 3), (4, 1025))
    FOLD_EDGE_N, FOLD_EDGE_D, FOLD_EDGE_B = (100, 301), (8, 40, 1024), (1, 65)


def _host_ms(fn, n=3, warmup=1):
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def test_chip_smoke_phases_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for mod, name in WRAPPED:
        wrapper, plain = getattr(mod, name), getattr(mod, name + "_torch")
        # Restored at teardown, so no other test sees these launches.
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)

        def counted(*args, _wrapper=wrapper, _plain=plain, **kwargs):
            _wrapper.launches += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(mod, name + "_torch", counted)
    port = chip_smoke._Port()
    monkeypatch.setattr(port.bench, "card_line", lambda: "cpu, n/a")
    port.require_cuda = lambda: torch.device("cpu")
    port.cuda_event_ms = _host_ms
    port.device_loop_ms = lambda fn, n_loop, trials: _host_ms(fn, n_loop)
    port.chained_ms = lambda fn, n, trials: _host_ms(fn, n)
    port.profiled_kernel_ms = lambda fn, kernel, n: _host_ms(fn, n)
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
                    backend != "torch" and n_pad >= 4096),
    )

    TinySmoke(port).run()

    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 1}
    }
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kernels] == [name for _, name in WRAPPED]
    # K1: stage A 3 calls x 1 dense list, stage B dense + common tier,
    # stage D B = 256 and filtered. K2: stages C and E at B = 256. K3: 64
    # micro-batches + the full probe. K4: 32 micro-batches. Stage F: none.
    # The probes' calls of K1/K2 stay out of these counts. The stream
    # kernels and the probes' own: counts of the host timer's calls.
    assert [k["launches"] for k in kernels][:4] == [7, 2, 65, 32]
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
    records = [json.loads(line) for line in lines if line.startswith("{")]
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
    assert lines[0] == "cpu, n/a"
