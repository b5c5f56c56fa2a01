"""chip_smoke.py's phases, rehearsed on the CPU at tiny sizes.

The smoke run itself needs a GPU. Here its phases run on CPU tensors,
where the kernel wrappers take their plain versions, with four fakes:
each plain-version call through a wrapper counts as a launch, the
retriever's route to the kernels is forced, CUDA synchronisation is a
no-op, and the CUDA-event timer is a host clock. The tiny stage D and E
sizes keep the IVF coverage rule's routes (IVF at B = 8, exact at
B = 256). This keeps the script's control flow, shapes and checks working
between chip runs; what it says about the kernels themselves comes only
from the card.
"""

import json
import statistics
import time

import torch

import chip_smoke
from a_nice_rag_tpu_torch.ops.kernels import fused_topk as ft
from a_nice_rag_tpu_torch.ops.kernels import ivf_topk as it


class TinySmoke(chip_smoke.Smoke):
    N_KERNEL, D_KERNEL = 3000 + 37, 32
    IVF_TILES = (128, 256)
    N_A, D_A, B, T, V, DF = 4096, 32, 16, 16, 1024, 16
    # 512 clusters of 16 rows: nprobe 8 covers 0.12 of them at B = 8.
    N_C, D_C, CLUSTERS, CHUNKS = 8192, 1024, 512, 4
    # 128 k-means clusters, nprobe 4: coverage 0.22 at B = 8.
    N_D, D_D, CENTRES_D, TILE_D, NPROBE_D, K_D, V_D = (
        16384, 32, 128, 128, 4, 16, 8192)
    BATCHES_D = 64
    TILE_E, NPROBE_E, K_E, BATCHES_E = 16, 8, 25, 32


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
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu, n/a")
    for mod, name in ((ft, "fused_dense_top_k"), (ft, "fused_dense_top_k_int8"),
                      (it, "ivf_dense_top_k"), (it, "ivf_dense_top_k_int8")):
        wrapper, plain = getattr(mod, name), getattr(mod, name + "_torch")
        # Restored at teardown, so no other test sees these launches.
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)

        def counted(*args, _wrapper=wrapper, _plain=plain, **kwargs):
            _wrapper.launches += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(mod, name + "_torch", counted)
    port = chip_smoke._Port()
    port.require_cuda = lambda: torch.device("cpu")
    port.cuda_event_ms = _host_ms
    monkeypatch.setattr(port.kernels, "build_kernels", lambda: None)
    monkeypatch.setattr(
        port.FusedRetriever, "_route_kernel",
        classmethod(lambda cls, backend, n_pad, k, device: backend != "torch"),
    )

    TinySmoke(port).run()

    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 1}
    }
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kernels] == [
        "fused_dense_top_k", "fused_dense_top_k_int8", "ivf_dense_top_k",
        "ivf_dense_top_k_int8",
    ]
    # K1: stage A 3 calls x 1 dense list, stage B dense + common tier,
    # stage D B = 256 and filtered. K2: stages C and E at B = 256. K3: 64
    # micro-batches + the full probe. K4: 32 micro-batches.
    assert [k["launches"] for k in kernels] == [7, 2, 65, 32]
    for k in kernels:
        assert k["bound_by"] in ("bytes", "operations")
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            assert k[key] > 0, (k["name"], key)
    crossover = [json.loads(line) for line in lines if '"crossover"' in line]
    assert [(c["crossover"], c["B"]) for c in crossover] == [
        ("D_2M_bf16", 8), ("D_2M_bf16", 16), ("D_2M_bf16", 32),
        ("D_2M_bf16", 64), ("E_10.5M_int8", 8)]
    assert lines[0] == "cpu, n/a"
