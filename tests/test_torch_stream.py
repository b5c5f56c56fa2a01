"""The stream sums (ops/kernels/stream.py) against the JAX package's TPU
stream kernels, and the port's stream probes, on the CPU.

The TPU kernels are the functions of ``scripts/probe_hbm_stream.py``
(``pallas_sum``, ``pallas_sum_k``, ``pallas_sum_biased``) and
``scripts/probe_dma_overlap.py`` (``probe``), imported as modules and run
in Pallas interpret mode. On CPU tensors the port's wrappers take their
plain versions, which are what is compared here; the CUDA kernels are
held against those plain versions in ``test_torch_kernels_cuda.py``.
Tolerance: 1e-5 of the sum of absolute values (float32 sums in another
order); the busy kernel's chains bit for bit against a host recurrence.
"""

import functools
import importlib.util
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from a_nice_rag_tpu_torch.ops.kernels import (
    stream_sum,
    stream_sum_busy,
    stream_sum_busy_torch,
    stream_sum_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.stream import abs_total, busy_chain
from a_nice_rag_tpu_torch.probes import dma_overlap, hbm_stream

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
RTOL = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_port_test_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _bf16(seed, rows, cols=256):
    """The same bf16 matrix as a numpy f32 array (exactly representable)
    and a torch bf16 tensor."""
    x = np.random.default_rng(seed).standard_normal((rows, cols))
    t = torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16)
    return t.float().numpy(), t


def _close(got, want, scale):
    assert abs(float(got) - float(want)) <= RTOL * scale, (got, want)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_stream_sum_matches_pallas_sum(interpret, m):
    probe = _script("probe_hbm_stream")
    xs = [_bf16(10 + i, 4096 // m) for i in range(m)]
    jparts = [jnp.asarray(x, dtype=jnp.bfloat16) for x, _ in xs]
    tparts = [t for _, t in xs]
    scale = abs_total(tparts)
    want = (probe.pallas_sum(jparts[0], 1024) if m == 1
            else probe.pallas_sum_k(jparts, 1024 // m))
    _close(stream_sum_torch(tparts), np.asarray(want), scale)
    bias = np.float32(-2.5)
    want_b = probe.pallas_sum_biased(jparts, jnp.asarray(bias), 1024 // m)
    got_b = stream_sum_torch(tparts, torch.tensor([bias]))
    _close(got_b, np.asarray(want_b), scale + 2.5)
    assert got_b.shape == () and got_b.dtype == torch.float32


def test_stream_sum_matches_pallas_sum2(interpret):
    probe = _script("probe_hbm_stream")
    (xa, ta), (xb, tb) = _bf16(20, 2048), _bf16(21, 2048)
    want = probe.pallas_sum2(jnp.asarray(xa, dtype=jnp.bfloat16),
                             jnp.asarray(xb, dtype=jnp.bfloat16), 512)
    _close(stream_sum_torch([ta, tb]), np.asarray(want), abs_total([ta, tb]))


@pytest.mark.parametrize("x_iters", [0, 2])
def test_stream_sum_busy_matches_dma_overlap_probe(interpret, x_iters):
    probe = _script("probe_dma_overlap")
    x, t = _bf16(30, 4096)
    block_n, grid = 512, 3
    seed = np.float32(0.75)
    out = probe.probe(jnp.full((8, 128), seed, jnp.float32),
                      jnp.asarray(x, dtype=jnp.bfloat16), x_iters, block_n,
                      work_cols=128)
    # The TPU probe adds its one chain, stepped n_tiles * X times.
    chain = busy_chain(x.shape[0] // block_n * x_iters)
    got, work = stream_sum_busy_torch(t, torch.tensor(seed), x_iters, grid,
                                      tile_rows=block_n)
    _close(got, np.asarray(out)[0, 0] - chain, abs_total(t) + 1.0)
    # 8 tiles on 3 CTAs: 3, 3 and 2 tiles.
    want = [busy_chain(n * x_iters) for n in (3, 3, 2)]
    assert work.numpy().tobytes() == np.array(want, np.float32).tobytes()


def test_busy_chain_is_the_float32_recurrence():
    w = np.float32(1.000001)
    for steps in range(6):
        assert busy_chain(steps) == w
        w = np.float32(np.float32(w * np.float32(1.000001))
                       + np.float32(1e-9))
    assert busy_chain(0) == np.float32(1.000001)
    assert busy_chain(1000) > busy_chain(999)


def test_stream_sum_busy_work_counts_tiles_per_cta():
    t = torch.ones((50, 4), dtype=torch.float32)
    for grid, tile_rows in ((1, 7), (4, 7), (9, 7), (100, 3), (5, 50)):
        out, work = stream_sum_busy_torch(t, torch.tensor(1.0), 3, grid,
                                          tile_rows)
        n_tiles = -(-50 // tile_rows)
        want = [busy_chain(3 * len(range(c, n_tiles, grid)))
                for c in range(grid)]
        assert work.numpy().tolist() == np.array(want, np.float32).tolist()
        assert float(out) == 201.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_stream_sum_wrapper_takes_the_plain_version_on_cpu(dtype):
    g = torch.Generator().manual_seed(3)
    if dtype == torch.int8:
        parts = [torch.randint(-127, 128, (301, 33), generator=g,
                               dtype=torch.int8) for _ in range(3)]
        want = sum(int(p.sum(dtype=torch.int64)) for p in parts)
    else:
        parts = [torch.randn((301, 33), generator=g).to(dtype)
                 for _ in range(3)]
        want = sum(float(p.double().sum()) for p in parts)
    before = stream_sum.launches
    got = stream_sum(parts, torch.tensor([0.5]))
    assert stream_sum.launches == before  # no kernel ran
    _close(got, want + 0.5, abs_total(parts) + 0.5)
    view = parts[0].reshape(-1)[5:]  # a view that starts mid-vector
    _close(stream_sum(view), stream_sum_torch(view), abs_total(view))


def test_stream_sum_int8_plain_is_exact():
    x = torch.full((3000, 1000), 127, dtype=torch.int8)
    x[::2] = -128
    want = 1500 * 1000 * 127 - 1500 * 1000 * 128
    assert float(stream_sum_torch(x)) == float(np.float32(want))


def test_stream_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((10, 4))
    with pytest.raises(ValueError):
        stream_sum([x] * 9)
    with pytest.raises(ValueError):
        stream_sum([])
    with pytest.raises(TypeError):
        stream_sum([x, x.to(torch.bfloat16)])
    with pytest.raises(TypeError):
        stream_sum(x.to(torch.float16))
    with pytest.raises(ValueError):
        stream_sum(x.T)
    with pytest.raises(ValueError):
        stream_sum(x, torch.zeros(2))
    with pytest.raises(ValueError):
        stream_sum(x, unroll=3)
    with pytest.raises(ValueError):
        stream_sum_busy(x, torch.zeros(()), 1, 0)
    with pytest.raises(ValueError):
        stream_sum_busy(x.reshape(-1), torch.zeros(()), 1, 4)


def _host_ms(fn, n):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def test_hbm_stream_probe_lines_on_cpu():
    lines = hbm_stream.run(torch.device("cpu"), _host_ms, n_rows=512,
                           dim=32, n_loop=1)
    tags = [row["line"] for row in lines]
    assert tags == (["a", "p"] + ["b"] * 16 + ["c", "d"]
                    + ["e", "f"] * len(hbm_stream.STREAM_COUNTS))
    for row in lines:
        assert row["ms"] > 0 and row["gb_s"] > 0
    assert [r["parts"] for r in lines if r["line"] == "e"] == [
        1, 2, 3, 4, 6, 8]


def test_dma_overlap_probe_lines_on_cpu():
    emb = torch.randn((1000, 32)).to(torch.bfloat16)
    lines = dma_overlap.run(emb, _host_ms, grid=6, xs=(0, 2, 8),
                            tile_rows=16, n_loop=1)
    assert [r["x_iters"] for r in lines] == [0, 2, 8]
    assert lines[0]["added_ms"] == 0.0
    assert all(r["tiles"] == 63 and r["grid"] == 6 for r in lines)
