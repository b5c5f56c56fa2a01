"""The roofline functions and the per-layer readers on a canned trace."""

import json

import pytest

from benchmark.harness import roofline, trace
from benchmark.harness.spec import BENCH_DIR, load_reader

K1 = ("void (anonymous namespace)::topk_kernel<(anonymous namespace)::"
      "FloatRows<__nv_bfloat16>, 64>(...)")
K2 = ("void (anonymous namespace)::topk_kernel<(anonymous namespace)::"
      "Int8RowsT<false>, 64>(...)")


def test_k1_bound_by_hand():
    # 2^21 x 256 bf16, B = 256, k = 32: 1,073,741,824 + 262,144 + 65,536
    # bytes; 2 * 256 * 2^21 * 256 = 274,877,906,944 operations.
    b = 1_073_741_824 + 262_144 + 65_536
    assert roofline.k1_bound_s(256, 1 << 21, 256, 32) == pytest.approx(
        max(b / 3.35e12, 274_877_906_944 / 989e12))
    # At B = 4096 the operations bound it.
    ops = 2 * 4096 * (1 << 21) * 256
    assert roofline.k1_bound_s(4096, 1 << 21, 256, 32) == pytest.approx(
        ops / 989e12)


def test_k2_bound_by_hand():
    n, d, b, k = 8_841_823, 1024, 256, 25
    byt = n * d + 4 * n + b * d + 4 * b + 8 * b * k
    assert byt == 9_089_708_412  # 9,054,026,752 + 35,367,292 + 314,368
    assert roofline.k2_bound_s(b, n, d, k) == pytest.approx(byt / 3.35e12)


CANNED = {"traceEvents": [
    {"ph": "X", "cat": "kernel", "name": K1, "ts": 1000.0, "dur": 400.0},
    {"ph": "X", "cat": "kernel", "name": "merge_kernel(...)", "ts": 1400.0,
     "dur": 100.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1450.0,
     "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "aten::sort_kernel", "ts": 2000.0,
     "dur": 500.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 1500.0,
     "dur": 600.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1700.0,
     "dur": 100.0},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
]}


def _window(tmp_path, batches=(256, 256), stats=None):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(CANNED))
    tr = trace.load(str(p))
    cfg = {"n_docs": 1 << 21, "dim": 256,
           "retriever": {"similarity_k": 32}}
    return tr, trace.Window(
        device_ops=tr.device, busy_s=trace.busy_s(tr.device),
        window_s=0.002, batch_rows=list(batches),
        stats=stats or {"batches_run": 2, "queries_served": 300},
        config=cfg)


def _read(name, w):
    return load_reader(BENCH_DIR / "metrics" / f"{name}.py")(w)


def test_busy_is_the_union(tmp_path):
    tr, w = _window(tmp_path)
    assert len(tr.device) == 4 and len(tr.host) == 2
    assert w.busy_s == pytest.approx((1550 - 1000 + 500) / 1e6)


def test_readers_on_canned_trace(tmp_path):
    _, w = _window(tmp_path)
    assert _read("sched.rows_per_batch", w) == pytest.approx(150.0)
    assert _read("retriever.device_ms", w) == pytest.approx(1.1 / 2)
    assert _read("device.idle_pct", w) == pytest.approx(
        100 * (1 - 1.05e-3 / 2e-3))
    bound = 2 * roofline.k1_bound_s(256, 1 << 21, 256, 32)
    assert _read("k1.roofline_pct", w) == pytest.approx(100 * bound / 5e-4)
    # No K2 launch in this trace: the reader finds nothing.
    assert _read("k2.roofline_pct", w) is None


def test_readers_find_nothing_without_work(tmp_path):
    _, w = _window(tmp_path, stats={"batches_run": 0, "queries_served": 0})
    w.device_ops = []
    for name in ("sched.rows_per_batch", "retriever.device_ms",
                 "device.idle_pct", "k1.roofline_pct", "k2.roofline_pct"):
        assert _read(name, w) is None


def test_k2_reader(tmp_path):
    _, w = _window(tmp_path)
    w.device_ops = [(K2, 0.0, 3000.0), ("merge_kernel", 3000.0, 100.0)]
    w.config = {"n_docs": 8_841_823, "dim": 1024,
                "retriever": {"similarity_k": 25}}
    w.batch_rows = [256]
    assert _read("k2.roofline_pct", w) == pytest.approx(
        100 * roofline.k2_bound_s(256, 8_841_823, 1024, 25) / 3.1e-3)


def test_breakdown_labels_gaps_by_host_op(tmp_path):
    tr, _ = _window(tmp_path)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["aten::sort_kernel", 5e-4]
    # The gap 1550-2000 us: its middle (1775) falls in aten::copy_.
    assert bd["idle_gaps"] == [["aten::copy_", pytest.approx(4.5e-4)]]
