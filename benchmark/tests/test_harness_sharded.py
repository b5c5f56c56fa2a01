"""The harness's sharded path at a small size on the CPU: each shard's
rows from the seed alone, the per-shard reference against the reference
over the whole matrix, the one-card cells' data unchanged, and the
per-card trace readings."""

import hashlib
import json

import pytest
import torch

from benchmark.harness import gen, reference as ref, runner, trace
from benchmark.harness.spec import BENCH_DIR, load_cell, load_reader

CPU = torch.device("cpu")
CFG = {"n_docs": 1000, "dim": 64, "clusters": 8, "row_noise": 0.1,
       "query_noise": 0.05}
SEED = 2**31 + 4099


def _shards(cfg=CFG, seed=SEED, n=4):
    return gen.dense_int8_shards(cfg, seed, [CPU] * n)


def test_shard_geometry_is_the_ports():
    from a_nice_rag_tpu_torch.index.array_index import ArrayIndex, CorpusMeta
    from a_nice_rag_tpu_torch.parallel import make_mesh, shard_index

    assert gen.shard_rows(138_364_198, 4) == 34_591_104
    for n in (1000, 1024, 4097, 16_382):
        meta = CorpusMeta(ids=[], sources=[], contents=[], urls=[],
                          n_docs=n, n_docs_padded=n)
        base = ArrayIndex(meta=meta, dense={"m": torch.zeros((n, 4))},
                          bm25=None, vocab=None, bm25_stats=None)
        sidx = shard_index(base, make_mesh(devices=["cpu"] * 4))
        assert sidx.n_local == gen.shard_rows(n, 4)
        got = _shards({**CFG, "n_docs": n})
        assert [s.offset for s in got] == [sh.offset for sh in sidx.shards]
        assert [s.n_real for s in got] == [sh.n_real for sh in sidx.shards]


def test_shard_rows_whatever_the_order():
    """Shard s's rows come from the seed and s alone: made one shard at a
    time in reverse order, they are the rows made all together."""
    together = _shards()
    n_local = together[0].values.shape[0]
    for s in reversed(range(4)):
        sh = together[s]
        cent = gen.centres(gen.make_generator(CPU, SEED, "dense"),
                           CFG["clusters"], CFG["dim"], CPU)
        values = torch.zeros((n_local, CFG["dim"]), dtype=torch.int8)
        scales = torch.zeros((n_local,))
        for r0, x in gen.rows_around(
                gen.make_generator(CPU, SEED, f"dense/{s}"), cent, sh.n_real,
                CFG["row_noise"], CPU):
            v, sc = gen.quantize_rows(x)
            values[r0:r0 + x.shape[0]] = v
            scales[r0:r0 + x.shape[0]] = sc
        assert torch.equal(values, sh.values)
        assert torch.equal(scales, sh.scales)
    # Pad rows are zero; other seeds, other rows.
    assert not together[-1].values[together[-1].n_real:].any()
    assert not torch.equal(_shards(seed=SEED + 1)[0].values,
                           together[0].values)


def test_query_pool_gathers_from_the_holding_shard():
    shards = _shards()
    whole_v = torch.cat([s.values[:s.n_real] for s in shards])
    whole_s = torch.cat([s.scales[:s.n_real] for s in shards])
    a = gen.query_pool(CFG, 300, SEED, CPU, int8_shards=shards)
    b = gen.query_pool(CFG, 300, SEED, CPU, int8_rows=(whole_v, whole_s))
    assert torch.equal(a.dense, b.dense)


def test_sharded_reference_is_the_whole_ones():
    shards = _shards()
    whole = (torch.cat([s.values[:s.n_real] for s in shards]),
             torch.cat([s.scales[:s.n_real] for s in shards]))
    q = gen.query_pool(CFG, 16, SEED, CPU, int8_shards=shards).dense
    one = ref.DenseReference(q, int8_rows=whole)
    many = ref.ShardedDenseReference(q, shards)
    k = 25
    assert torch.equal(one.best(k), many.best(k))
    ids = one.control_ids(q, k)
    assert torch.equal(ids, many.control_ids(q, k))
    # Ids of every shard, -1, and ids no shard holds (pad rows, past N).
    probe = torch.cat([ids, torch.tensor([[-1, 999, 1000, 1023, 5000]]
                                         ).expand(16, -1)], dim=1)
    got = many.scores_of(probe)
    assert torch.equal(one.scores_of(probe), got)
    # -1 and ids past the last passage (the last shard's pad rows, and
    # past every shard) read -inf; the last passage reads its score.
    assert bool(torch.isinf(got[:, -5]).all())
    assert bool(torch.isfinite(got[:, -4]).all())
    assert bool(torch.isinf(got[:, -3:]).all())


# The rehearsal data of the one-card cells, as the harness made them
# before it learnt to lay a corpus out by shard.
ONE_CARD_DIGESTS = {
    "nq-q256-bf16.frames":
        "6f4dcf78137422009d6b0f43908e05104bab49a14b3f7fe83dae155208f4e9ce",
    "msmarco-q1024-int8.frames":
        "69b449a227a8a49fc168b1457c91c6cda7e461604941a6e9092fa6d4e8a195d8",
}


@pytest.mark.parametrize("cell", sorted(ONE_CARD_DIGESTS))
def test_one_card_data_unchanged(cell):
    c = load_cell(cell)
    cfg = runner.rehearsal_config(c.config)
    assert "mesh" not in cfg
    rows = cfg["rehearsal_traffic"]["pool_rows"]
    data, pool, _ = runner.build(cfg, 2**31 + 977, CPU, rows)
    parts = [data["bf16"].view(torch.int16)] if "bf16" in data \
        else list(data["int8"])
    tc = data.get("terms")
    if tc is not None:
        parts += [tc.indptr, tc.post_doc, tc.post_tf, tc.doc_len]
    parts.append(pool.dense)
    if pool.terms is not None:
        parts.append(pool.terms)
    h = hashlib.sha256()
    for p in parts:
        h.update(p.contiguous().numpy().tobytes())
    assert h.hexdigest() == ONE_CARD_DIGESTS[cell]


def _events(ops):
    """Chrome trace events of (card, start us, duration us) kernels."""
    return {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": ts, "dur": dur,
         "args": {"device": card}}
        for i, (card, ts, dur) in enumerate(ops)]}


def _window(tmp_path, ops, chips, window_s):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(_events(ops)))
    tr = trace.load(str(p))
    spans = trace.card_spans(tr, chips)
    return trace.Window(
        device_ops=tr.device, busy_s=trace.mean_busy_s(spans),
        window_s=window_s, batch_rows=[], stats={}, config={}, chips=chips,
        card_spans=spans,
        card_busy_s={c: trace.spans_s(sp) for c, sp in spans.items()})


def _read(name, w):
    return load_reader(BENCH_DIR / "metrics" / f"{name}.py")(w)


def test_idle_on_one_card_is_the_old_formula(tmp_path):
    ops = [(0, 100.0, 300.0), (0, 350.0, 100.0), (0, 1000.0, 250.0)]
    w = _window(tmp_path, ops, 1, 0.002)
    old_busy = trace.busy_s(w.device_ops)
    assert w.busy_s == old_busy == pytest.approx(600e-6)
    assert _read("device.idle_pct", w) == 100.0 * (1.0 - old_busy / 0.002)
    # One card has nothing to overlap.
    assert _read("cards.all_busy_pct", w) is None


def test_all_busy_on_four_cards(tmp_path):
    # Cards 0-3 busy [0, 1000), [200, 900), [100, 600) + [700, 1000),
    # [300, 800): all four at once in [300, 600) and [700, 800): 400 us.
    ops = [(0, 0.0, 600.0), (0, 500.0, 500.0), (1, 200.0, 700.0),
           (2, 100.0, 500.0), (2, 700.0, 300.0), (3, 300.0, 500.0)]
    w = _window(tmp_path, ops, 4, 0.002)
    assert w.card_busy_s == pytest.approx(
        {0: 1e-3, 1: 7e-4, 2: 8e-4, 3: 5e-4})
    assert _read("cards.all_busy_pct", w) == pytest.approx(20.0)
    assert w.busy_s == pytest.approx(3e-3 / 4)
    assert _read("device.idle_pct", w) == pytest.approx(
        100 * (1 - (1e-3 + 7e-4 + 8e-4 + 5e-4) / 4 / 2e-3))
    # A card that ran nothing: never all four at once, and fully idle.
    w = _window(tmp_path, [op for op in ops if op[0] != 3], 4, 0.002)
    assert _read("cards.all_busy_pct", w) == 0.0
    assert w.card_busy_s[3] == 0.0
