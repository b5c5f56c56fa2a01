"""The work plan of the top-k kernels K1-K4 (ops/kernels/topk_plan.py),
on the CPU, for int8 rows (K2, K4) and float rows (K1, K3): the query
block chosen by B and D, whether a float query block stays resident, the
doc splits, the tau pass's splits and walkers, and the IVF work items,
which must cover every real row of the tabled tiles exactly once (and the
tau pass's every 64th). ``ivf_items`` mirrors the kernels' walk
(csrc/topk_common.cuh, IvfWalk); the kernels themselves are held against
their plain versions on the card (test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from a_nice_rag_tpu_torch.ops.kernels import topk_plan as P
from a_nice_rag_tpu_torch.ops.kernels.ivf_topk import (
    ivf_dense_top_k_int8_torch,
)

H100_SMS = 132


@pytest.mark.parametrize("b,want", [(1, 16), (8, 16), (16, 16), (17, 64),
                                    (64, 64), (65, 64), (256, 64)])
def test_query_block_switches_above_16(b, want):
    assert P.query_block(b, 1024, 25) == want
    assert P.query_block(b, 37, 128) == want


def test_query_block_for_deep_rows():
    # 64 rows of depth 4096 do not fit beside the ring at k = 128; 16 do.
    assert P.smem_bytes(64, 4096, 128) > P.SMEM_PER_CTA
    assert P.query_block(256, 4096, 128) == 16
    with pytest.raises(ValueError):
        P.query_block(8, 16_384, 25)


def test_shared_memory_and_occupancy_at_the_main_shapes():
    # Stage C (B = 256) one CTA per SM; stage E (B = 8) two, also at
    # k = 256; shallow rows three.
    assert P.smem_bytes(64, 1024, 25) == (3 * 128 * 128 + 64 * 1024
                                          + 4 * 64 * 129 + 8 * 64 * 25
                                          + 12 * 64 + 128)
    assert P.ctas_per_sm(64, 1024, 25) == 1
    assert P.ctas_per_sm(16, 1024, 25) == P.ctas_per_sm(16, 1024, 256) == 2
    assert P.ctas_per_sm(16, 37, 25) == 3
    for bq, d, k in ((64, 1024, 128), (16, 37, 256), (64, 1040, 128),
                     (16, 1024, 25)):
        ctas = P.ctas_per_sm(bq, d, k)
        per_cta = P.smem_bytes(bq, d, k) + 16 * bq + P.SMEM_RESERVED
        assert per_cta * ctas <= P.SMEM_PER_SM
    assert P.depth_pad(1) == 128 and P.depth_pad(1024) == 1024
    assert P.depth_pad(1025) == 1152


@pytest.mark.parametrize("n,b,d,k", [
    (10_485_760, 256, 1024, 25), (10_485_760, 8, 1024, 25),
    (70_001, 65, 37, 128), (1, 1, 1, 1), (300, 17, 33, 128),
])
def test_fused_plan_splits_the_rows_in_whole_tiles(n, b, d, k):
    bq, splits, per = P.fused_plan(n, b, d, k, H100_SMS)
    assert bq == P.query_block(b, d, k)
    assert per % P.TN == 0 and per >= P.TN
    assert (splits - 1) * per < n <= splits * per  # no empty split
    # At most the CTAs the SMs hold, and the fewest tiles per split that
    # stay within that.
    target = min(-(-P.ctas_per_sm(bq, d, k) * H100_SMS // -(-b // bq)),
                 -(-n // P.TN))
    assert splits <= target
    assert per == P.TN or -(-n // (per - P.TN)) > target


def _table(tiles, real, slots, dynamic, rows):
    t = np.full(slots + (1 if dynamic else 0), -1, np.int64)
    t[:len(real)] = real
    if dynamic:
        t[slots] = rows
    return t


def _covered(items):
    rows = [r for walker in items for r0, r1 in walker for r in range(r0, r1)]
    return sorted(rows), len(rows)


@pytest.mark.parametrize("tile_n", [2048, 1000, 128, 64])
@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("walkers", [1, 7, 264, 10_000])
def test_ivf_items_cover_every_real_row_once(tile_n, dynamic, walkers):
    rng = np.random.default_rng(tile_n + walkers)
    tiles = 23
    rows = (tiles - 1) * tile_n + tile_n // 3 + 1  # a ragged last tile
    real = np.sort(rng.choice(tiles - 1, 9, replace=False))
    real = np.append(real, tiles - 1)
    slots = 16  # -1 padded
    table = _table(tiles, real, slots, dynamic, rows)
    spt = -(-tile_n // P.TN)
    # The kernel reads the row count from the trailing slot when dynamic.
    n_rows = int(table[slots]) if dynamic else rows
    items = P.ivf_items(table, slots, tile_n, n_rows, walkers, spt)
    got, count = _covered(items)
    want = [r for t in real for r in range(t * tile_n, min((t + 1) * tile_n,
                                                          rows))]
    assert count == len(want)  # no row twice
    assert got == sorted(want)
    for walker in items:  # ascending slots, sub-tiles of at most TN rows
        starts = [r0 for r0, _ in walker]
        assert all(0 <= r1 - r0 <= P.TN for r0, r1 in walker)
        slot_of = {int(t): i for i, t in enumerate(real)}
        order = [slot_of[r0 // tile_n] for r0 in starts]
        assert order == sorted(order)
    # Walkers take items in turn: none more than one ahead of another.
    lengths = [len(w) for w in items]
    assert max(lengths) - min(lengths) <= 1


def test_ivf_items_leave_walkers_past_the_real_items_idle():
    # Real entries come first: a walker whose first item lies on a -1
    # slot stops at once.
    table = np.array([4, 2, -1, -1])
    items = P.ivf_items(table, 4, 256, 10_000, 10, 2)
    assert [len(w) for w in items] == [1, 1, 1, 1] + [0] * 6
    assert _covered(items)[0] == list(range(2 * 256, 3 * 256)) + list(
        range(4 * 256, 5 * 256))


def test_ivf_plan_at_stage_e():
    # 10.5M x 1024 int8, B = 8, nprobe 8: 192 slots of 2048-row tiles.
    bq, walkers, spt = P.ivf_plan(192, 2048, 8, 1024, 25, H100_SMS)
    assert (bq, walkers, spt) == (16, 264, 16)
    # 124 real tiles: 1984 items over 264 walkers, every SM busy.
    table = _table(192, np.arange(124) * 3, 192, False, 10_485_760)
    items = P.ivf_items(table, 192, 2048, 10_485_760, walkers, spt)
    assert sum(map(len, items)) == 124 * 16
    assert min(map(len, items)) >= 7
    # Fewer items than CTAs: one walker per item.
    assert P.ivf_plan(3, 256, 300, 64, 1, H100_SMS).walkers == 6


@pytest.mark.parametrize("walkers", [1, 5, 64])
@pytest.mark.parametrize("dynamic", [False, True])
def test_ivf_walk_per_walker_lists_merge_to_the_plain_top_k(walkers,
                                                              dynamic):
    # The kernel's result is the merge of one running list per walker
    # over its items: it must equal the plain version's top-k.
    rng = np.random.default_rng(walkers)
    tile_n, tiles, k, b, d = 300, 9, 25, 8, 37
    rows = 8 * tile_n + 111
    values = torch.tensor(rng.integers(-128, 128, (tiles * tile_n, d),
                                       dtype=np.int8))
    values[tile_n:tile_n + 40] = values[:40]  # exact ties across tiles
    scales = torch.tensor(rng.uniform(0.5, 1.5, tiles * tile_n)
                          .astype(np.float32))
    scales[tile_n:tile_n + 40] = scales[:40]
    qv = torch.tensor(rng.integers(-128, 128, (b, d), dtype=np.int8))
    qs = torch.tensor(rng.uniform(0.5, 1.5, b).astype(np.float32))
    real = np.array([0, 1, 4, 8])
    table = _table(tiles, real, 6, dynamic, rows)
    tt = torch.tensor(table, dtype=torch.int32)
    want_v, want_i = ivf_dense_top_k_int8_torch(
        values, scales, qv, qs, tt, k, tile_n, 0 if dynamic else rows)
    spt = -(-tile_n // P.TN)
    items = P.ivf_items(table, 6, tile_n, rows, walkers, spt)
    acc = (qv.long() @ values.long().T).to(torch.float32) * scales
    lists = []
    for walker in items:
        ids = [r for r0, r1 in walker for r in range(r0, r1)]
        if not ids:
            continue
        idx = torch.tensor(sorted(ids))
        s = acc[:, idx]
        # (score desc, row asc) within the walker's rows.
        order = torch.sort(s, dim=1, descending=True, stable=True).indices
        lists.append((torch.take_along_dim(s, order[:, :k], 1),
                      idx[order[:, :k]]))
    v = torch.cat([x for x, _ in lists], 1)
    i = torch.cat([y for _, y in lists], 1)
    i, pos = torch.sort(i, dim=1, stable=True)
    v = torch.take_along_dim(v, pos, 1)
    v, pos = torch.sort(v, dim=1, descending=True, stable=True)
    i = torch.take_along_dim(i, pos, 1)[:, :k]
    assert torch.equal(i.to(torch.int32), want_i)
    assert torch.equal(v[:, :k] * qs[:, None], want_v)


# -- float rows (K1, K3) -----------------------------------------------------


@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [1, 33, 37, 256, 1024, 2048, 4096])
@pytest.mark.parametrize("b", [1, 8, 16, 17, 64, 65, 256])
def test_float_query_block_at_the_switch_and_depths(rows, d, b):
    # 16 queries up to B = 16, 64 above, at every depth (the block streams
    # where it does not fit), for every k K1 takes.
    for k in (1, 32, 128):
        bq = P.query_block(b, d, k, rows)
        assert bq == (16 if b <= 16 else 64)
        qres = P.resident(bq, d, k, rows)
        smem = P.smem_bytes(bq, d, k, rows, qres)
        assert smem + 16 * bq <= P.SMEM_PER_CTA
        if not qres:  # streamed only where resident does not fit
            assert P.smem_bytes(bq, d, k, rows, True) + 16 * bq \
                > P.SMEM_PER_CTA


def test_float_shared_memory_sums():
    # bf16 rows: three query planes of 2-byte elements; float rows end
    # with a hit flag per query.
    tail = 4 * 64 * 129 + 8 * 64 * 32 + 12 * 64 + 128 + 64
    assert P.smem_bytes(64, 256, 32, "bfloat16") == (
        3 * 128 * 128 + 3 * 64 * 512 + tail)
    assert P.smem_bytes(64, 256, 32, "bfloat16", qres=False) == (
        3 * (128 * 128 + 3 * 64 * 128) + tail)
    assert P.smem_bytes(64, 256, 32, "float32") == (
        3 * 128 * 128 + 64 * 1024 + tail)
    assert P.depth_pad(37 * 2) == 128 and P.depth_pad(33 * 4) == 256
    # Stage A's K1 (B = 256, D = 256 bf16): resident, one CTA per SM;
    # stage D's K3 (B = 8): 16 queries, two CTAs per SM.
    assert P.resident(64, 256, 32, "bfloat16")
    assert P.ctas_per_sm(64, 256, 32, "bfloat16") == 1
    assert P.ctas_per_sm(16, 256, 16, "bfloat16") == 2
    assert not P.resident(64, 4096, 128, "bfloat16")
    with pytest.raises(ValueError):
        P.smem_bytes(16, 8, 1, "float16")


@pytest.mark.parametrize("rows", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("n,b,d,k", [
    (1 << 21, 256, 256, 32), (2_000_000, 8, 256, 16), (300, 17, 33, 128),
    (1, 1, 1, 1), (70_001, 65, 37, 25),
])
def test_tau_plan_covers_every_64th_row_once(rows, n, b, d, k):
    splits, per = P.tau_fused_plan(n, b, d, k, H100_SMS, rows)
    assert per % (P.TN * P.TAU_STRIDE) == 0
    assert (splits - 1) * per < n <= splits * per  # no empty split
    # Split s walks rows s * per, s * per + 64, ...: together every 64th.
    got = [r for s in range(splits)
           for r in range(s * per, min(n, (s + 1) * per), P.TAU_STRIDE)]
    assert got == list(range(0, n, P.TAU_STRIDE))
    bq = P.query_block(b, d, k, rows)
    assert splits <= -(-P.ctas_per_sm(bq, d, k, rows) * H100_SMS
                       // -(-b // bq))


@pytest.mark.parametrize("tile_n", [2048, 1000, 128, 64, 10_000])
@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("walkers", [1, 7, 264])
def test_ivf_tau_items_cover_every_64th_row_of_the_real_tiles(
        tile_n, dynamic, walkers):
    rng = np.random.default_rng(tile_n + walkers)
    tiles = 23
    rows = (tiles - 1) * tile_n + tile_n // 3 + 1
    real = np.append(np.sort(rng.choice(tiles - 1, 9, replace=False)),
                     tiles - 1)
    table = _table(tiles, real, 16, dynamic, rows)
    spt = -(-tile_n // (P.TN * P.TAU_STRIDE))
    items = P.ivf_items(table, 16, tile_n, rows, walkers, spt,
                        P.TAU_STRIDE)
    got = sorted(r for w in items for r0, r1 in w
                 for r in range(r0, r1, P.TAU_STRIDE))
    want = sorted(r for t in real
                  for r in range(t * tile_n, min((t + 1) * tile_n, rows),
                                 P.TAU_STRIDE))
    assert got == want
    assert all(r1 - r0 <= P.TN * P.TAU_STRIDE for w in items
               for r0, r1 in w)


@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
def test_float_ivf_plan_at_stage_d(rows):
    # 2M x 256 IVF, B = 8, nprobe 16: 298 slots of 1024-row tiles; the
    # float items are the int8 walk's (the same IvfWalk).
    bq, walkers, spt = P.ivf_plan(298, 1024, 8, 256, 16, H100_SMS, rows)
    ctas = P.ctas_per_sm(16, 256, 16, rows)
    assert (bq, spt, ctas) == (16, 8, 2 if rows == "bfloat16" else 3)
    assert walkers == ctas * H100_SMS
    table = _table(298, np.arange(298), 298, False, 298 * 1024 - 5)
    items = P.ivf_items(table, 298, 1024, 298 * 1024 - 5, walkers, spt)
    got, count = _covered(items)
    assert count == len(got) == 298 * 1024 - 5
    assert P.tau_ivf_walkers(298, 1024, 8, 256, 16, H100_SMS, rows) == \
        min(walkers, 298)  # one 16-row item per tile


def test_workspace_bytes():
    # Main and tau partial lists, tau, the bf16 query planes, each on a
    # 256-byte boundary.
    assert P.workspace_bytes(8, 16, 264, 264, 256, True) == (
        4 * 8 * 264 * 16 * 4 + 256 + 6 * 8 * 256)
    assert P.workspace_bytes(1, 1, 1, 1, 1, False) == 5 * 256


@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("b,d,tile_n", [(8, 256, 1024), (1, 37, 1000),
                                        (65, 2048, 128)])
def test_float_ivf_items_cover_every_real_row_once(rows, dynamic, b, d,
                                                   tile_n):
    # K3's walkers as its plan deals them: every real row of the tabled
    # tiles once, with a ragged last tile and -1 padding, for static and
    # dynamic row counts.
    rng = np.random.default_rng(b + d)
    tiles, slots = 40, 30
    n_rows = (tiles - 1) * tile_n + tile_n // 5 + 3
    real = np.append(np.sort(rng.choice(tiles - 1, 20, replace=False)),
                     tiles - 1)
    table = _table(tiles, real, slots, dynamic, n_rows)
    bq, walkers, spt = P.ivf_plan(slots, tile_n, b, d, 16, H100_SMS, rows)
    assert bq == (16 if b <= 16 else 64) and spt == -(-tile_n // P.TN)
    items = P.ivf_items(table, slots, tile_n, n_rows, walkers, spt)
    got, count = _covered(items)
    want = [r for t in real
            for r in range(t * tile_n, min((t + 1) * tile_n, n_rows))]
    assert count == len(want) and got == sorted(want)
