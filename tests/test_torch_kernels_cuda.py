"""The CUDA kernels of the port against their plain PyTorch versions.

Needs a CUDA GPU and nvcc (the kernels compile at first use); without a
GPU every test here skips. This file imports no jax, so on a machine
without it run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: f32 rows 1e-5 and bf16 rows 1e-4 on unit-norm operands (the
same f32 products summed in another order); int8 exact. Ids agree up to
swaps between scores within the tolerance, and every exact tie keeps the
lower id. The IVF kernels (K3, K4) are held the same way, over tile
tables with -1 padding, a ragged last tile and the dynamic row count.
The int8 path of K2 and K4 (cp.async staging, int8 tensor-core MMA, a
16-query block up to B = 16) exactly at its edges: D in {1, 33, 37,
1024}, B at the block switch, k up to 128 (K4 256), -128 and 127, ties
across sub-tiles, tiles and CTAs, rows at addresses that are not 16-byte
aligned. The stream sums: within 1e-5 of the sum of absolute values (float32
partial sums in another order), exactly for int8 data whose partial sums
stay below 2^24; the busy kernel's chains bit for bit. The probes of
K1/K2: the anatomy's "stage" bit for bit, "score" within 1e-5 of the
largest |score| (int8 exactly), "compare" exactly; the counted fold's
ids, values and counters exactly on integer-valued scores. The keys,
``bf16_row_reduce`` and the int4 kernels bit for bit (the folds also at
their edges: depths, batches across clusters of query blocks, ragged row
counts, extremes, all-negative products, unaligned rows); ``stream_sum``
the same bits on two calls of every launch shape. K1 under a caller's
plan (the tuner's query block and splits) torch.equal to its default
plan. K1c (the bf16 compare fold): values bf16 and within one bf16 ulp
of the largest |value| on unit rows (the kernel's f32 sums and the plain
version's may straddle a rounding midpoint), ids up to swaps within it;
torch.equal on integer grids, whose scores are exact in any order.
K2r (the rounded int8 fold: its own kernel ``csrc/cluster_topk.cu``
past one 16-query block, K2's kernel with its rounding flag up to it)
torch.equal at its edges: depths on element loads and TMA and a streamed
query block, rows[1:] and a copy at an odd address, B across the query
block, the cluster and its groups, k up to 128, N = 1024 (tau = -inf),
{-1, 0, 1} grids with signed scales and a zero query, one and two query
groups a CTA; its plan's shared memory and workspace equal to the
source's; a failed build or launch raises. K1r and K1c on bf16 rows (the
same kernel, wgmma bf16 on three query planes or one; K1's kernel in the
fold's score mode on the split route): torch.equal to their plain
versions on {-1, 0, 1} grids at depths on element loads and TMA, rows[1:]
and a copy at an odd address, B across the split route's 16, the query
block, the cluster and its groups, k up to 128, N = 1024, a zero query
(K1c: half masks and a misaligned N too), one and two query groups a
CTA; within one bf16 ulp of the largest |value| on unit rows; the route
(``.split_launches``) as ``bf16_cluster_route`` says; the plan against
the source; a failed build or launch raises. BM25's sparse top-k
(``csrc/bm25_sparse.cu``): torch.equal to its plain version and to the
sort-based torch route on integer impacts (the flat budget cut in a
term, the window fetch, repeated terms, padding rows, fewer than k
matches, a mask, postings past the dump row, ties, 70 slots, one row;
slabs of 2^12 and 2^15); on float impacts equal to its
plain version and within T - 1 float32 roundings of float64 totals;
three kernels and one ``.launches`` a call; the retriever's route.
"""

import dataclasses

import pytest
import torch

from a_nice_rag_tpu_torch.ops.kernels import (
    anatomy,
    bf16_row_reduce,
    bf16_row_reduce_torch,
    fused_dense_top_k,
    fused_dense_top_k_bf16_compare,
    fused_dense_top_k_bf16_compare_torch,
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_torch,
    fused_dense_top_k_torch,
    int4,
    int4_fold_max,
    int4_scores,
    int8_fold_max,
    int8_fold_max_torch,
    ivf_dense_top_k,
    ivf_dense_top_k_int8,
    ivf_dense_top_k_int8_torch,
    ivf_dense_top_k_torch,
    stream_sum,
    stream_sum_busy,
    stream_sum_busy_torch,
    stream_sum_torch,
    xpack_keys,
    xpack_keys_torch,
    xpack_values,
)
from a_nice_rag_tpu_torch.ops.kernels import cluster_probe
from a_nice_rag_tpu_torch.ops.kernels import cluster_topk, topk_plan
from a_nice_rag_tpu_torch.ops.kernels import fused_dense_top_k_int8_rounded
from a_nice_rag_tpu_torch.ops.kernels import fused_dense_top_k_rounded
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    SCORE_COMPARE,
    SCORE_ROUNDED,
    bf16_cluster_route,
    K2R_SPLIT_MAX_B,
    float_smem_bytes,
    int8_smem_bytes,
    split_query,
    subsample_tau,
    subsample_tau_torch,
    workspace_bytes_of_source,
)
from a_nice_rag_tpu_torch.ops.kernels import keys as keys_module
from a_nice_rag_tpu_torch.ops.kernels import stream
from a_nice_rag_tpu_torch.ops.kernels.stream import abs_total
from a_nice_rag_tpu_torch.probes import bf16_fold
from a_nice_rag_tpu_torch.probes import int4 as int4_probe
from a_nice_rag_tpu_torch.probes import kernel_anatomy
from a_nice_rag_tpu_torch.ops.quantized import (
    quantize_embeddings,
    quantize_queries,
)
from a_nice_rag_tpu_torch.testing.parity import check_top_k
from a_nice_rag_tpu_torch.testing.timing import profiled_device_ms

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels compile and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit(x):
    return x / x.norm(dim=1, keepdim=True)


def _ties_kept_by_lower_id(vals, ids):
    same = vals[:, 1:] == vals[:, :-1]
    valid = ids[:, 1:] >= 0
    return bool((ids[:, 1:] > ids[:, :-1])[same & valid].all())


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,b,k,masked", [
    (70_001, 7, 32, False), (70_001, 130, 128, True), (4097, 1, 1, True),
    (300, 3, 100, True),
])
def test_cuda_fused_matches_plain(cuda_device, emb_dtype, n, b, k, masked):
    g = torch.Generator().manual_seed(n + b + k)
    emb = _unit(torch.randn((n, 96), generator=g))
    emb[n // 2:n // 2 + 50] = emb[:50]  # exact ties across splits
    emb = emb.to(getattr(torch, emb_dtype))
    q = _unit(torch.randn((b, 96), generator=g))
    mask = (torch.rand(n, generator=g) < 0.5) if masked else None
    emb, q = emb.to(cuda_device), q.to(cuda_device)
    mask = None if mask is None else mask.to(cuda_device)
    before = fused_dense_top_k.launches
    kv, ki = fused_dense_top_k(emb, q, k, mask=mask)
    torch.cuda.synchronize()
    assert fused_dense_top_k.launches == before + 1
    pv, pi = fused_dense_top_k_torch(emb, q, k, mask=mask)
    check_top_k(pv, pi, kv, ki, 1e-5 if emb_dtype == "float32" else 1e-4)
    assert _ties_kept_by_lower_id(kv, ki)
    if mask is not None:
        got = ki[ki >= 0].long()
        assert bool(mask[got].all())


@pytest.mark.parametrize("n,d,b,k,masked", [
    (70_001, 96, 7, 32, False), (50_000, 37, 65, 128, True),
    (1000, 1024, 3, 25, False),
])
def test_cuda_fused_int8_matches_plain(cuda_device, n, d, b, k, masked):
    g = torch.Generator().manual_seed(n + d)
    emb = _unit(torch.randn((n, d), generator=g))
    emb[n // 2:n // 2 + 50] = emb[:50]
    qd = quantize_embeddings(emb.to(cuda_device))
    qv, qs = quantize_queries(torch.randn((b, d), generator=g).to(cuda_device))
    mask = (torch.rand(n, generator=g) < 0.5) if masked else None
    mask = None if mask is None else mask.to(cuda_device)
    before = fused_dense_top_k_int8.launches
    kv, ki = fused_dense_top_k_int8(qd.values, qd.scales, qv, qs, k, mask=mask)
    torch.cuda.synchronize()
    assert fused_dense_top_k_int8.launches == before + 1
    pv, pi = fused_dense_top_k_int8_torch(qd.values, qd.scales, qv, qs, k,
                                          mask=mask)
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)


def _edge_rows(n, d, dev):
    """Full-range int8 rows and 256 queries: rows 0-31 copies of queries
    0-7, copied again across sub-tiles, a tile boundary and other CTAs
    (scales with them, so exact ties top the lists); all-127 and all--128
    rows and queries."""
    g = torch.Generator().manual_seed(d)
    values = torch.randint(-128, 128, (n, d), generator=g, dtype=torch.int8)
    qv = torch.randint(-128, 128, (256, d), generator=g, dtype=torch.int8)
    qv[8], qv[9] = 127, -128
    values[40], values[41] = 127, -128
    scales = torch.rand(n, generator=g) + 0.5
    values[:32] = qv[torch.arange(32) % 8]
    for start in (64, 100, n // 2, n - 40):
        values[start:start + 32] = values[:32]
        scales[start:start + 32] = scales[:32]
    qs = torch.rand(256, generator=g) + 0.5
    return [t.to(dev) for t in (values, scales, qv, qs)]


def _odd_address(t):
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 1
    return view


@pytest.mark.parametrize("d", [1, 33, 37, 1024])
@pytest.mark.parametrize("view", ["as_is", "rows_from_1", "odd_address"])
def test_cuda_int8_path_edges_k2(cuda_device, d, view):
    values, scales, qv, qs = _edge_rows(20_011, d, cuda_device)
    if view == "rows_from_1":
        values, scales = values[1:], scales[1:]
    elif view == "odd_address":
        values = _odd_address(values)
    for b in (8, 16, 17, 64, 65, 256):
        for k in (1, 25, 128):
            args = (values, scales, qv[:b], qs[:b], k)
            kv, ki = fused_dense_top_k_int8(*args)
            pv, pi = fused_dense_top_k_int8_torch(*args)
            torch.cuda.synchronize()
            assert torch.equal(ki, pi) and torch.equal(kv, pv), (b, k)


@pytest.mark.parametrize("d", [1, 33, 37, 1024])
@pytest.mark.parametrize("odd", [False, True])
def test_cuda_int8_path_edges_k4(cuda_device, d, odd):
    tile_n, n_real = 1024, 20_011  # last tile ragged (555 rows)
    values, scales, qv, qs = _edge_rows(n_real, d, cuda_device)
    npad = -(-n_real // tile_n) * tile_n
    values = torch.cat([values, values[:npad - n_real]])
    scales = torch.cat([scales, scales[:npad - n_real]])
    if odd:
        values = _odd_address(values)
    tiles = npad // tile_n
    full = torch.arange(tiles, dtype=torch.int32)
    part = torch.full((tiles,), -1, dtype=torch.int32)
    part[:5] = torch.tensor([0, 3, 10, 11, tiles - 1], dtype=torch.int32)
    dynamic = torch.cat([part, torch.tensor([n_real], dtype=torch.int32)])
    ks = (1, 25, 128, 256)
    case = 0
    for table, nr in ((full, n_real), (part, n_real), (dynamic, 0)):
        table = table.to(cuda_device)
        for b in (8, 16, 17, 64, 65, 256):
            k = ks[case % len(ks)]
            case += 1
            args = (values, scales, qv[:b], qs[:b], table, k)
            kv, ki = ivf_dense_top_k_int8(*args, tile_n=tile_n, n_real=nr)
            pv, pi = ivf_dense_top_k_int8_torch(*args, tile_n=tile_n,
                                                n_real=nr)
            torch.cuda.synchronize()
            assert torch.equal(ki, pi) and torch.equal(kv, pv), (b, k, nr)


def test_cuda_int8_shared_memory_matches_plan(cuda_device):
    for bq, d, k in ((16, 1, 1), (16, 37, 256), (64, 1024, 25),
                     (64, 1040, 128)):
        assert int8_smem_bytes(bq, d, k) == topk_plan.smem_bytes(bq, d, k)


@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
def test_cuda_float_shared_memory_matches_plan(cuda_device, rows):
    # The float path's shared-memory sum at the 16/64 switch, across
    # depths, with the query block resident and streamed; the workspace.
    for bq in (16, 64):
        for d in (1, 33, 37, 256, 1024, 2048, 4096):
            for k in (1, 32, 128):
                for qres in (False, True):
                    assert float_smem_bytes(bq, d, k, rows, qres) == \
                        topk_plan.smem_bytes(bq, d, k, rows, qres)
                    # K1c's one query plane.
                    one = topk_plan.COMPARE_PLANES
                    assert float_smem_bytes(bq, d, k, rows, qres, one) == \
                        topk_plan.smem_bytes(bq, d, k, rows, qres, one)
    for args in ((256, 32, 33, 32, 256, True), (8, 16, 264, 264, 37, False),
                 (1, 1, 1, 1, 1, True)):
        assert workspace_bytes_of_source(*args) == \
            topk_plan.workspace_bytes(*args)


def _float_edge_rows(n, d, dev, dtype):
    """Unit rows and 256 unit queries: rows 0-31 copies of queries 0-7
    (each query's best rows), copied again across sub-tiles, a tile
    boundary and other CTAs, so exact ties sit at the top of the
    lists."""
    g = torch.Generator().manual_seed(d + 7)
    emb = _unit(torch.randn((n, d), generator=g))
    q = _unit(torch.randn((256, d), generator=g))
    emb[:32] = q[torch.arange(32) % 8]
    for start in (64, 100, n // 2, n - 40):
        emb[start:start + 32] = emb[:32]
    return emb.to(dtype).to(dev), q.to(dev)


@pytest.mark.parametrize("d", [1, 33, 37, 1024, 2048])
@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
def test_cuda_float_path_edges_k1(cuda_device, d, rows):
    # K1 on the float path's edges: depths that are no multiple of a
    # 16-byte segment or that stream the query block, B across the 16/64
    # switch, views at addresses that are not 16-byte aligned, a mask
    # that leaves fewer than k candidates (tau = -inf), and ties.
    emb, q = _float_edge_rows(20_011, d, cuda_device, getattr(torch, rows))
    tol = 1e-5 if rows == "float32" else 1e-4
    few = torch.zeros(emb.shape[0], dtype=torch.bool, device=cuda_device)
    few[::997] = True
    for view in (emb, emb[1:]):
        for b, k, mask in ((1, 1, None), (8, 25, None), (16, 128, few),
                           (17, 32, None), (65, 128, None), (256, 7, few)):
            m = None if mask is None else mask[:view.shape[0]]
            kv, ki = fused_dense_top_k(view, q[:b], k, mask=m)
            pv, pi = fused_dense_top_k_torch(view, q[:b], k, mask=m)
            torch.cuda.synchronize()
            check_top_k(pv, pi, kv, ki, tol)
            assert _ties_kept_by_lower_id(kv, ki), (b, k)


@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
def test_cuda_k1_plan_override_equals_the_default_plan(cuda_device, rows):
    # The tuner's overrides (query block 16 or 64, splits from 1 to past
    # the tiles) spread the work only: values and ids torch.equal to the
    # default plan's, masked or not, at B across the block switch.
    emb, q = _float_edge_rows(70_001, 96, cuda_device, getattr(torch, rows))
    mask = torch.rand(emb.shape[0], device=cuda_device) < 0.7
    for b, k in ((1, 16), (8, 32), (17, 25), (256, 128)):
        for m in (None, mask):
            want = fused_dense_top_k(emb, q[:b], k, mask=m)
            for plan in ((16, 1), (64, 7), (16, 600), (64, None),
                         (None, 3)):
                got = fused_dense_top_k(emb, q[:b], k, mask=m, plan=plan)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]) and \
                    torch.equal(got[1], want[1]), (b, k, plan)


@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
def test_cuda_subsample_tau_bounds_the_kth_score(cuda_device, rows):
    g = torch.Generator().manual_seed(3)
    emb = _unit(torch.randn((50_000, 64), generator=g)).to(
        getattr(torch, rows)).to(cuda_device)
    q = _unit(torch.randn((20, 64), generator=g)).to(cuda_device)
    for k, mask in ((16, None), (100, torch.rand(50_000, generator=g) < 0.5),
                    (8, torch.arange(50_000) % 64 == 1)):
        m = None if mask is None else mask.to(cuda_device)
        tau = subsample_tau(emb, q, k, m)
        want = subsample_tau_torch(emb, q, k, m)
        kth = fused_dense_top_k_torch(emb, q, k, mask=m)[0][:, -1]
        torch.cuda.synchronize()
        assert bool((tau <= kth).all())
        assert torch.equal(torch.isneginf(tau), torch.isneginf(want))
        assert bool(((tau - want).abs() <= 1e-4)[torch.isfinite(want)].all())
    # The query split on the card: K1's staged words hold its planes.
    assert split_query(q).shape == (3, 20, 64)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
def test_cuda_bf16_compare_matches_plain(cuda_device, rows, q_dtype):
    # K1c on unit rows (masked or not, N misaligned, B across the 16/64
    # switch), then on an integer grid (torch.equal).
    g = torch.Generator().manual_seed(11)
    n, d = 70_001, 96
    emb = _unit(torch.randn((n, d), generator=g))
    emb[n // 2:n // 2 + 50] = emb[:50]
    emb = emb.to(getattr(torch, rows)).to(cuda_device)
    q = _unit(torch.randn((130, d), generator=g)).to(
        getattr(torch, q_dtype)).to(cuda_device)
    mask = (torch.rand(n, generator=g) < 0.5).to(cuda_device)
    for b, k, m in ((1, 1, None), (7, 32, mask), (130, 128, None),
                    (17, 25, mask)):
        before = fused_dense_top_k_bf16_compare.launches
        kv, ki = fused_dense_top_k_bf16_compare(emb, q[:b], k, mask=m)
        torch.cuda.synchronize()
        assert fused_dense_top_k_bf16_compare.launches == before + 1
        pv, pi = fused_dense_top_k_bf16_compare_torch(emb, q[:b], k, mask=m)
        assert torch.equal(kv, kv.bfloat16().float())
        check_top_k(pv, pi, kv, ki, 2.0 ** -8)
        assert _ties_kept_by_lower_id(kv, ki)
    ints = torch.randint(-1, 2, (n, 64), generator=g).to(cuda_device)
    qi = (2 * torch.randint(0, 2, (64, 64), generator=g) - 1).to(
        cuda_device)
    for b, k, m in ((8, 16, None), (64, 128, mask)):
        args = (ints.to(getattr(torch, rows)), qi[:b].to(
            getattr(torch, q_dtype)), k)
        kv, ki = fused_dense_top_k_bf16_compare(*args, mask=m)
        pv, pi = fused_dense_top_k_bf16_compare_torch(*args, mask=m)
        torch.cuda.synchronize()
        assert torch.equal(ki, pi) and torch.equal(kv, pv), (b, k)


def test_cuda_wrapper_raises_instead_of_falling_back(cuda_device):
    emb = torch.zeros((10, 4), device=cuda_device)
    with pytest.raises(ValueError):
        fused_dense_top_k(emb, torch.zeros((2, 4)), 3)  # queries on the CPU
    with pytest.raises(ValueError):
        fused_dense_top_k(emb, torch.zeros((2, 4), device=cuda_device), 129)


@pytest.mark.parametrize("rows", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("tile_n,b,k,dynamic", [
    (1024, 8, 16, False), (2048, 1, 256, True), (1024, 130, 128, False),
    (512, 3, 1, True),
])
def test_cuda_ivf_matches_plain(cuda_device, rows, tile_n, b, k, dynamic):
    g = torch.Generator().manual_seed(tile_n + b + k)
    n_tiles, n_real = 21, 20 * tile_n + 37  # last tile ragged
    emb = _unit(torch.randn((n_tiles * tile_n, 64), generator=g))
    emb[5 * tile_n:5 * tile_n + 50] = emb[:50]  # exact ties across tiles
    picked = torch.randperm(n_tiles, generator=g)[:12].sort().values
    picked = torch.cat([picked[picked != 20], torch.tensor([20])])
    table = torch.full((16,), -1, dtype=torch.int32)
    table[:picked.numel()] = picked.to(torch.int32)
    if dynamic:
        table = torch.cat([table, torch.tensor([n_real], dtype=torch.int32)])
    table = table.to(cuda_device)
    q = _unit(torch.randn((b, 64), generator=g)).to(cuda_device)
    nr = 0 if dynamic else n_real
    if rows == "int8":
        qd = quantize_embeddings(emb.to(cuda_device))
        qd.scales[n_real:] = 0.0
        qv, qs = quantize_queries(q)
        args = (qd.values, qd.scales, qv, qs, table, k)
        before = ivf_dense_top_k_int8.launches
        kv, ki = ivf_dense_top_k_int8(*args, tile_n=tile_n, n_real=nr)
        torch.cuda.synchronize()
        assert ivf_dense_top_k_int8.launches == before + 1
        pv, pi = ivf_dense_top_k_int8_torch(*args, tile_n=tile_n, n_real=nr)
        assert torch.equal(ki, pi) and torch.equal(kv, pv)
    else:
        e = emb.to(getattr(torch, rows)).to(cuda_device)
        before = ivf_dense_top_k.launches
        kv, ki = ivf_dense_top_k(e, q, table, k, tile_n=tile_n, n_real=nr)
        torch.cuda.synchronize()
        assert ivf_dense_top_k.launches == before + 1
        pv, pi = ivf_dense_top_k_torch(e, q, table, k, tile_n=tile_n,
                                       n_real=nr)
        check_top_k(pv, pi, kv, ki, 1e-5 if rows == "float32" else 1e-4)
        assert _ties_kept_by_lower_id(kv, ki)
    live = ki[ki >= 0].long()
    assert bool((live < n_real).all())
    assert bool(torch.isin(live // tile_n, picked.to(cuda_device)).all())


@pytest.mark.parametrize("d", [1, 33, 37, 1024])
@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
def test_cuda_float_path_edges_k3(cuda_device, d, rows):
    # K3 on the float path's edges over full, partial and dynamic tables
    # of a ragged last tile, aligned and at an unaligned base, k up to 256.
    tile_n, n_real = 1024, 20_011
    emb, q = _float_edge_rows(n_real, d, cuda_device, getattr(torch, rows))
    npad = -(-n_real // tile_n) * tile_n
    emb = torch.cat([emb, emb[:npad - n_real]])
    tol = 1e-5 if rows == "float32" else 1e-4
    tiles = npad // tile_n
    full = torch.arange(tiles, dtype=torch.int32)
    part = torch.full((tiles,), -1, dtype=torch.int32)
    part[:5] = torch.tensor([0, 3, 10, 11, tiles - 1], dtype=torch.int32)
    dynamic = torch.cat([part, torch.tensor([n_real], dtype=torch.int32)])
    shifted = torch.empty((npad + 1, d), dtype=emb.dtype,
                          device=cuda_device)
    shifted[1:] = emb
    case = 0
    for view in (emb, shifted[1:]):
        for table, nr in ((full, n_real), (part, n_real), (dynamic, 0)):
            table = table.to(cuda_device)
            for b in (1, 8, 16, 17, 65):
                k = (1, 16, 128, 256)[case % 4]
                case += 1
                kv, ki = ivf_dense_top_k(view, q[:b], table, k,
                                         tile_n=tile_n, n_real=nr)
                pv, pi = ivf_dense_top_k_torch(view, q[:b], table, k,
                                               tile_n=tile_n, n_real=nr)
                torch.cuda.synchronize()
                check_top_k(pv, pi, kv, ki, tol)
                assert _ties_kept_by_lower_id(kv, ki), (b, k, nr)


def test_cuda_ivf_wrapper_raises_instead_of_falling_back(cuda_device):
    emb = torch.zeros((256, 4), device=cuda_device)
    table = torch.tensor([0, -1], dtype=torch.int32, device=cuda_device)
    q = torch.zeros((2, 4), device=cuda_device)
    with pytest.raises(ValueError):  # queries on the CPU
        ivf_dense_top_k(emb, q.cpu(), table, 3, tile_n=128, n_real=256)
    with pytest.raises(ValueError):
        ivf_dense_top_k(emb, q, table, 257, tile_n=128, n_real=256)


def _stream_parts(g, dtype, m, rows, cols):
    if dtype == "int8":
        return [torch.randint(-127, 128, (rows, cols), generator=g,
                              dtype=torch.int8) for _ in range(m)]
    return [torch.randn((rows, cols), generator=g).to(getattr(torch, dtype))
            for _ in range(m)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m,rows,cols,biased", [
    (1, 100_003, 256, False), (2, 4099, 33, True), (8, 1, 7, True),
    (3, 65_536, 256, False),
])
def test_cuda_stream_sum_matches_plain(cuda_device, dtype, m, rows, cols,
                                       biased):
    # f32 partial sums in another order: within 1e-5 of sum |x|.
    g = torch.Generator().manual_seed(rows + m)
    parts = [p.to(cuda_device) for p in _stream_parts(g, dtype, m, rows, cols)]
    bias = torch.tensor([3.25], device=cuda_device) if biased else None
    before = stream_sum.launches
    got = stream_sum(parts, bias)
    torch.cuda.synchronize()
    assert stream_sum.launches == before + 1
    assert got.shape == () and got.dtype == torch.float32
    ref = stream_sum_torch(parts, bias)
    assert abs(float(got) - float(ref)) <= 1e-5 * (abs_total(parts) + 3.25)


def test_cuda_stream_sum_misaligned_views_and_launch_shapes(cuda_device):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4097, 129), generator=g).to(torch.bfloat16).to(
        cuda_device)
    flat = x.reshape(-1)
    tol = 1e-5 * abs_total(x)
    for start in (1, 3, 7):  # views that start mid-vector
        view = flat[start:]
        assert view.data_ptr() % 16 != 0
        assert abs(float(stream_sum(view)) - float(stream_sum_torch(view))) \
            <= tol
    ref = float(stream_sum_torch(x))
    for ctas in (1, 2, 4, 8):
        for unroll in (1, 2, 4, 8):
            got = stream_sum(x, ctas_per_sm=ctas, unroll=unroll)
            assert abs(float(got) - ref) <= tol, (ctas, unroll)
    assert float(stream_sum(x)) == float(stream_sum(x))  # a fixed order


def test_cuda_stream_sum_one_launch_same_bits(cuda_device):
    # One launch a call, the partials and ticket kept across calls: every
    # launch shape within 1e-5 of sum |x|, and two calls the same bits.
    g = torch.Generator().manual_seed(11)
    x = torch.randn((100_003, 64), generator=g).to(torch.bfloat16).to(
        cuda_device)
    flat = x.reshape(-1)
    parts = [x, flat[3:], flat[:77]]  # a view that starts mid-vector
    tol = 1e-5 * abs_total(parts)
    ref = float(stream_sum_torch(parts))
    for ctas in (1, 2, 4, 8):
        for unroll in stream.UNROLLS:
            launch = dict(ctas_per_sm=ctas, unroll=unroll)
            before = stream_sum.launches
            first = stream_sum(parts, **launch)
            second = stream_sum(parts, **launch)
            torch.cuda.synchronize()
            assert stream_sum.launches == before + 2
            assert torch.equal(first, second), launch
            assert abs(float(first) - ref) <= tol, launch


def test_cuda_stream_sum_int8_exact(cuda_device):
    # Every partial sum stays below 2^24, so float32 holds it exactly: a
    # dropped or doubled tile would show.
    g = torch.Generator().manual_seed(6)
    x = torch.randint(0, 2, (1 << 20, 15), generator=g,
                      dtype=torch.int8).to(cuda_device)
    want = float(x.sum(dtype=torch.int64))
    assert want < 2 ** 24
    assert float(stream_sum(x)) == want
    assert float(stream_sum([x, x[:1000]], torch.tensor(
        [2.0], device=cuda_device))) == want + float(
            x[:1000].sum(dtype=torch.int64)) + 2.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("x_iters,grid,tile_rows", [
    (0, 7, 16), (2, 132, 16), (5, 64, 3),
])
def test_cuda_stream_sum_busy_matches_plain(cuda_device, dtype, x_iters,
                                            grid, tile_rows):
    g = torch.Generator().manual_seed(x_iters + grid)
    (emb,) = _stream_parts(g, dtype, 1, 30_011, 64)
    emb = emb.to(cuda_device)
    seed = torch.tensor(0.5, device=cuda_device)
    before = stream_sum_busy.launches
    out, work = stream_sum_busy(emb, seed, x_iters, grid, tile_rows)
    torch.cuda.synchronize()
    assert stream_sum_busy.launches == before + 1
    ref_out, ref_work = stream_sum_busy_torch(emb, seed, x_iters, grid,
                                              tile_rows)
    assert torch.equal(work, ref_work)  # bit for bit
    assert abs(float(out) - float(ref_out)) <= 1e-5 * (abs_total(emb) + 0.5)


def test_cuda_stream_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros((10, 4), device=cuda_device)
    with pytest.raises(ValueError):
        stream_sum(x, torch.zeros(1))  # bias on the CPU
    with pytest.raises(TypeError):
        stream_sum([x, x.to(torch.bfloat16)])
    with pytest.raises(ValueError):
        stream_sum(x.T)  # not contiguous
    with pytest.raises(ValueError):
        stream_sum_busy(x, torch.zeros((), device=cuda_device), 1, 0)


def _rows(g, kind, n, d, b, integer):
    """(rows, queries, scales, q_scales) on the CPU: unit or small-integer
    f32/bf16 rows with f32 queries, or quantized int8 rows and queries."""
    if kind == "int8":
        emb = _unit(torch.randn((n, d), generator=g))
        emb[n // 2:n // 2 + 50] = emb[:50]
        qd = quantize_embeddings(emb)
        qv, qs = quantize_queries(torch.randn((b, d), generator=g))
        return qd.values, qv, qd.scales, qs
    if integer:  # every score an exact integer: ties everywhere
        emb = torch.randint(-2, 3, (n, d), generator=g).float()
        q = torch.randint(-2, 3, (b, d), generator=g).float()
    else:
        emb, q = (_unit(torch.randn((n, d), generator=g)),
                  _unit(torch.randn((b, d), generator=g)))
    return emb.to(getattr(torch, kind)), q, None, None


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,d,b,k", [
    (70_001, 96, 7, 32), (50_000, 40, 130, 25), (4097, 256, 1, 1),
])
def test_cuda_anatomy_modes_match_plain(cuda_device, kind, n, d, b, k):
    # "stage" bit for bit; "score" within 1e-5 of max |score| (f32 sums in
    # another order; int8 exact); "compare" exactly, at a threshold no
    # score lies near; "full" as K1/K2 are held.
    g = torch.Generator().manual_seed(n + d + b)
    rows, q, scales, q_scales = (
        None if t is None else t.to(cuda_device)
        for t in _rows(g, kind, n, d, b, integer=False))
    wrapper = (anatomy.anatomy_top_k if scales is None
               else anatomy.anatomy_top_k_int8)
    before = wrapper.launches
    kernel_anatomy.check(rows, q, k, scales, q_scales)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 3  # full goes through K1/K2


def test_cuda_anatomy_score_keeps_negative_maxima(cuda_device):
    # Rows whose best score is negative or zero, spread over many CTAs:
    # the atomic float max must order them as floats.
    emb = torch.tensor([[-1.0, 0.0], [-2.0, 0.0], [-3.0, 0.0]],
                       device=cuda_device).repeat(7000, 1)
    q = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [2.0, 0.0]],
                     device=cuda_device)
    got = anatomy.anatomy_top_k(emb, q, 4, "score")
    assert torch.equal(got, anatomy.anatomy_top_k_torch(emb, q, 4, "score"))
    assert got.tolist() == [-1.0, 0.0, 3.0, -2.0]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,d,b,k", [
    (300_007, 32, 70, 32), (40_000, 64, 3, 128), (5000, 8, 256, 1),
])
def test_cuda_counted_fold_matches_plain(cuda_device, kind, n, d, b, k):
    # Exact: integer f32/bf16 scores and int8 products need one rounding
    # (none for f32), so kernel and plain version see the same scores and
    # every counter must agree; the ids and values equal K1/K2's.
    g = torch.Generator().manual_seed(n + k)
    rows, q, scales, q_scales = (
        None if t is None else t.to(cuda_device)
        for t in _rows(g, kind, n, d, b, integer=True))
    for use_tau in (False, True):
        if scales is None:
            tau = anatomy.subsample_tau(rows, q, k) if use_tau else None
            got = anatomy.fused_top_k_counted(rows, q, k, tau)
            want = anatomy.fused_top_k_counted_torch(rows, q, k, tau)
            ref = fused_dense_top_k(rows, q, k)
        else:
            tau = (anatomy.subsample_tau_int8(rows, scales, q, k)
                   if use_tau else None)
            args = (rows, scales, q, q_scales, k)
            got = anatomy.fused_top_k_counted_int8(*args, tau)
            want = anatomy.fused_top_k_counted_int8_torch(*args, tau)
            ref = fused_dense_top_k_int8(*args)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert torch.equal(a, w), use_tau
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        splits = (anatomy.split_plan(n, b, d, k, kind, cuda_device).splits
                  if scales is None
                  else anatomy.split_plan_int8(n, b, d, k, cuda_device).splits)
        assert got[2].shape == (b, splits, 4)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, (1 << 20) + 13])
def test_cuda_keys_bit_exact(cuda_device, n, offset):
    # offset: the input starts that many words into its buffer, so its
    # head, vectors and tail fall on each phase of the 16-byte grid; the
    # output lies on the input's phase.
    inf = float("inf")
    special = torch.tensor([-inf, -3.3e38, -1.0, -2e-38, -1e-45, -0.0, 0.0,
                            1e-45, 2e-38, 0.5, 1.0, 3.3e38, inf])
    g = torch.Generator().manual_seed(9 + n)
    vals = torch.cat([special, 10 * torch.randn(n, generator=g)])[:n]
    x = torch.empty(offset + n, device=cuda_device)[offset:]
    x.copy_(vals)
    before = xpack_keys.launches, xpack_values.launches
    keys = xpack_keys(x)
    k_view = torch.empty(offset + n, dtype=torch.int32,
                         device=cuda_device)[offset:]
    k_view.copy_(keys)
    back = xpack_values(k_view)
    torch.cuda.synchronize()
    launched = int(n > 0)
    assert (xpack_keys.launches, xpack_values.launches) == (
        before[0] + launched, before[1] + launched)
    assert keys.shape == back.shape == (n,)
    if n:
        assert keys.data_ptr() % 16 == back.data_ptr() % 16 == 4 * offset
    assert torch.equal(keys, xpack_keys_torch(x))
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))
    if n == 0:
        return
    for fn, arg in ((xpack_keys, x), (xpack_values, k_view)):
        assert profiled_device_ms(lambda: fn(arg), n=3)[1] == 1.0
    ordered = x[torch.argsort(keys)]
    assert bool((ordered[1:] >= ordered[:-1]).all())


def test_cuda_keys_bad_launch_raises(cuda_device):
    # A head that leaves the vectors off the input's 16-byte grid: the
    # kernel refuses the launch, the wrapper raises and counts nothing.
    x = torch.randn(64, device=cuda_device)
    plan = keys_module.key_plan(64, 0, 1)._replace(head=1)
    before = xpack_keys.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        keys_module._flip(xpack_keys, "anr_xpack_keys", x, torch.int32,
                          plan)
    assert xpack_keys.launches == before
    # An output on another 16-byte phase than the input: refused too.
    out = torch.empty(64, dtype=torch.int32, device=cuda_device)
    p = keys_module.key_plan(63, 1, 1)
    stream = torch.cuda.current_stream().cuda_stream
    assert keys_module._library().anr_xpack_keys(
        x[1:].data_ptr(), out.data_ptr(), 63, p.head, p.unroll, p.grid,
        stream) != 0


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("rows,width,integer", [
    (128, 8192, False), (7, 1, False), (3, 65_536, True), (33, 1000, True),
    (1, 65_536, False), (256, 16_384, True), (4096, 1001, True),
    (7, 4097, False), (256, 16_383, False),
])
def test_cuda_bf16_row_reduce_matches_plain(cuda_device, rows, width,
                                            integer, offset):
    # offset: the view starts that many elements into its buffer, so row
    # bases leave the 16-byte grid (as odd widths do from row 1 on).
    g = torch.Generator().manual_seed(rows + width)
    buf = torch.empty(offset + rows * width, device=cuda_device)
    x = buf[offset:].view(rows, width)
    x.copy_((torch.randint(-3, 4, (rows, width), generator=g).float()
             if integer else torch.randn((rows, width), generator=g)))
    before = bf16_row_reduce.launches
    got = bf16_row_reduce(x)
    torch.cuda.synchronize()
    assert bf16_row_reduce.launches == before + 1
    for a, w in zip(got, bf16_row_reduce_torch(x)):
        assert torch.equal(a, w)
    ref = torch.argmax(x.to(torch.bfloat16).float(), dim=1)
    assert torch.equal(got[1].long(), ref) and torch.equal(got[3].long(), ref)


def test_cuda_bf16_row_reduce_edges(cuda_device):
    # Ties across a row's warps, all-equal rows, -inf and values below the
    # mask, +-0.0, values that round to one bf16; R 1-4096, W 1-65536,
    # storage offsets; torch.equal on all four outputs, one launch a call.
    line = bf16_fold.check_edges(cuda_device)
    assert line["cases"] == (len(bf16_fold.EDGE_SHAPES)
                             * len(bf16_fold.EDGE_KINDS)
                             * len(bf16_fold.EDGE_OFFSETS))


@pytest.mark.parametrize("n,d,b", [
    (1024, 256, 128), (5001, 40, 3), (300, 8, 65), (70_000, 1024, 256),
])
def test_cuda_int4_matches_plain(cuda_device, n, d, b):
    # Exact integers throughout (float64 holds every sum: |sum| < 2^20).
    g = torch.Generator().manual_seed(n + d)
    e4 = torch.randint(-8, 8, (n, d), generator=g, dtype=torch.int8)
    q8 = torch.randint(-128, 128, (b, d), generator=g, dtype=torch.int8)
    e8 = torch.randint(-128, 128, (n, d), generator=g, dtype=torch.int8)
    q8, e4, e8 = q8.to(cuda_device), e4.to(cuda_device), e8.to(cuda_device)
    want = (q8.double() @ e4.double().T).to(torch.int32)
    packed = int4.pack_int4(e4)
    for unpack in int4.UNPACKS:
        before = int4_fold_max.launches
        got = int4_fold_max(q8, packed, unpack)
        torch.cuda.synchronize()
        assert int4_fold_max.launches == before + 1
        assert torch.equal(got, want.amax(dim=1))
        if n * b <= 1 << 24:
            assert torch.equal(int4_scores(q8, packed, unpack), want)
    assert torch.equal(int8_fold_max(q8, e8), int8_fold_max_torch(q8, e8))


@pytest.mark.parametrize("d", int4_probe.EDGE_D)
def test_cuda_fold_edges_match_plain(cuda_device, d):
    # Both unpacks and the int8 fold, torch.equal: B across the query block
    # and clusters of 1-4 blocks, N below a tile and ragged, -128/127 and
    # -8/7, all-negative products, rows not 16-byte aligned.
    out = int4_probe.check_edges(cuda_device, ds=(d,))
    assert out["cases"] == len(int4_probe.EDGE_B) * len(int4_probe.EDGE_VIEWS)


@pytest.mark.parametrize("n,d,b", [
    (5000, 1024, 300), (300, 4096, 65), (1000, 3000, 1), (64, 128, 257),
])
def test_cuda_fold_groups_and_streamed_queries(cuda_device, n, d, b):
    # B past one cluster of four query blocks (groups), and depths whose
    # query block streams through the ring instead of staying resident.
    for negative in (False, True):
        q8, e8, packed = int4_probe.edge_data(cuda_device, n, d, b, negative,
                                              n + d + b)
        assert torch.equal(int8_fold_max(q8, e8), int8_fold_max_torch(q8, e8))
        for unpack in int4.UNPACKS:
            assert torch.equal(int4_fold_max(q8, packed, unpack),
                               int4.int4_fold_max_torch(q8, packed, unpack))
            assert torch.equal(int4_scores(q8, packed, unpack),
                               int4.int4_scores_torch(q8, packed, unpack))


@pytest.mark.parametrize("b", [1, 8, 64, 256, 300])
@pytest.mark.parametrize("d", [8, 1024, 2048, 4096])
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_fold_plan_shared_memory_matches_source(cuda_device, b, d,
                                                     packed):
    plan = int4.fold_plan(10_485_760, b, d, packed)
    assert int4.source_smem_bytes(d, packed, plan.stages, plan.resident) \
        == plan.smem_bytes
    index = torch.cuda.current_device()
    assert int4.active_clusters(index, plan.cluster, plan.smem_bytes) >= 1


def test_cuda_probe_wrappers_raise_instead_of_falling_back(cuda_device):
    emb = torch.zeros((300, 8), device=cuda_device)
    q = torch.zeros((2, 8), device=cuda_device)
    with pytest.raises(ValueError):
        anatomy.anatomy_top_k(emb, q, 4, "compare")  # no threshold
    with pytest.raises(ValueError):
        anatomy.fused_top_k_counted(emb, q.cpu(), 4)
    with pytest.raises(TypeError):
        xpack_keys(torch.zeros(8, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        bf16_row_reduce(torch.zeros((2, 70_000), device=cuda_device))
    q8 = torch.zeros((2, 12), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):  # D % 8 != 0
        int4_fold_max(q8, torch.zeros((5, 6), dtype=torch.int8,
                                      device=cuda_device))


def _k2r_rows(n, d, dev, lo=-128, hi=128):
    """n + 1 int8 rows in [lo, hi) (rows[1:] start one row past a 16-byte
    boundary), scales, 512 queries and scales: rows 0-31 copies of queries
    0-7, copied again across tiles, CTAs and walkers; all-127 and all--128
    rows and queries where the range holds them."""
    g = torch.Generator().manual_seed(d + hi)
    values = torch.randint(lo, hi, (n + 1, d), generator=g, dtype=torch.int8)
    qv = torch.randint(lo, hi, (512, d), generator=g, dtype=torch.int8)
    if hi > 127:
        qv[8], qv[9] = 127, -128
        values[40], values[41] = 127, -128
    scales = torch.rand(n + 1, generator=g) + 0.5
    values[:32] = qv[torch.arange(32) % 8]
    for start in (64, 300, n // 3, n // 2, n - 40):
        values[start:start + 32] = values[:32]
        scales[start:start + 32] = scales[:32]
    qs = torch.rand(512, generator=g) + 0.5
    return [t.to(dev) for t in (values, scales, qv, qs)]


K2R_B = (1, 8, 16, 17, 64, 65, 200, 256, 257, 512)
K2R_K = (1, 25, 128)


@pytest.mark.parametrize("d", [32, 33, 1024, 2048])
@pytest.mark.parametrize("view", ["as_is", "rows_from_1", "odd_address"])
def test_cuda_k2r_edges_match_plain(cuda_device, d, view):
    n = 20 * 1024
    values, scales, qv, qs = _k2r_rows(n, d, cuda_device)
    if view == "rows_from_1":
        values, scales = values[1:], scales[1:]
    else:
        values, scales = values[:n], scales[:n]
        if view == "odd_address":
            values = _odd_address(values)
    wrapper = fused_dense_top_k_int8_rounded
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for i, b in enumerate(K2R_B):
        k = K2R_K[i % len(K2R_K)]
        args = (values, scales, qv[:b], qs[:b], k)
        before = (wrapper.launches, wrapper.split_launches)
        kv, ki = wrapper(*args)
        pv, pi = fused_dense_top_k_int8_torch(*args, rounded=True)
        torch.cuda.synchronize()
        # B <= K2R_SPLIT_MAX_B: K2's kernel with its rounding flag.
        split = int(b <= K2R_SPLIT_MAX_B)
        assert (wrapper.launches, wrapper.split_launches) == (
            before[0] + 1, before[1] + split)
        assert torch.equal(ki, pi) and torch.equal(kv, pv), (b, k)
        if split:  # the cluster kernel itself there too
            kv, ki = cluster_topk.rounded_top_k_int8(*args, sms)
            torch.cuda.synchronize()
            assert torch.equal(ki, pi) and torch.equal(kv, pv), (b, k)


@pytest.mark.parametrize("qg", [1, 2])
@pytest.mark.parametrize("n", [1024, 65_536])
def test_cuda_k2r_ties_and_query_groups(cuda_device, qg, n):
    """{-1, 0, 1} rows at D = 1024 (the TMA route): rounded scores tie
    across tiles, CTAs, clusters and walkers; doc scales of both signs and
    a zero query (+-0.0); N = 1024 leaves tau at -inf past k = 16."""
    values, _, qv, qs = _k2r_rows(n, 1024, cuda_device, -1, 2)
    values = values[:n]
    g = torch.Generator().manual_seed(n + qg)
    sign = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0).to(
        cuda_device)
    qv[0] = 0
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for b in (1, 64, 256, 257, 512):
        for k in K2R_K:
            args = (values, sign, qv[:b], qs[:b], k)
            kv, ki = cluster_topk.rounded_top_k_int8(*args, sms, qg=qg)
            pv, pi = fused_dense_top_k_int8_torch(*args, rounded=True)
            torch.cuda.synchronize()
            assert torch.equal(ki, pi) and torch.equal(kv, pv), (b, k)
            assert torch.equal(torch.signbit(kv), torch.signbit(pv))


@pytest.mark.parametrize("b", [1, 256, 512])
@pytest.mark.parametrize("d", [33, 1024, 2048])
@pytest.mark.parametrize("k", [1, 128])
def test_cuda_k2r_plan_matches_source(cuda_device, b, d, k):
    plan = cluster_topk.cluster_plan(10_485_760, b, d, k)
    assert cluster_topk.source_smem_bytes(
        plan.qg, d, k, plan.stages, plan.resident) == plan.smem_bytes
    walkers = (plan.walkers, plan.tau_walkers, plan.seed_walkers)
    assert cluster_topk.source_workspace_bytes(b, k, *walkers) == \
        cluster_topk.workspace_bytes(b, k, *walkers)
    if plan.tma:
        index = torch.cuda.current_device()
        assert cluster_topk.active_clusters(
            index, plan.qg, plan.cluster, plan.smem_bytes) >= 1


def test_cuda_k2r_raises_instead_of_falling_back(cuda_device, monkeypatch):
    values = torch.zeros((1024, 64), dtype=torch.int8, device=cuda_device)
    scales = torch.ones(1024, device=cuda_device)
    qv = torch.zeros((2, 64), dtype=torch.int8, device=cuda_device)
    qs = torch.ones(2, device=cuda_device)
    before = fused_dense_top_k_int8_rounded.launches
    # A launch the source refuses (no shared memory) raises.
    lib = cluster_topk._library()
    with pytest.raises(RuntimeError, match="anr_cluster_topk"):
        cluster_topk._launch(
            lib.anr_cluster_topk, qv.data_ptr(), qs.data_ptr(),
            values.data_ptr(), scales.data_ptr(), 2, 1024, 64, 4, 1, 1, 1, 1,
            1, 0, 0, 1, 0, 1, 0, 1, None, None, None, device=cuda_device)

    # A build that fails raises too, and nothing runs the plain version
    # (B past K2R_SPLIT_MAX_B: the cluster route).
    def broken():
        raise RuntimeError("nvcc failed building cluster_topk.cu")

    monkeypatch.setattr(cluster_topk, "_library", broken)
    qv = torch.zeros((K2R_SPLIT_MAX_B + 1, 64), dtype=torch.int8,
                     device=cuda_device)
    qs = torch.ones(K2R_SPLIT_MAX_B + 1, device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fused_dense_top_k_int8_rounded(values, scales, qv, qs, 4)
    assert fused_dense_top_k_int8_rounded.launches == before


# -- K1r / K1c on bf16 rows: the cluster kernel and its route -------------

BF16_B = (1, 16, 17, 64, 65, 200, 256, 257, 512)
BF16_K = (1, 32, 128)
BF16_FOLDS = {
    "rounded": (fused_dense_top_k_rounded, SCORE_ROUNDED,
                lambda e, q, k, mask=None: fused_dense_top_k_torch(
                    e, q, k, rounded=True)),
    "compare": (fused_dense_top_k_bf16_compare, SCORE_COMPARE,
                fused_dense_top_k_bf16_compare_torch),
}


def _bf16_rows(n, d, dev, grid):
    """n + 1 bf16 rows (rows[1:] start one row in), 512 f32 queries:
    {-1, 0, 1} rows and +-1 queries (``grid``: every score exact, ties
    everywhere), else unit rows; rows 0-31 copies of queries 0-7, copied
    again across tiles, CTAs and walkers; query 1 zero."""
    g = torch.Generator().manual_seed(d + n + grid)
    if grid:
        rows = torch.randint(-1, 2, (n + 1, d), generator=g).float()
        q = (2 * torch.randint(0, 2, (512, d), generator=g) - 1).float()
    else:
        rows = _unit(torch.randn((n + 1, d), generator=g))
        q = _unit(torch.randn((512, d), generator=g))
    rows[:32] = q[torch.arange(32) % 8]
    for start in (64, 300, n // 3, n // 2, n - 40):
        rows[start:start + 32] = rows[:32]
    q[1] = 0.0
    mask = torch.rand(n + 1, generator=g) < 0.5
    return rows.bfloat16().to(dev), q.to(dev), mask.to(dev)


def _bf16_odd(t):
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 2
    return view


@pytest.mark.parametrize("kind", ["rounded", "compare"])
@pytest.mark.parametrize("d", [32, 33, 256, 1024])
@pytest.mark.parametrize("view", ["as_is", "rows_from_1", "odd_address"])
def test_cuda_bf16_fold_edges_match_plain(cuda_device, kind, d, view):
    wrapper, score, plain = BF16_FOLDS[kind]
    n = 20 * 1024
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for grid in (True, False):
        rows, q, mask = _bf16_rows(n, d, cuda_device, grid)
        rows, mask = (rows[1:], mask[1:]) if view == "rows_from_1" else \
            (rows[:n], mask[:n])
        if view == "odd_address":
            rows = _bf16_odd(rows)
        for i, b in enumerate(BF16_B):
            k = BF16_K[i % len(BF16_K)]
            m = mask if kind == "compare" and i % 2 else None
            before = (wrapper.launches, wrapper.split_launches)
            kv, ki = wrapper(rows, q[:b], k, **({} if m is None else
                                               {"mask": m}))
            pv, pi = plain(rows, q[:b], k, mask=m)
            torch.cuda.synchronize()
            cluster = bf16_cluster_route(n, b, d, k, "bfloat16", score,
                                         rows.data_ptr() % 16 == 0)
            assert (wrapper.launches, wrapper.split_launches) == (
                before[0] + 1, before[1] + (not cluster)), (b, k)
            assert torch.equal(kv, kv.bfloat16().float())
            if grid:
                assert torch.equal(ki, pi) and torch.equal(kv, pv), (b, k)
            else:
                top = float(pv[torch.isfinite(pv)].abs().max())
                check_top_k(pv, pi, kv, ki, 2.0 ** (int(
                    torch.tensor(top).log2().floor()) - 7))
                assert _ties_kept_by_lower_id(kv, ki)
            plan = cluster_topk.cluster_plan(n, b, d, k, kind=kind)
            if grid and plan.resident and not cluster:
                # The cluster kernel itself where the route keeps K1's.
                kv, ki = cluster_topk.bf16_top_k(rows, q[:b], k, sms, kind,
                                                 m)
                torch.cuda.synchronize()
                assert torch.equal(ki, pi) and torch.equal(kv, pv), (b, k)


@pytest.mark.parametrize("kind", ["rounded", "compare"])
@pytest.mark.parametrize("qg", [1, 2])
@pytest.mark.parametrize("n", [1024, 65_536 - 37])
def test_cuda_bf16_fold_ties_and_query_groups(cuda_device, kind, qg, n):
    """{-1, 0, 1} rows at D = 64 (the TMA route; K1r's three planes stay
    resident in 128-query CTAs there): rounded scores tie across tiles,
    CTAs, clusters and walkers; a zero query (+0.0 everywhere); N = 1024
    leaves tau at -inf past k = 16; K1c also masked over a misaligned N."""
    _, score, plain = BF16_FOLDS[kind]
    if kind == "rounded" and n % 1024:
        n -= n % 1024
    rows, q, mask = _bf16_rows(n, 64, cuda_device, True)
    rows, mask = rows[:n], mask[:n]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for b in (1, 64, 256, 257, 512):
        for k in BF16_K:
            for m in (None, mask) if kind == "compare" else (None,):
                kv, ki = cluster_topk.bf16_top_k(rows, q[:b], k, sms, kind,
                                                 m, qg=qg)
                pv, pi = plain(rows, q[:b], k, mask=m)
                torch.cuda.synchronize()
                assert torch.equal(ki, pi) and torch.equal(kv, pv), (b, k)
                assert torch.equal(torch.signbit(kv), torch.signbit(pv))


@pytest.mark.parametrize("kind", ["rounded", "compare"])
@pytest.mark.parametrize("b", [17, 256, 512])
@pytest.mark.parametrize("d", [33, 256, 1024])
@pytest.mark.parametrize("k", [1, 128])
def test_cuda_bf16_cluster_plan_matches_source(cuda_device, kind, b, d, k):
    plan = cluster_topk.cluster_plan(1 << 21, b, d, k, kind=kind)
    assert cluster_topk.source_smem_bytes(
        plan.qg, d, k, plan.stages, plan.resident, kind) == plan.smem_bytes
    walkers = (plan.walkers, plan.tau_walkers, plan.seed_walkers)
    assert cluster_topk.source_workspace_bytes(b, k, *walkers, d, kind) == \
        cluster_topk.workspace_bytes(b, k, *walkers, d, kind)
    if plan.tma:
        index = torch.cuda.current_device()
        assert cluster_topk.active_clusters(
            index, plan.qg, plan.cluster, plan.smem_bytes, kind) >= 1


def test_cuda_bf16_cluster_raises_instead_of_falling_back(cuda_device,
                                                          monkeypatch):
    rows = torch.zeros((1024, 128), dtype=torch.bfloat16, device=cuda_device)
    q = torch.zeros((64, 128), device=cuda_device)
    assert bf16_cluster_route(1024, 64, 128, 4, "bfloat16", SCORE_COMPARE)
    before = fused_dense_top_k_bf16_compare.launches
    # A launch the source refuses (no shared memory) raises.
    lib = cluster_topk._library()
    with pytest.raises(RuntimeError, match="anr_cluster_topk_bf16"):
        cluster_topk._launch(
            lib.anr_cluster_topk_bf16, 2, q.bfloat16().data_ptr(),
            rows.data_ptr(), None, 64, 1024, 128, 4, 1, 1, 1, 1, 1, 0, 0, 1,
            0, 1, 0, 1, None, None, None, device=cuda_device)

    # A build that fails raises too, and nothing runs the plain version or
    # K1's kernel.
    def broken():
        raise RuntimeError("nvcc failed building cluster_topk.cu")

    monkeypatch.setattr(cluster_topk, "_library", broken)
    for fn in (fused_dense_top_k_bf16_compare, fused_dense_top_k_rounded):
        n0 = (fn.launches, fn.split_launches)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fn(rows, q, 4)
        assert (fn.launches, fn.split_launches) == n0
    assert fused_dense_top_k_bf16_compare.launches == before


def test_cuda_bf16_cluster_route_reads_no_plan(cuda_device):
    # K1's (bq, splits) steer only K1's kernel: on the cluster route a
    # valid plan= changes nothing, and the call stays there.
    n = 20 * 1024
    rows, q, _ = _bf16_rows(n, 256, cuda_device, False)
    rows, q = rows[:n], q[:64]
    for kind, (wrapper, score, _) in BF16_FOLDS.items():
        assert bf16_cluster_route(n, 64, 256, 32, "bfloat16", score)
        want = wrapper(rows, q, 32)
        split0 = wrapper.split_launches
        got = wrapper(rows, q, 32, plan=(16, 7))
        torch.cuda.synchronize()
        assert wrapper.split_launches == split0, kind
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- P4 / P5 on the cluster kernel (csrc/cluster_probe.cu) -----------------

# (row dtype, kind): the cluster kernel's probe kinds.
CLUSTER_PROBE_KINDS = [("bfloat16", "exact"), ("bfloat16", "rounded"),
                       ("bfloat16", "compare"), ("int8", "exact"),
                       ("int8", "rounded")]


def _cluster_probe_rows(rows_dtype, n, d, b, dev, grid=True):
    """(rows, queries, scales, q_scales) on the card: int8 rows and
    queries with scales, or bf16 rows ({-1, 0, 1} with ``grid``: every
    score exact in any order, else unit rows) with f32 queries; rows 0-63
    copied again past the middle (ties across walkers), query 1 zero
    (+-0.0 everywhere)."""
    g = torch.Generator().manual_seed(n + d + b)
    if rows_dtype == "int8":
        rows = torch.randint(-128, 128, (n, d), generator=g, dtype=torch.int8)
        q = torch.randint(-128, 128, (b, d), generator=g, dtype=torch.int8)
        scales = torch.rand(n, generator=g) + 0.5
        q_scales = torch.rand(b, generator=g) + 0.5
        scales[n // 2:n // 2 + 64] = scales[:64]
    elif grid:
        rows = torch.randint(-1, 2, (n, d), generator=g).float()
        q = torch.randint(-1, 2, (b, d), generator=g).float()
        scales = q_scales = None
    else:
        rows = _unit(torch.randn((n, d), generator=g))
        q = _unit(torch.randn((b, d), generator=g))
        scales = q_scales = None
    rows[n // 2:n // 2 + 64] = rows[:64]
    q[1] = 0
    if rows_dtype != "int8":
        rows = rows.bfloat16()
    return [None if t is None else t.to(dev)
            for t in (rows, q, scales, q_scales)]


def _cluster_calls(rows, q, scales, q_scales):
    """(P4, P5) wrappers and their plain versions for the rows' dtype."""
    if scales is None:
        return (lambda *a, **kw: anatomy.anatomy_top_k_cluster(rows, q, *a,
                                                               **kw),
                lambda *a, **kw: anatomy.anatomy_top_k_cluster_torch(
                    rows, q, *a, **kw),
                lambda *a, **kw: anatomy.fused_top_k_counted_cluster(
                    rows, q, *a, **kw),
                lambda *a, **kw: anatomy.fused_top_k_counted_cluster_torch(
                    rows, q, *a, **kw))
    args = (rows, scales, q, q_scales)
    return (lambda *a, **kw: anatomy.anatomy_top_k_int8_cluster(*args, *a,
                                                                **kw),
            lambda *a, **kw: anatomy.anatomy_top_k_int8_cluster_torch(
                *args, *a, **kw),
            lambda *a, **kw: anatomy.fused_top_k_counted_int8_cluster(
                *args, *a, **kw),
            lambda *a, **kw: anatomy.fused_top_k_counted_int8_cluster_torch(
                *args, *a, **kw))


@pytest.mark.parametrize("rows_dtype,kind", CLUSTER_PROBE_KINDS)
@pytest.mark.parametrize("n,b,k", [(40_000 - 37, 40, 32),
                                   (40_000 - 37, 200, 128),
                                   (600_000 + 5, 70, 1)])
def test_cuda_cluster_probe_modes_match_plain(cuda_device, rows_dtype, kind,
                                              n, b, k):
    # Every mode torch.equal to its plain version over the card's walks:
    # stage, score, compare at a listed subsample score, full and the
    # counted fold under each seed (counters equal, heap insertions
    # between the survivors and the entries); full's lists equal the
    # kind's whole call. 600,005 rows give walkers past 16 tiles.
    d = 128 if rows_dtype == "bfloat16" else 256
    rows, q, scales, q_scales = _cluster_probe_rows(rows_dtype, n, d, b,
                                                    cuda_device)
    p4, p4_plain, p5, p5_plain = _cluster_calls(rows, q, scales, q_scales)
    before = (anatomy.anatomy_top_k_cluster.launches
              + anatomy.anatomy_top_k_int8_cluster.launches)
    src = cluster_probe.source_kind(rows_dtype == "int8", kind)
    for mode in ("stage", "score"):
        active = anatomy.cluster_active_clusters(rows, b, k, kind, mode)
        got, want = p4(k, mode, kind=kind), p4_plain(k, mode, kind=kind,
                                                     active=active)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mode
    tau, lists = cluster_probe.subsample_seeds(rows, q, k, src, scales)
    thr = lists[0][:, k // 2].contiguous()
    active = anatomy.cluster_active_clusters(rows, b, k, kind, "compare")
    got = p4(k, "compare", thr, kind=kind)
    assert torch.equal(got, p4_plain(k, "compare", thr, kind=kind,
                                     active=active))
    whole = p4(k, "full", kind=kind)
    want = cluster_probe.top_k_torch(rows, q, k, src, scales, q_scales)
    torch.cuda.synchronize()
    assert torch.equal(whole[0], want[0]) and torch.equal(whole[1], want[1])
    assert (anatomy.anatomy_top_k_cluster.launches
            + anatomy.anatomy_top_k_int8_cluster.launches) == before + 4
    active = anatomy.cluster_active_clusters(rows, b, k, kind, "counted")
    for seed in ({}, {"tau": tau}, {"lists": lists}):
        got = p5(k, kind=kind, **seed)
        want = p5_plain(k, kind=kind, active=active, **seed)
        torch.cuda.synchronize()
        anatomy.check_counted(got, want, f"{kind} {sorted(seed)}")
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1],
                                                             whole[1])
        full = cluster_probe.cluster_probe("full", rows, q, k, src, scales,
                                           q_scales, **seed)
        assert torch.equal(full[0], whole[0]) and torch.equal(full[1],
                                                              whole[1])


@pytest.mark.parametrize("rows_dtype,kind", CLUSTER_PROBE_KINDS)
@pytest.mark.parametrize("qg", [1, 2])
def test_cuda_cluster_probe_query_groups(cuda_device, rows_dtype, kind, qg):
    # One and two query groups a CTA at B = 200: both warpgroups on every
    # row (its heap under a lock) or a warpgroup each.
    d = 64 if rows_dtype == "bfloat16" else 128
    n, b, k = 70_000 + 11, 200, 25
    rows, q, scales, q_scales = _cluster_probe_rows(rows_dtype, n, d, b,
                                                    cuda_device)
    src = cluster_probe.source_kind(rows_dtype == "int8", kind)
    tau, lists = cluster_probe.subsample_seeds(rows, q, k, src, scales)
    for mode, seed in (("stage", {}), ("score", {}), ("counted", {}),
                       ("counted", {"lists": lists})):
        active = cluster_probe.active_clusters(rows, b, k, src, mode, qg=qg)
        got = cluster_probe.cluster_probe(mode, rows, q, k, src, scales,
                                          q_scales, qg=qg, **seed)
        want = cluster_probe.cluster_probe_torch(
            mode, rows, q, k, src, scales, q_scales, qg=qg, active=active,
            **seed)
        torch.cuda.synchronize()
        if mode == "counted":
            anatomy.check_counted(got, want, f"{kind} qg={qg}")
        else:
            assert torch.equal(got, want), (mode, qg)


@pytest.mark.parametrize("rows_dtype", ["bfloat16", "int8"])
def test_cuda_cluster_exact_is_k1_or_k2(cuda_device, rows_dtype):
    # The exact kinds' whole call: K2's lists torch.equal (one rounding of
    # an exact int32); K1's within F32 tolerance on unit rows (the planes'
    # sums chained in the accumulator) and torch.equal on integer grids.
    n, b, k = 300_000 + 7, 256, 32
    for grid in ((True,) if rows_dtype == "int8" else (True, False)):
        d = 256
        rows, q, scales, q_scales = _cluster_probe_rows(
            rows_dtype, n, d, b, cuda_device, grid)
        if rows_dtype == "int8":
            got = anatomy.anatomy_top_k_int8(rows, scales, q, q_scales, k,
                                             "full", design="cluster")
            want = fused_dense_top_k_int8_torch(rows, scales, q, q_scales, k)
            kernel = fused_dense_top_k_int8(rows, scales, q, q_scales, k)
        else:
            got = anatomy.anatomy_top_k(rows, q, k, "full",
                                        design="cluster")
            want = fused_dense_top_k_torch(rows, q, k)
            kernel = fused_dense_top_k(rows, q, k)
        torch.cuda.synchronize()
        if rows_dtype == "int8" or grid:
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            assert torch.equal(got[1], kernel[1])
        else:
            check_top_k(want[0], want[1], got[0], got[1], 1e-5)
            check_top_k(kernel[0], kernel[1], got[0], got[1], 1e-5)
        assert _ties_kept_by_lower_id(*got)


@pytest.mark.parametrize("rows_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("b", [64, 200])
@pytest.mark.parametrize("d", [128, 1024])
def test_cuda_cluster_probe_plan_matches_source(cuda_device, rows_dtype, b,
                                                d):
    for kind in cluster_probe.KINDS[:2]:
        src = cluster_probe.source_kind(rows_dtype == "int8", kind)
        for counted in (False, True):
            plan = cluster_topk.cluster_plan(2_000_000, b, d, 32, kind=src,
                                             counted=counted)
            assert cluster_topk.source_smem_bytes(
                plan.qg, d, 32, plan.stages, plan.resident, src,
                counted) == plan.smem_bytes
        walkers = (plan.walkers, plan.tau_walkers, plan.seed_walkers)
        assert cluster_topk.source_workspace_bytes(b, 32, *walkers, d, src) \
            == cluster_topk.workspace_bytes(b, 32, *walkers, d, src)


def test_cuda_cluster_probe_raises_instead_of_falling_back(cuda_device,
                                                           monkeypatch):
    n, d = 4096, 128
    rows, q, _, _ = _cluster_probe_rows("bfloat16", n, d, 40, cuda_device)
    before = (anatomy.anatomy_top_k_cluster.launches,
              anatomy.anatomy_top_k.launches,
              fused_dense_top_k.launches,
              anatomy.fused_top_k_counted_cluster.launches)
    # Calls the cluster plan refuses: B <= 16, f32 rows, rows the TMA
    # cannot take (an odd address), planes not resident (D = 4096).
    with pytest.raises(ValueError, match="B = 16"):
        anatomy.anatomy_top_k(rows, q[:16], 8, "score", design="cluster")
    with pytest.raises(ValueError, match="f32 rows"):
        anatomy.anatomy_top_k(rows.float(), q, 8, "score", design="cluster")
    with pytest.raises(ValueError, match="TMA"):
        anatomy.fused_top_k_counted(_bf16_odd(rows), q, 8, design="cluster")
    wide = torch.zeros((n, 4096), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="resident"):
        anatomy.anatomy_top_k(wide, torch.zeros((40, 4096),
                                                device=cuda_device), 8,
                              "full", design="cluster")
    assert (anatomy.anatomy_top_k_cluster.launches,
            anatomy.anatomy_top_k.launches,
            fused_dense_top_k.launches,
            anatomy.fused_top_k_counted_cluster.launches) == before

    # A launch the source refuses ("score" with no output) raises.
    lib = cluster_probe._library()
    with pytest.raises(RuntimeError, match="anr_cluster_probe"):
        cluster_probe._launch(
            lib.anr_cluster_probe, 4, 2, q.data_ptr(), None, rows.data_ptr(),
            None, None, None, None, None, 0, 40, n, d, 8, 1, 1, 1, 3, 1,
            220_000, 16, None, None, None, None, None, None, None,
            device=cuda_device)

    # A build that fails raises too, and nothing runs the plain version.
    def broken():
        raise RuntimeError("nvcc failed building cluster_probe.cu")

    monkeypatch.setattr(cluster_probe, "_library", broken)
    cluster_probe.device_active_clusters.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        anatomy.anatomy_top_k(rows, q, 8, "stage", design="cluster")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        anatomy.fused_top_k_counted(rows, q, 8, design="cluster")
    assert anatomy.anatomy_top_k_cluster.launches == before[0]
    assert anatomy.fused_top_k_counted_cluster.launches == before[3]


# -- BM25's sparse top-k (csrc/bm25_sparse.cu) -------------------------------

def _bm25_csr(dev, seed, n, v, df_max, values=None, past=0):
    """CSR postings of v terms over n documents, ids ascending in a term;
    integer impacts in [values) where given, else floats in [0.5, 4);
    ``past`` postings at and after the dump row n close every third
    term."""
    from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays

    g = torch.Generator().manual_seed(seed)
    dfs = torch.randint(0, df_max + 1, (v,), generator=g)
    ids, counts = [], []
    for t in range(v):
        d = torch.randperm(n, generator=g)[:int(dfs[t])].sort().values
        if past and t % 3 == 0:
            d = torch.cat([d, n + torch.arange(past)])
        ids.append(d)
        counts.append(d.numel())
    nnz = sum(counts)
    if values is not None:
        imp = torch.randint(values[0], values[1], (nnz,), generator=g).float()
    else:
        imp = 0.5 + 3.5 * torch.rand((nnz,), generator=g)
    indptr = torch.zeros(v + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(torch.tensor(counts), 0)
    return Bm25Arrays(
        indptr=indptr.to(torch.int32).to(dev),
        doc_ids=torch.cat(ids + [torch.tensor([n])]).to(torch.int32).to(dev),
        impact=torch.cat([imp, torch.zeros(1)]).to(dev),
        n_docs_padded=n)


def _bm25_queries(dev, seed, b, t, v):
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randint(-1, v, (b, t), generator=g,
                         dtype=torch.int32).to(dev)


@pytest.mark.parametrize("case", [
    "flat_cut_mid_term", "window", "repeated_terms", "padding_row",
    "fewer_than_k", "mask", "past_dump_row", "ties", "many_slots",
    "one_row",
])
@pytest.mark.parametrize("shift", [12, 15])
def test_cuda_bm25_sparse_matches_plain_on_integer_grids(cuda_device, case,
                                                         shift):
    from a_nice_rag_tpu_torch.ops.bm25 import bm25_top_k_sparse
    from a_nice_rag_tpu_torch.ops.kernels.bm25_sparse import (
        bm25_plan, bm25_sparse_top_k, bm25_sparse_top_k_torch,
        counted_spans, kernel_route)

    n = 70_001 if case != "ties" else 40_000
    bm = _bm25_csr(cuda_device, 3, n, 300, 6000,
                   values=(1, 2) if case == "ties" else (1, 9),
                   past=3 if case == "past_dump_row" else 0)
    assert kernel_route(bm, 25)
    b, t = (1, 9) if case == "one_row" else (37, 9)
    if case == "many_slots":
        t = 70
    q = _bm25_queries(cuda_device, 3, b, t, bm.vocab_size)
    kw, k = {"budget": 1 << 15}, 25
    if case == "flat_cut_mid_term":
        _, dfs = counted_spans(bm.indptr, q, 1 << 40)
        kw["budget"] = int(dfs[0, :4].sum()) + int(dfs[0, 4]) // 2 + 1
    elif case == "window":
        kw = {"df_cap": int(torch.diff(bm.indptr).max())}
    elif case == "repeated_terms":
        q[:, 5:] = q[:, :4]
    elif case == "padding_row":
        q[3] = -1
    elif case == "fewer_than_k":
        df = torch.diff(bm.indptr)
        q[:, 1:] = -1
        q[::2, 0] = int(torch.argmin(torch.where(df > 0, df, 1 << 30)))
        k = 128
    elif case == "mask":
        g = torch.Generator().manual_seed(5)
        kw["mask"] = (torch.rand(n, generator=g) < 0.3).to(cuda_device)
    elif case == "ties":
        k = 128
    plan = bm25_plan(n, kw.get("budget", 1), shift=shift)
    before = bm25_sparse_top_k.launches
    got = bm25_sparse_top_k(bm, q, k, plan=plan, **kw)
    torch.cuda.synchronize()
    assert bm25_sparse_top_k.launches == before + 1
    plain = bm25_sparse_top_k_torch(bm, q, k, **kw)
    route = bm25_top_k_sparse(bm, q, k, **kw)
    for want in (plain, route):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "fewer_than_k":
        assert bool((got[1][::2] == -1).any())
    if case == "ties":
        assert _ties_kept_by_lower_id(*got)
        assert bool((got[0][:, 1:] == got[0][:, :-1]).any())


def test_cuda_bm25_sparse_float_impacts(cuda_device):
    """Float impacts: the kernel's totals are the plain version's bit for
    bit (the same sums in the same order) and within T - 1 float32
    roundings of the float64 totals; ids equal wherever a score is apart
    from its neighbours by more than that."""
    from a_nice_rag_tpu_torch.ops.kernels.bm25_sparse import (
        bm25_sparse_top_k, bm25_sparse_top_k_torch, counted_spans)

    n, t = 200_003, 16
    bm = _bm25_csr(cuda_device, 8, n, 200, 40_000)
    q = _bm25_queries(cuda_device, 8, 64, t, bm.vocab_size)
    q[:, 8:] = q[:, :8]  # repeated terms: totals of up to 16 impacts
    budget = 1 << 18
    vals, ids = bm25_sparse_top_k(bm, q, 32, budget=budget)
    pv, pi = bm25_sparse_top_k_torch(bm, q, 32, budget=budget)
    assert torch.equal(vals, pv) and torch.equal(ids, pi)
    # float64 totals of the listed documents, from the counted postings.
    starts, lens = counted_spans(bm.indptr, q, budget)
    total = torch.zeros((q.shape[0], n), dtype=torch.float64,
                        device=cuda_device)
    for j in range(t):
        w = int(lens[:, j].max())
        pos = torch.arange(w, device=cuda_device)
        keep = pos < lens[:, j, None]
        g = torch.where(keep, starts[:, j, None] + pos, 0)
        d = torch.where(keep, bm.doc_ids[g].long(), 0)
        total.scatter_add_(1, d, torch.where(keep, bm.impact[g].double(), 0))
    live = ids >= 0
    exact = torch.gather(total, 1, ids.clamp(min=0).long())
    tol = (t - 1) * 2.0 ** -24 * exact
    assert bool(((vals.double() - exact).abs() <= tol)[live].all())
    # The float64 order agrees wherever neighbours are further apart.
    want = torch.sort(total, dim=1, descending=True, stable=True)
    gap = (want.values[:, :-1] - want.values[:, 1:]).abs()
    sep = gap[:, :32] > 2 * tol
    sep[:, 1:] &= gap[:, :31] > 2 * tol[:, 1:]
    assert bool((ids.long() == want.indices[:, :32])[sep & live].all())


def test_cuda_bm25_sparse_launches(cuda_device, monkeypatch):
    from a_nice_rag_tpu_torch.ops.kernels import bm25_sparse

    bm = _bm25_csr(cuda_device, 2, 100_000, 100, 5000, values=(1, 5))
    q = _bm25_queries(cuda_device, 2, 16, 8, bm.vocab_size)
    fn = bm25_sparse.bm25_sparse_top_k
    before = fn.launches
    # Three kernels a call: the spans, the slabs, the final lists.
    assert profiled_device_ms(lambda: fn(bm, q, 25, budget=1 << 14),
                              n=3)[1] == 3.0
    assert fn.launches > before
    before = fn.launches
    fn(bm, q, 25, budget=1 << 14)
    assert fn.launches == before + 1
    # Refused arguments raise; nothing falls back.
    with pytest.raises(ValueError, match="k = 129"):
        fn(bm, q, 129)
    with pytest.raises(TypeError, match="int32"):
        fn(bm, q.long(), 25)
    with pytest.raises(TypeError, match="indptr"):
        fn(dataclasses.replace(bm, indptr=bm.indptr.long()), q, 25)

    def broken():
        raise RuntimeError("nvcc failed building bm25_sparse.cu")

    monkeypatch.setattr(bm25_sparse, "_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fn(bm, q, 25)
    assert fn.launches == before + 1


def test_cuda_bm25_retriever_takes_the_kernel(cuda_device):
    from a_nice_rag_tpu_torch.bench import array_index
    from a_nice_rag_tpu_torch.ops.bm25 import bm25_top_k_sparse
    from a_nice_rag_tpu_torch.ops.kernels import bm25_sparse_top_k
    from a_nice_rag_tpu_torch.retrieval import FusedRetriever

    n = 1 << 19
    bm = _bm25_csr(cuda_device, 4, n, 120, 20_000, values=(1, 7))
    dense = _unit(torch.randn((n, 32))).to(cuda_device)
    r = FusedRetriever(array_index(n, dense={"m": dense}, bm25=bm), ("m",),
                       use_bm25=True, similarity_k=25, budget=1 << 16,
                       two_tier_common=0)
    assert r.use_kernel
    q = _bm25_queries(cuda_device, 4, 32, 8, bm.vocab_size)
    launches, torch_route = (bm25_sparse_top_k.launches,
                             bm25_sparse_top_k.torch_route)
    ids = r._bm25_list(bm, q, None)
    assert bm25_sparse_top_k.launches == launches + 1
    assert bm25_sparse_top_k.torch_route == torch_route
    want = bm25_top_k_sparse(bm, q, 25, budget=1 << 16)[1]
    assert torch.equal(ids, want.to(ids.dtype))
    # Postings out of order stay on the torch route, counted.
    flipped = bm.doc_ids.clone()
    a, z = int(bm.indptr[1]), int(bm.indptr[2])
    flipped[a:z] = flipped[a:z].flip(0)
    from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays
    bad = Bm25Arrays(bm.indptr, flipped, bm.impact, n)
    r._bm25_list(bad, q, None)
    assert bm25_sparse_top_k.launches == launches + 1
    assert bm25_sparse_top_k.torch_route == torch_route + 1
