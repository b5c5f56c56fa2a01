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
the same bits on two calls of every launch shape.
"""

import pytest
import torch

from a_nice_rag_tpu_torch.ops.kernels import (
    anatomy,
    bf16_row_reduce,
    bf16_row_reduce_torch,
    fused_dense_top_k,
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
from a_nice_rag_tpu_torch.ops.kernels import topk_plan
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    float_smem_bytes,
    int8_smem_bytes,
    split_query,
    subsample_tau,
    subsample_tau_torch,
    workspace_bytes_of_source,
)
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


def test_cuda_keys_bit_exact(cuda_device):
    inf = float("inf")
    special = torch.tensor([-inf, -3.3e38, -1.0, -2e-38, -1e-45, -0.0, 0.0,
                            1e-45, 2e-38, 0.5, 1.0, 3.3e38, inf])
    g = torch.Generator().manual_seed(9)
    x = torch.cat([special, 10 * torch.randn(100_003, generator=g)])
    x = x.to(cuda_device)
    for start in (0, 1, 2, 3):  # 16-byte vectors and the scalar path
        view = x[start:]
        before = xpack_keys.launches
        keys = xpack_keys(view)
        back = xpack_values(keys[start % 2:])
        torch.cuda.synchronize()
        assert xpack_keys.launches == before + 1
        assert torch.equal(keys, xpack_keys_torch(view))
        assert torch.equal(back.view(torch.int32),
                           view[start % 2:].view(torch.int32))
    ordered = x[torch.argsort(xpack_keys(x))]
    assert bool((ordered[1:] >= ordered[:-1]).all())


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
