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
The stream sums: within 1e-5 of the sum of absolute values (float32
partial sums in another order), exactly for int8 data whose partial sums
stay below 2^24; the busy kernel's chains bit for bit.
"""

import pytest
import torch

from a_nice_rag_tpu_torch.ops.kernels import (
    fused_dense_top_k,
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_torch,
    fused_dense_top_k_torch,
    ivf_dense_top_k,
    ivf_dense_top_k_int8,
    ivf_dense_top_k_int8_torch,
    ivf_dense_top_k_torch,
    stream_sum,
    stream_sum_busy,
    stream_sum_busy_torch,
    stream_sum_torch,
)
from a_nice_rag_tpu_torch.ops.kernels.stream import abs_total
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
    assert float(stream_sum(x)) == float(stream_sum(x))  # no atomics


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
