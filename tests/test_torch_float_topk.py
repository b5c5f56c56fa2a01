"""The float path's pieces of K1 and K3 on the CPU, and the tau warm start
of K1-K4.

- The three-piece bf16 split of the f32 query (``split_query``), which the
  kernels multiply bf16 rows with on the bf16 tensor cores: each piece is
  bf16, and hi + mid + lo == q exactly (bit for bit, as the f32 sum
  (hi + mid) + lo and in f64) for q = 0 and |q| >= 2^-110; below, within
  bf16's smallest step 2^-133.
- The tau helpers' plain versions (K1, K2 and the IVF kernels K3, K4):
  never above the k-th best candidate score, under masks, tile tables,
  n_real, pad rows and ties, and -inf with fewer than k candidates.
- A top-k whose candidates must score at least tau (the kernels' seeded
  running lists) equals the unseeded top-k, and the JAX package's
  kernels in interpret mode.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py).
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import configuration, given, settings
from hypothesis import strategies as st

from a_nice_rag_tpu.ops.pallas import fused_dense_top_k as jax_fused
from a_nice_rag_tpu.ops.pallas.ivf_topk import ivf_dense_top_k as jax_k3
from a_nice_rag_tpu_torch.ops.kernels import fused_topk as ft
from a_nice_rag_tpu_torch.ops.kernels import ivf_topk as it
from a_nice_rag_tpu_torch.testing.parity import check_top_k

F32_ATOL = 1e-5
EXACT_FROM = 2.0 ** -110
CPU = torch.device("cpu")
# Hypothesis keeps its caches under the temporary directory, not in the
# checkout.
configuration.set_hypothesis_home_dir(tempfile.mkdtemp(prefix="hypothesis-"))


# -- the query split -----------------------------------------------------


def _check_split(values):
    q = torch.tensor(np.asarray(values, np.float32))
    pieces = ft.split_query(q[None])
    assert pieces.dtype == torch.bfloat16
    assert pieces.shape == (3, 1, q.numel())
    hi, mid, lo = (pieces[i, 0].float() for i in range(3))
    # hi keeps the top 16 bits of q's word.
    assert torch.equal(hi.view(torch.int32),
                       q.view(torch.int32) & -65536)
    total = (hi + mid) + lo
    exact = (q == 0) | (q.abs() >= EXACT_FROM)
    assert torch.equal(total[exact], q[exact])
    nonzero = exact & (q != 0)
    assert torch.equal(total[nonzero].view(torch.int32),
                       q[nonzero].view(torch.int32))
    wide = hi.double() + mid.double() + lo.double()
    assert torch.equal(wide[exact], q.double()[exact])
    assert bool(((wide - q.double()).abs() <= 2.0 ** -133)[~exact].all())


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False),
                min_size=1, max_size=64))
def test_split_query_is_exact(values):
    _check_split(values)


def test_split_query_edges():
    f = np.finfo(np.float32)
    rng = np.random.default_rng(0)
    values = [0.0, -0.0, 1.0, -1.0, f.max, -f.max, f.tiny, -f.tiny,
              f.smallest_subnormal, -f.smallest_subnormal, 2.0 ** -110,
              -(2.0 ** -110) * 1.75, 2.0 ** -111 * 1.999, 1 / 3, np.pi,
              3.3e38, 65504.0, np.nextafter(np.float32(1), np.float32(2))]
    _check_split(values + list(rng.standard_normal(1000).astype(np.float32))
                 + list((rng.standard_normal(200) * 1e-36).astype(
                     np.float32)))


def test_split_query_of_bf16_and_batched_queries():
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((7, 37)).astype(np.float32))
    pieces = ft.split_query(q)
    assert pieces.shape == (3, 7, 37)
    assert torch.equal((pieces[0].float() + pieces[1].float())
                       + pieces[2].float(), q)
    qb = q.to(torch.bfloat16)  # a bf16 query is its own hi
    pieces = ft.split_query(qb)
    assert torch.equal(pieces[0], qb)
    assert not pieces[1:].float().any()


# -- tau ---------------------------------------------------------------------


def _rows(seed, n, d, b, integer):
    rng = np.random.default_rng(seed)
    if integer:  # exact ties everywhere
        emb = rng.integers(-2, 3, (n, d)).astype(np.float32)
        q = rng.integers(-2, 3, (b, d)).astype(np.float32)
    else:
        emb = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((b, d)).astype(np.float32)
        emb[n // 2:n // 2 + 70] = emb[:70]  # ties across splits
    return torch.tensor(emb), torch.tensor(q), rng


def _masks(rng, n):
    few = np.zeros(n, bool)
    few[1::64] = True  # no subsample row at all: tau = -inf
    few[::700] = True
    return {"none": None,
            "half": torch.tensor(rng.random(n) < 0.5),
            "few": torch.tensor(few),
            "empty": torch.zeros(n, dtype=torch.bool)}


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("k", [1, 8, 40])
def test_subsample_tau_bounds_the_kth_candidate(integer, k):
    emb, q, rng = _rows(k, 5000 + 37, 16, 6, integer)
    for name, mask in _masks(rng, emb.shape[0]).items():
        tau = ft.subsample_tau_torch(emb, q, k, mask)
        kth = ft.fused_dense_top_k_torch(emb, q, k, mask)[0][:, -1]
        assert bool((tau <= kth).all()), name
        sub = torch.arange(0, emb.shape[0], 64)
        n_sub = sub.numel() if mask is None else int(mask[sub].sum())
        assert bool(torch.isneginf(tau).all()) == (n_sub < k), name
        if n_sub >= k:  # the k-th best of the subsample, lowered
            s = q @ emb[sub].T
            if mask is not None:
                s = s[:, mask[sub]]
            want = torch.topk(s, k, dim=1).values[:, -1]
            assert torch.equal(tau, want - want.abs() * ft.TAU_SLACK - 1e-30)


def test_subsample_tau_int8_is_on_the_selection_scores():
    rng = np.random.default_rng(5)
    n, d, b, k = 4000, 24, 5, 10
    values = torch.tensor(rng.integers(-127, 128, (n, d), dtype=np.int8))
    scales = torch.tensor(rng.uniform(0.5, 1.5, n).astype(np.float32))
    qv = torch.tensor(rng.integers(-127, 128, (b, d), dtype=np.int8))
    qs = torch.tensor(rng.uniform(2.0, 3.0, b).astype(np.float32))
    mask = torch.tensor(rng.random(n) < 0.7)
    tau = ft.subsample_tau_int8_torch(values, scales, qv, k, mask)
    # Selection scores: the emitted values over the query scales.
    vals = ft.fused_dense_top_k_int8_torch(values, scales, qv, qs, k, mask)[0]
    sel = ft._plain_top_k(ft._int8_scores(values, scales, qv, mask), n, b, d,
                          k, CPU)[0]
    assert torch.allclose(vals, sel * qs[:, None])
    assert bool((tau <= sel[:, -1]).all())
    assert bool(torch.isfinite(tau).all())
    seeded = ft._plain_top_k(ft._int8_scores(values, scales, qv, mask), n, b,
                             d, k, CPU, tau=tau)
    assert torch.equal(seeded[0], sel)


_TABLES = {
    # Np = 640 rows in 5 tiles of 128; n_real = 600 (last tile ragged).
    "full": ([0, 1, 2, 3, 4], 600, 9),
    "padded": ([1, 3, 4, -1, -1], 600, 16),
    "dynamic": ([0, 2, 4, -1, 600], 0, 9),
    "k_past_subsample": ([4, -1], 600, 3),  # tile 4: rows 512, 576 only
    "k_past_valid": ([4, -1], 600, 100),  # tile 4: 88 valid rows
}


def _ivf_inputs(seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(640, 32)).astype(np.float32)
    emb[300:310] = emb[:10]  # exact ties across tiles
    q = rng.normal(size=(5, 32)).astype(np.float32)
    # Pad rows and untabled tiles score far above every real row: a tau
    # taken from them would drop true results.
    emb[600:] = q.sum(0) * 50
    return torch.tensor(emb), torch.tensor(q)


def _ivf_int8(emb, q):
    """int8 rows and queries of the same inputs, unit query scales: the
    selection scores are the emitted values."""
    scale = 127 / float(torch.cat([emb, q]).abs().max())
    values = torch.round(emb * scale).to(torch.int8)
    qv = torch.round(q * scale).to(torch.int8)
    scales = torch.full((emb.shape[0],), 0.5)
    return values, scales, qv, torch.ones(q.shape[0])


@pytest.mark.parametrize("rows", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(_TABLES))
def test_ivf_tau_bounds_the_kth_candidate(case, rows):
    table, n_real, k = _TABLES[case]
    emb, q = _ivf_inputs(7)
    tt = torch.tensor(table, dtype=torch.int32)
    if rows == "int8":  # K4: on the selection scores
        values, scales, qv, qs = _ivf_int8(emb, q)
        tau = it.ivf_subsample_tau_int8_torch(values, scales, qv, tt, k,
                                              128, n_real)
        kth = it.ivf_dense_top_k_int8_torch(values, scales, qv, qs, tt, k,
                                            128, n_real)[0][:, -1]
    else:
        tau = it.ivf_subsample_tau_torch(emb, q, tt, k, 128, n_real)
        kth = it.ivf_dense_top_k_torch(emb, q, tt, k, 128, n_real)[0][:, -1]
    assert bool((tau <= kth).all())
    rows = it._tau_rows(tt, 128, n_real)
    assert bool((rows < 600).all()) and bool((rows % 64 == 0).all())
    assert bool(torch.isneginf(tau).all()) == (rows.numel() < k)


# -- seeded == unseeded == the JAX package ----------------------------------


@pytest.mark.parametrize("mask_kind", ["none", "half", "few"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_seeded_top_k_equals_unseeded_and_jax(mask_kind, dtype):
    emb, q, rng = _rows(3, 2048, 64, 64, False)
    emb = emb.to(getattr(torch, dtype))
    mask = _masks(rng, emb.shape[0])[mask_kind]
    k = 16
    tau = ft.subsample_tau_torch(emb, q, k, mask)
    assert bool(torch.isfinite(tau).all()) == (mask_kind != "few")
    seeded = ft._plain_top_k(ft._float_scores(emb, q, mask), emb.shape[0],
                             q.shape[0], emb.shape[1], k, CPU, tau=tau)
    plain = ft.fused_dense_top_k_torch(emb, q, k, mask)
    assert torch.equal(seeded[0], plain[0])
    assert torch.equal(seeded[1], plain[1])
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    jv, ji = jax_fused(jnp.asarray(emb.float().numpy(),
                                   dtype=jnp.dtype(dtype)),
                       jnp.asarray(q.numpy()), k=k, block_q=64,
                       block_n=256, mask=jmask, interpret=True)
    check_top_k(jv, ji, seeded[0], seeded[1], F32_ATOL)


@pytest.mark.parametrize("case", sorted(_TABLES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_seeded_top_k_equals_unseeded_and_jax(case, dtype):
    table, n_real, k = _TABLES[case]
    emb, q = _ivf_inputs(31)
    emb = emb.to(getattr(torch, dtype))
    tt = torch.tensor(table, dtype=torch.int32)
    tau = it.ivf_subsample_tau_torch(emb, q, tt, k, 128, n_real)
    seeded = it._plain_ivf_top_k(it._ivf_float_scores(emb, q), tt,
                                 q.shape[0], emb.shape[1], k, 128, n_real,
                                 tau=tau)
    plain = it.ivf_dense_top_k_torch(emb, q, tt, k, 128, n_real)
    assert torch.equal(seeded[0], plain[0])
    assert torch.equal(seeded[1], plain[1])
    jv, ji = jax_k3(jnp.asarray(emb.float().numpy(), dtype=jnp.dtype(dtype)),
                    jnp.asarray(q.numpy()), jnp.asarray(table, jnp.int32), k,
                    tile_n=128, n_real=n_real, interpret=True)
    check_top_k(jv, ji, seeded[0], seeded[1], F32_ATOL)
