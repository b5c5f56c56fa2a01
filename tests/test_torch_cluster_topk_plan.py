"""K2r's kernel (``csrc/cluster_topk.cu``) off the card: its launch plan
and its route.

The plan (``cluster_topk.cluster_plan``) is plain Python, so its rules
hold here for every batch from 1 to 1024 and the depths the port serves:
the shared memory within a CTA's 232,448 bytes and equal to the source's
formula (written out again below from the source's layout), the cluster
and groups covering the batch, TMA only where the rows allow it. The
route: ``fused_dense_top_k_int8(rounded=True)`` on CPU tensors runs the
plain version, held against the JAX package's packed int8 fold
(``algo="packed"``, interpret mode) on the same seeded numpy inputs,
values equal exactly and ids through ``check_top_k`` at atol 0 (the TPU
kernel keeps the boundary ties its eviction order leaves). The kernel
itself is held on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py`` phase 26).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.ops.pallas import (
    fused_dense_top_k_int8 as jax_fused_int8,
)
from a_nice_rag_tpu_torch.ops.kernels import (
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_rounded,
)
from a_nice_rag_tpu_torch.ops.kernels import cluster_topk as ct
from a_nice_rag_tpu_torch.testing.parity import check_top_k

DEPTHS = (1, 33, 256, 1024, 2048, 4096)
KS = (1, 25, 128)
LIMIT = 232_448


def _documented_smem(qg, d, k, stages, resident):
    """The source's layout, term by term: 1024 bytes of alignment slack;
    each ring slot a [256 / qg][128] doc chunk (plus the [64 qg][128]
    query chunk when the query block is streamed) and its two 8-byte
    mbarriers; the resident query block [ceil(D / 128)][64 qg][128]; the
    doc scales of two tiles [2][256 / qg] f32; per query row its list's
    published worst score and a lock (2 x 4 bytes) and a running list of
    k (score, id) pairs."""
    rows, docs = 64 * qg, 256 // qg
    chunks = -(-d // 128)
    slot = docs * 128 + (0 if resident else rows * 128)
    query = chunks * rows * 128 if resident else 0
    return (1024 + stages * slot + stages * 2 * 8 + query + 2 * docs * 4
            + rows * 2 * 4 + rows * k * 8)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", DEPTHS)
def test_plan_for_every_batch(d, k):
    n = 10_485_760 if d == 1024 else 71_680
    for b in range(1, 1025):
        p = ct.cluster_plan(n, b, d, k)
        assert p.qg == ct.default_query_groups(b)
        rows = 64 * p.qg
        blocks = -(-b // rows)
        # The batch covered by groups of at most 4 query blocks, no group
        # wider than it needs.
        assert 1 <= p.cluster <= ct.MAX_CLUSTER
        assert p.groups == -(-blocks // ct.MAX_CLUSTER)
        assert p.cluster * p.groups >= blocks > (p.cluster - 1) * p.groups
        # Shared memory: the documented formula, within the card's limit,
        # and as many ring slots as fit (at most six).
        assert p.smem_bytes == _documented_smem(p.qg, d, k, p.stages,
                                                p.resident)
        assert p.smem_bytes == ct.cluster_smem_bytes(p.qg, d, k, p.stages,
                                                     p.resident)
        assert p.smem_bytes <= LIMIT
        assert 1 <= p.stages <= ct.MAX_STAGES
        assert p.stages == ct.MAX_STAGES or _documented_smem(
            p.qg, d, k, p.stages + 1, p.resident) > LIMIT
        # The query block stays resident where two ring slots fit beside.
        assert p.resident == (_documented_smem(p.qg, d, k, 2, True)
                              <= LIMIT)
        # Walkers over the tiles of both passes, one CTA an SM.
        t = ct.tile_docs(p.qg)
        assert p.tiles == -(-n // t)
        assert p.tau_tiles == -(-(-(-n // 64)) // t)
        assert p.seed_tiles == -(-(-(-n // 4096)) // t)
        assert 1 <= p.walkers <= min(p.tiles, 132 // p.cluster)
        assert 1 <= p.tau_walkers <= p.tau_tiles
        assert 1 <= p.seed_walkers <= p.seed_tiles
        assert p.grid == (p.walkers * p.cluster, p.groups)


def test_main_path_plan():
    """10.5M x 1024 int8 at B = 256: one cluster of two 128-query CTAs on
    the TMA route, the query block resident, four ring slots; the tau and
    seed passes on the TMA route too. One query group: four CTAs of 64
    queries."""
    n, d, k = 10_485_760, 1024, 25
    p = ct.cluster_plan(n, 256, d, k, active_clusters=66)
    assert (p.qg, p.cluster, p.groups, p.walkers) == (2, 2, 1, 66)
    assert p.tma and p.tau_tma and p.seed_tma and p.resident
    assert p.stages == 4 and p.smem_bytes == 225_344
    assert p.tiles == n // 128 and p.tau_tiles == n // 64 // 128
    assert (p.seed_tiles, p.seed_walkers) == (20, 20)
    one = ct.cluster_plan(n, 256, d, k, active_clusters=30, qg=1)
    assert (one.cluster, one.groups, one.walkers) == (4, 1, 30)
    assert one.tiles == n // 256 and one.smem_bytes == 213_056
    # B = 512: one group of four 128-query blocks, or two of four 64-query
    # blocks.
    assert ct.cluster_plan(n, 512, d, k)[:3] == (2, 4, 1)
    assert ct.cluster_plan(n, 512, d, k, qg=1).groups == 2
    # B = 8: one 64-query block, a cluster of one.
    assert ct.cluster_plan(n, 8, d, k)[:3] == (1, 1, 1)


@pytest.mark.parametrize("case", [
    # (n, d, aligned, k, query groups): (main tma, tau tma)
    ((10_485_760, 1024, True, 25, 1), (True, True)),
    ((10_485_760, 1024, True, 25, 2), (True, True)),
    ((10_485_760, 1024, False, 25, 2), (False, False)),  # values[1:]
    ((71_680, 1000, True, 25, 1), (False, False)),  # D % 16 != 0
    ((71_680, 33, True, 25, 2), (False, False)),
    ((71_680, 96, True, 25, 1), (False, False)),  # under one chunk
    ((71_680, 128, True, 25, 2), (True, True)),
    ((1024, 1024, True, 25, 2), (True, False)),  # 16 tau rows: under a box
    ((262_144, 1024, True, 25, 1), (True, True)),  # 64 seed rows: one box
    ((4096, 1024, True, 25, 1), (True, True)),
    ((71_680, 2048, True, 128, 1), (False, False)),  # query block streamed
    ((71_680, 2048, True, 25, 1), (True, True)),
    ((71_680, 2048, True, 25, 2), (False, False)),  # 128 queries streamed
], ids=lambda c: "-".join(map(str, c[0])) if len(c) == 5 else str(c))
def test_tma_or_element_loads(case):
    (n, d, aligned, k, qg), (tma, tau_tma) = case
    p = ct.cluster_plan(n, 256, d, k, aligned=aligned, qg=qg)
    assert (p.tma, p.tau_tma) == (tma, tau_tma)
    assert p.seed_tma == (tau_tma and -(-n // 4096) >= 64)
    assert p.tma <= p.resident
    if not p.tma:
        # No cluster shares a stream: as many walkers as CTAs fit.
        assert p.walkers == min(p.tiles, 132 // p.cluster)


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="k must be"):
        ct.cluster_plan(1024, 8, 64, 129)
    with pytest.raises(ValueError, match="qg must be"):
        ct.cluster_plan(1024, 8, 64, 8, qg=3)
    with pytest.raises(ValueError, match="N, B, D"):
        ct.cluster_plan(0, 8, 64, 8)


def test_workspace_layout():
    """The main, tau and seed passes' lists, tau and the seed's, each on
    256 bytes."""
    assert ct.workspace_bytes(256, 25, 66, 66, 20) == \
        4 * 256 * 66 * 25 * 4 + 2 * 256 * 20 * 25 * 4 + 2 * 1024
    assert ct.workspace_bytes(1, 1, 1, 1, 1) == 8 * 256
    assert ct.workspace_bytes(3, 5, 7, 2, 1) == \
        2 * 512 + 2 * 256 + 2 * 256 + 2 * 256


def _t(x):
    return torch.as_tensor(np.array(x))


def _rounded_key(scores):
    r = np.asarray(scores, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)
    return r, np.where((r == 0) & np.signbit(r), -np.float32(1e-45), r)


# (n, d, b, k, value range): B past four 64-query blocks, k = 128, and
# narrow integer grids whose rounded scores tie across the k boundary.
ROUTE_CASES = [
    (2048, 64, 264, 25, 128),
    (2048, 32, 48, 128, 128),
    (3072, 128, 296, 128, 2),
    (2048, 64, 40, 32, 2),
    (4096, 96, 24, 128, 1),
]


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_route_matches_the_packed_int8_fold(case):
    n, d, b, k, lim = case
    rng = np.random.default_rng([n, d, b, k, lim])
    vals = rng.integers(-lim, lim, (n, d), endpoint=lim < 128).astype(
        np.int8)
    # Ties across tiles and walkers: a block of rows repeated far on.
    vals[n // 2:n // 2 + 256] = vals[:256]
    qv = rng.integers(-lim, lim, (b, d), endpoint=lim < 128).astype(np.int8)
    if lim > 2:
        vals[7], qv[3] = 127, -128
    sc = (rng.random(n) + 0.5).astype(np.float32) if lim > 2 else \
        np.ones(n, np.float32)
    qs = (rng.random(b) + 0.5).astype(np.float32)
    jv, ji = jax_fused_int8(jnp.asarray(vals), jnp.asarray(sc),
                            jnp.asarray(qv), jnp.asarray(qs), k,
                            block_q=8, block_n=1024, algo="packed",
                            interpret=True)
    before = fused_dense_top_k_int8_rounded.launches
    tv, ti = fused_dense_top_k_int8(_t(vals), _t(sc), _t(qv), _t(qs), k,
                                    rounded=True)
    assert fused_dense_top_k_int8_rounded.launches == before  # CPU: plain
    tv, ti = tv.numpy(), ti.numpy()
    sel = (qv.astype(np.int32) @ vals.astype(np.int32).T).astype(
        np.float32) * sc[None, :]
    rounded, key = _rounded_key(sel)
    want_i = np.stack([np.lexsort((np.arange(n), -row))[:k] for row in key])
    np.testing.assert_array_equal(ti, want_i)
    np.testing.assert_array_equal(
        tv, np.take_along_axis(rounded, ti, 1) * qs[:, None])
    # The JAX fold's values are the same multiset; its ids the same up to
    # its order among the k-th value's ties.
    np.testing.assert_array_equal(np.sort(tv, 1), np.sort(np.asarray(jv), 1))
    check_top_k(np.asarray(jv), np.asarray(ji), tv, ti, 0.0)
