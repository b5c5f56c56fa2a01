"""The cluster kernel (``csrc/cluster_topk.cu``: K2r on int8 rows, K1r
and K1c on bf16 rows) off the card: its launch plan and its routes.

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

The bf16 rows' plan (K1r's three query planes, K1c's one) is held the
same way for B 1-1024 at depths 32, 33, 256 and 1024 and k 1, 32, 128,
with the workspace's query planes; the route
(``fused_topk.bf16_cluster_route`` under ``fold_route``) by row dtype,
B, D, mask, N % 1024 and alignment; and the plain versions those routes
serve on the CPU against the JAX package's packed fold (K1r) and its
``algo="iterate", compare_dtype="bfloat16"`` fold (K1c), interpret mode,
on seeded integer grids (ties everywhere, ±0, a zero query): values
equal, ids the numpy ranking's and the JAX kernel's up to its choice
among the k-th value's ties.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.ops.pallas import fused_dense_top_k as jax_fused
from a_nice_rag_tpu.ops.pallas import (
    fused_dense_top_k_int8 as jax_fused_int8,
)
from a_nice_rag_tpu_torch.ops.kernels import (
    fused_dense_top_k,
    fused_dense_top_k_bf16_compare,
    fused_dense_top_k_int8,
    fused_dense_top_k_int8_rounded,
    fused_dense_top_k_rounded,
)
from a_nice_rag_tpu_torch.ops.kernels import cluster_topk as ct
from a_nice_rag_tpu_torch.ops.kernels import fused_topk as ft
from a_nice_rag_tpu_torch.ops.kernels.autotune import (
    KernelConfig,
    rounded_candidates,
    rounded_takes_cluster,
)
from a_nice_rag_tpu_torch.testing.parity import check_top_k

DEPTHS = (1, 33, 256, 1024, 2048, 4096)
KS = (1, 25, 128)
LIMIT = 232_448


def _documented_smem(qg, d, k, stages, resident, kind="int8"):
    """The source's layout, term by term: 1024 bytes of alignment slack;
    each ring slot a [256 / qg][128] doc chunk (plus the [planes][64
    qg][128] query chunk when the query block is streamed) and its two
    8-byte mbarriers; the resident query planes [ceil(row bytes /
    128)][planes][64 qg][128] (int8 rows: one plane of D bytes; K1r's bf16
    rows three planes of 2 D bytes, K1c's one); the doc multipliers of
    two tiles [2][256 / qg] f32; per query row its list's published worst
    score and a lock (2 x 4 bytes) and a running list of k (score, id)
    pairs, k rounded up to an odd count of them (rows in distinct
    banks)."""
    planes = {"int8": 1, "rounded": 3, "compare": 1}[kind]
    row_bytes = d * (1 if kind == "int8" else 2)
    rows, docs = 64 * qg, 256 // qg
    chunks = -(-row_bytes // 128)
    slot = docs * 128 + (0 if resident else planes * rows * 128)
    query = chunks * planes * rows * 128 if resident else 0
    return (1024 + stages * slot + stages * 2 * 8 + query + 2 * docs * 4
            + rows * 2 * 4 + rows * (k | 1) * 8)


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


# -- bf16 rows: K1r (three query planes) and K1c (one) ---------------------

BF16_DEPTHS = (32, 33, 256, 1024)
BF16_KS = (1, 32, 128)


@pytest.mark.parametrize("k", BF16_KS)
@pytest.mark.parametrize("d", BF16_DEPTHS)
@pytest.mark.parametrize("kind", ["rounded", "compare"])
def test_bf16_plan_for_every_batch(kind, d, k):
    n = 71_680
    resident2 = _documented_smem(2, d, k, 2, True, kind) <= LIMIT
    for b in range(1, 1025):
        p = ct.cluster_plan(n, b, d, k, kind=kind)
        # 128-query CTAs past one block where the planes stay resident
        # beside two ring slots, else 64.
        assert p.qg == (1 if b <= 64 or not resident2 else 2)
        assert p.qg == ct.default_query_groups(b, d, k, kind)
        rows = 64 * p.qg
        blocks = -(-b // rows)
        assert p.groups == -(-blocks // ct.MAX_CLUSTER)
        assert p.cluster * p.groups >= blocks > (p.cluster - 1) * p.groups
        assert p.smem_bytes == _documented_smem(p.qg, d, k, p.stages,
                                                p.resident, kind)
        assert p.smem_bytes == ct.cluster_smem_bytes(
            p.qg, d, k, p.stages, p.resident, kind)
        assert p.smem_bytes <= LIMIT
        assert 1 <= p.stages <= ct.MAX_STAGES
        assert p.stages == ct.MAX_STAGES or _documented_smem(
            p.qg, d, k, p.stages + 1, p.resident, kind) > LIMIT
        assert p.resident == (_documented_smem(p.qg, d, k, 2, True, kind)
                              <= LIMIT)
        # TMA: rows of a multiple of 16 bytes, one 128-byte chunk deep at
        # least, the planes resident, a box of rows.
        assert p.tma == (p.resident and (2 * d) % 16 == 0 and 2 * d >= 128)
        t = ct.tile_docs(p.qg)
        assert p.tiles == -(-n // t)
        assert 1 <= p.walkers <= min(p.tiles, 132 // p.cluster)
        # The workspace: three lists and two taus, K1r's three bf16 planes
        # of the query, and the tau and seed passes' top k.
        w = (p.walkers, p.tau_walkers, p.seed_walkers)
        planes = 6 * b * d if kind == "rounded" else 0
        lists = sum(2 * (-(-4 * b * x * k // 256) * 256) for x in w)
        assert ct.workspace_bytes(b, k, *w, d, kind) == \
            lists + 2 * (-(-4 * b // 256) * 256) + -(-planes // 256) * 256 \
            + 4 * (-(-4 * b * k // 256) * 256)


def test_bf16_main_path_plans():
    """2^21 x 256 bf16 at B = 256, k = 32: K1c two 128-query CTAs a
    cluster with six ring slots; K1r's three planes (96 KiB for 64
    queries) in a cluster of four 64-query CTAs with three; both on TMA
    with every pass. D = 1024: K1c's plane resident in 64-query CTAs, K1r's
    three not."""
    n, d, k = 1 << 21, 256, 32
    c = ct.cluster_plan(n, 256, d, k, active_clusters=66, kind="compare")
    assert (c.qg, c.cluster, c.groups, c.walkers, c.stages) == (2, 2, 1, 66, 6)
    assert c.tma and c.tau_tma and c.seed_tma and c.resident
    assert c.smem_bytes == _documented_smem(2, d, k, 6, True, "compare")
    r = ct.cluster_plan(n, 256, d, k, active_clusters=33, kind="rounded")
    assert (r.qg, r.cluster, r.groups, r.walkers, r.stages) == (1, 4, 1, 33, 3)
    assert r.tma and r.tau_tma and r.seed_tma and r.resident
    assert ct.cluster_plan(n, 512, d, k, kind="rounded")[:3] == (1, 4, 2)
    assert ct.cluster_plan(n, 256, 1024, k, kind="compare").resident
    assert not ct.cluster_plan(n, 256, 1024, k, kind="rounded").resident
    with pytest.raises(ValueError, match="kind"):
        ct.cluster_plan(n, 256, d, k, kind="float32")


ROUND, CMP = ft.SCORE_ROUNDED, ft.SCORE_COMPARE


@pytest.mark.parametrize("case", [
    # (rows, B, D, k, N, aligned, score): cluster kernel?
    (("bfloat16", 256, 256, 32, 1 << 21, True, ROUND), True),
    (("bfloat16", 256, 256, 32, 1 << 21, True, CMP), True),
    (("bfloat16", 17, 256, 32, 1 << 21, True, ROUND), True),
    (("bfloat16", 16, 256, 32, 1 << 21, True, ROUND), False),  # small B
    (("bfloat16", 8, 256, 32, 1 << 21, True, CMP), False),
    (("float32", 256, 256, 32, 1 << 21, True, ROUND), False),  # FFMA
    (("float32", 256, 256, 32, 1 << 21, True, CMP), False),
    (("bfloat16", 256, 1024, 32, 1 << 21, True, ROUND), False),  # 384 KiB
    (("bfloat16", 256, 1024, 32, 1 << 21, True, CMP), True),
    (("bfloat16", 256, 33, 32, 70_001, True, CMP), False),  # 66-byte rows
    (("bfloat16", 256, 32, 32, 70_001, True, CMP), False),  # under a chunk
    (("bfloat16", 256, 256, 32, 1 << 21, False, CMP), False),  # emb[1:]
    (("bfloat16", 256, 64, 128, 63, True, CMP), False),  # under a box
    (("bfloat16", 512, 256, 128, 70_001, True, CMP), True),
], ids=lambda c: "-".join(map(str, c)) if len(c) == 7 else str(c))
def test_bf16_cluster_route(case):
    (rows, b, d, k, n, aligned, score), want = case
    assert ft.bf16_cluster_route(n, b, d, k, rows, score, aligned) is want


@pytest.mark.parametrize("case", [
    # (N, masked, rounded, compare_dtype): the fold, as the JAX launcher
    # routes it; the cluster kernel takes K1r / K1c at B = 256, D = 256.
    ((1 << 20, False, True, "float32"), ft.SCORE_ROUNDED),
    ((1 << 20, False, True, "bfloat16"), ft.SCORE_ROUNDED),
    ((1 << 20, True, True, "bfloat16"), ft.SCORE_COMPARE),
    ((1 << 20, True, True, "float32"), ft.SCORE_EXACT),
    (((1 << 20) - 37, False, False, "bfloat16"), ft.SCORE_COMPARE),
    ((1 << 20, False, False, "bfloat16"), ft.SCORE_EXACT),
], ids=str)
def test_fold_route_then_cluster_route(case):
    (n, masked, rounded, cmp), fold = case
    mask = torch.ones(n, dtype=torch.bool) if masked else None
    assert ft.fold_route(n, mask, rounded, cmp) == fold
    if fold != ft.SCORE_EXACT:
        assert ft.bf16_cluster_route(n, 256, 256, 32, "bfloat16", fold)


def _bf16_np(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _sorted_rows(vals, ids, signed_zero):
    """Each row by (value desc, id asc); -0.0 below +0.0 where the fold
    ranks it so (K1r), tied with it otherwise (K1c)."""
    vals, ids = np.asarray(vals), np.asarray(ids)
    keys = np.where((vals == 0) & np.signbit(vals), -np.float32(1e-45),
                    vals) if signed_zero else vals
    order = np.stack([np.lexsort((i, -v)) for v, i in zip(keys, ids)])
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


def _bf16_grid(n, d, b, seed):
    """{-1, 0, 1} rows (exact bf16 scores that tie everywhere), a block
    repeated far on, all-zero rows, +-1 queries and a zero query: every
    score of the zero query is +0.0."""
    rng = np.random.default_rng(seed)
    emb = rng.choice([-1.0, 0.0, 1.0], (n, d)).astype(np.float32)
    emb[n // 2:n // 2 + 64] = emb[:64]
    emb[rng.choice(n, 5, replace=False)] = 0.0
    q = rng.choice([-1.0, 1.0], (b, d)).astype(np.float32)
    q[1] = 0.0
    return emb, q, rng.random(n) > 0.4


@pytest.mark.parametrize("shape", [(2048, 64, 24, 32), (3072, 128, 40, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k1r_route_plain_matches_packed(shape):
    """K1r's calls that take the cluster kernel on the card (bf16 rows, B
    past 16, aligned maskless N) run the plain version here: held to the
    JAX packed fold in interpret mode."""
    n, d, b, k = shape
    emb, q, _ = _bf16_grid(n, d, b, [n, d, b])
    assert ft.bf16_cluster_route(n, b, d, k, "bfloat16", ft.SCORE_ROUNDED)
    jv, ji = jax_fused(jnp.asarray(emb, jnp.bfloat16), jnp.asarray(q), k=k,
                       block_q=8, block_n=1024, algo="packed",
                       interpret=True)
    before = fused_dense_top_k_rounded.launches
    tv, ti = fused_dense_top_k(_t(emb).bfloat16(), _t(q), k, rounded=True)
    assert fused_dense_top_k_rounded.launches == before  # CPU: plain
    tv, ti = tv.numpy(), ti.numpy()
    rounded, key = _rounded_key(q @ emb.T)
    want_i = np.stack([np.lexsort((np.arange(n), -row))[:k] for row in key])
    np.testing.assert_array_equal(ti, want_i)
    np.testing.assert_array_equal(tv, np.take_along_axis(rounded, ti, 1))
    np.testing.assert_array_equal(np.signbit(tv[1]), np.zeros(k, bool))
    jv, ji = _sorted_rows(jv, ji, True)
    np.testing.assert_array_equal(tv, jv)
    check_top_k(jv, ji, tv, ti, 0.0)


@pytest.mark.parametrize("masked", [False, True], ids=["maskless", "masked"])
@pytest.mark.parametrize("shape", [(2048, 64, 24, 32), (1500 + 37, 128, 40, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k1c_route_plain_matches_iterate(shape, masked):
    """K1c's calls that take the cluster kernel on the card (bf16 rows, B
    past 16, any N, a mask or none) run the plain version here: held to
    the JAX iterate body with compare_dtype="bfloat16" in interpret
    mode; -0.0 and +0.0 tie as floats."""
    n, d, b, k = shape
    emb, q, mask = _bf16_grid(n, d, b, [n, d, b, masked])
    m = mask if masked else None
    assert ft.bf16_cluster_route(n, b, d, k, "bfloat16", ft.SCORE_COMPARE)
    jv, ji = jax_fused(jnp.asarray(emb, jnp.bfloat16), jnp.asarray(q), k=k,
                       block_q=8, block_n=1024,
                       mask=None if m is None else jnp.asarray(m),
                       algo="iterate", compare_dtype="bfloat16",
                       interpret=True)
    tv, ti = fused_dense_top_k_bf16_compare(
        _t(emb).bfloat16(), _t(q), k, mask=None if m is None else _t(m))
    tv, ti = tv.numpy(), ti.numpy()
    s = _bf16_np(_bf16_np(q) @ emb.T)
    if m is not None:
        s = np.where(m[None, :], s, -np.inf)
    want_i = np.stack([np.lexsort((np.arange(n), -row))[:k] for row in s])
    np.testing.assert_array_equal(ti, want_i)
    np.testing.assert_array_equal(tv, np.take_along_axis(s, ti, 1))
    jv, ji = _sorted_rows(jv, ji, False)
    np.testing.assert_array_equal(tv, jv)
    check_top_k(jv, ji, tv, ti, 0.0)
    above = tv > tv[:, -1:]
    np.testing.assert_array_equal(ti[above], ji[above])


def test_tuner_times_the_rounded_fold_on_its_route():
    """K1's (bq, splits) steer only K1's kernel: where the rounded fold
    runs the cluster kernel the tuner times it once, as
    KernelConfig(rounded=True); where it runs K1's kernel, each plan on
    it."""
    plans = (KernelConfig(64, 132), KernelConfig(16, 66))
    assert rounded_candidates(plans, cluster=True) == plans + (
        KernelConfig(rounded=True),)
    assert rounded_candidates(plans) == plans + tuple(
        c._replace(rounded=True) for c in plans)
    emb = torch.zeros((2048, 64), dtype=torch.bfloat16)
    assert rounded_takes_cluster(emb, 32, 8)
    assert not rounded_takes_cluster(emb, 16, 8)  # K1's kernel at small B
    assert not rounded_takes_cluster(emb.float(), 32, 8)  # f32 rows: FFMA
    odd = torch.zeros(2048 * 64 + 1, dtype=torch.bfloat16)[1:].view(2048, 64)
    assert odd.data_ptr() % 16 == 2
    assert not rounded_takes_cluster(odd, 32, 8)  # rows the TMA cannot take
    assert not rounded_takes_cluster(emb[:1500], 32, 8)  # exact fold


def test_plan_is_checked_but_read_only_by_k1s_kernel():
    """On the cluster route a caller's plan= is checked as on K1's route
    (a bad query block raises) and changes nothing."""
    rng = np.random.default_rng(3)
    emb = torch.as_tensor(rng.standard_normal((2048, 64)).astype(
        np.float32)).bfloat16()
    q = torch.as_tensor(rng.standard_normal((32, 64)).astype(np.float32))
    assert ft.bf16_cluster_route(2048, 32, 64, 8, "bfloat16", ROUND)
    want = fused_dense_top_k_rounded(emb, q, 8)
    got = fused_dense_top_k_rounded(emb, q, 8, plan=(64, 3))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="bq"):
        fused_dense_top_k_rounded(emb, q, 8, plan=(32, None))
    with pytest.raises(ValueError, match="bq"):
        fused_dense_top_k_bf16_compare(emb, q, 8, plan=(32, None))
