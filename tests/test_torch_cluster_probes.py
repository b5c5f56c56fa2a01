"""P4 and P5 on the cluster kernel (``ops/kernels/cluster_probe.py``,
``anatomy.py``'s ``design="cluster"``) off the card: their plain
versions against the JAX package's TPU probes and against their
definitions, and the cluster plan's refusals.

The TPU probes are the ``pl.pallas_call`` bodies of
``scripts/profile_kernel_anatomy.py`` (P4: ``visit_full``'s lists) and
``scripts/probe_iteration_count.py`` (P5: its ``kernel``, with and without
``TAU_QUANTILE``), run as ``tests/test_torch_probes.py`` runs them (the
scripts' ``main()`` at a small size, every pallas_call in interpret mode
and recorded), at B = 32: the cluster design takes B past 16 only. The
exact kind's lists are held to theirs within 1e-5 of the largest |score|
(f32 sums in another order), ids up to swaps inside it.

Every counter is held to its definition, computed here from scratch for
each row, walker and tile with numpy: the walker's list as a tile began
is the top k, under (score desc, id asc), of its seed and of every doc of
its earlier tiles; a doc enters iff it beats that list's worst entry; the
tile's survivors are its docs in the list as the tile ends. Over one and
two query groups, one to seven walkers, ragged N, integer grids (ties
everywhere), a zero query (+-0.0), and each of the three seeds (none, tau,
an earlier pass's lists as the kernel's ``seed_lists`` takes them). The
"stage" XOR is held to the rows' and the query planes' words, "score" and
"compare" to numpy's scores. On the card the kernels are held to these
plain versions (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``
phases 13 and 14).
"""

import numpy as np
import pytest
import torch

from a_nice_rag_tpu_torch.ops.kernels import anatomy as A
from a_nice_rag_tpu_torch.ops.kernels import cluster_probe as CP
from a_nice_rag_tpu_torch.ops.kernels import cluster_topk as ct
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import split_query
from tests.test_torch_probes import (  # noqa: F401
    _bf16,
    _by_name,
    _check_full,
    _script,
    recorder,
)

# N D B k bq bn sub: the TPU probes' small size at B = 32.
CLUSTER_ARGV = ["4096", "128", "32", "8", "8", "1024", "2"]
EMPTY = CP.EMPTY_ID
KINDS = [("bf16", "exact"), ("bf16", "rounded"), ("bf16", "compare"),
         ("int8", "exact"), ("int8", "rounded")]


def _run_main(monkeypatch, name):
    mod = _script(name)
    monkeypatch.setattr("sys.argv", [name, *CLUSTER_ARGV])
    mod.main()


# -- against the TPU probes -------------------------------------------------


def test_cluster_full_matches_profile_kernel_anatomy(recorder, monkeypatch):
    _run_main(monkeypatch, "profile_kernel_anatomy")
    (q, emb), (want_v, want_i) = _by_name(recorder, "visit_full")[0]
    q, emb = _bf16(q), _bf16(emb)
    before = A.anatomy_top_k_cluster.launches
    vals, ids = A.anatomy_top_k(emb, q, 8, "full", design="cluster")
    _check_full(vals, ids, want_v, want_i)
    assert A.anatomy_top_k_cluster.launches == before  # the plain version
    # The exact kind is K1's function: its plain version's lists.
    ref = A.fused_dense_top_k_torch(emb, q, 8)
    assert torch.equal(vals, ref[0]) and torch.equal(ids, ref[1])


@pytest.mark.parametrize("tau_quantile", [None, "64"])
def test_cluster_counted_matches_probe_iteration_count(recorder, monkeypatch,
                                                       tau_quantile):
    if tau_quantile is None:
        monkeypatch.delenv("TAU_QUANTILE", raising=False)
    else:
        monkeypatch.setenv("TAU_QUANTILE", tau_quantile)
    _run_main(monkeypatch, "probe_iteration_count")
    ((q, emb, tau), (want_v, want_i, _)), = _by_name(recorder, "kernel")
    q, emb = _bf16(q), _bf16(emb)
    seed = None if tau_quantile is None else torch.tensor(tau[:, 0])
    vals, ids, counts, survived = A.fused_top_k_counted(
        emb, q, 8, seed, design="cluster")
    _check_full(vals, ids, want_v, want_i)
    # Every seed leaves the lists as they are, and a warm one only takes
    # entries away.
    cold = A.fused_top_k_counted(emb, q, 8, design="cluster")
    _, lists = CP.subsample_seeds(emb, q, 8, "exact")
    warm = A.fused_top_k_counted(emb, q, 8, design="cluster", lists=lists)
    for out in (cold, warm):
        assert torch.equal(out[0], vals) and torch.equal(out[1], ids)
    entries = counts[..., :2].sum(-1)
    assert bool((entries <= cold[2][..., :2].sum(-1)).all())
    assert bool((warm[2][..., :2].sum(-1) <= cold[2][..., :2].sum(-1)).all())
    assert bool((survived <= entries).all())
    assert counts.shape[:2] == survived.shape == (32, counts.shape[1])


# -- against the definitions -------------------------------------------------


def _grid(rows_dtype, n, d, b, seed):
    """Integer grids (every score exact: ties everywhere), rows 0-63 copied
    past the middle and query 1 zero: (rows, queries, scales, q_scales)."""
    rng = np.random.default_rng(seed)
    if rows_dtype == "int8":
        rows = rng.integers(-2, 3, (n, d)).astype(np.int8)
        q = rng.integers(-2, 3, (b, d)).astype(np.int8)
        scales = rng.choice(np.float32([0.5, 1.0, 1.5]), n)
        q_scales = rng.uniform(0.5, 1.5, b).astype(np.float32)
    else:
        rows = rng.integers(-1, 2, (n, d)).astype(np.float32)
        q = rng.integers(-1, 2, (b, d)).astype(np.float32)
        scales = q_scales = None
    rows[n // 2:n // 2 + 64] = rows[:64]
    if scales is not None:
        scales[n // 2:n // 2 + 64] = scales[:64]
    q[1] = 0
    out = [torch.tensor(rows), torch.tensor(q),
           None if scales is None else torch.tensor(scales),
           None if q_scales is None else torch.tensor(q_scales)]
    if rows_dtype != "int8":
        out[0] = out[0].bfloat16()
    return out


def _numpy_scores(kind, rows, q, scales):
    """The kinds' selection scores from numpy (exact on these grids; no
    -0.0 arises from integer sums)."""
    acc = (np.asarray(q, np.int64) if scales is not None else
           np.asarray(q.float(), np.float64)) @ (
        np.asarray(rows, np.int64) if scales is not None else
        np.asarray(rows.float(), np.float64)).T
    if scales is None:
        return acc.astype(np.float32)  # integers below 2^24: every kind
    s = acc.astype(np.float32) * np.asarray(scales)[None, :]
    if kind == "int8":  # K2r: rounded to bf16
        s = torch.tensor(s).bfloat16().float().numpy()
    return s


def _lowered(x):
    x = np.float32(x)
    if not np.isfinite(x):
        return x
    return np.float32(np.float32(x - np.float32(abs(x) * np.float32(1e-5)))
                      - np.float32(1e-30))


def _walker_seed(k, tau, lists, r, t0, t1, tile):
    """Row r's seed of the walker over tiles [t0, t1), from the
    definition of the kernel's seed_lists: the listed docs outside the
    walker's docs as (their score lowered, empty), the other slots the
    k-th listed score lowered; or k copies of tau, or of -inf."""
    if lists is None:
        v = -np.inf if tau is None else float(tau[r])
        return [np.float32(v)] * k
    lv, li, every = (np.asarray(lists[0]), np.asarray(lists[1]), lists[2])
    out = []
    for j in range(k):
        doc = int(li[r, j]) * every
        outside = li[r, j] >= 0 and not t0 * tile <= doc < t1 * tile
        out.append(_lowered(lv[r, j]) if outside else _lowered(lv[r, k - 1]))
    return out


def _top(v, ids, k):
    order = np.lexsort((ids, -v.astype(np.float64)))[:k]
    return v[order], ids[order]


def _brute_counted(s, k, plan, n, rows_checked, tau, lists):
    """counts [R, W, 4] and survivors [R, W] of the checked rows from the
    definitions, recomputing every list from scratch."""
    tile = ct.tile_docs(plan.qg)
    per = -(-plan.tiles // plan.walkers)
    counts = np.zeros((len(rows_checked), plan.walkers, 4), np.int64)
    survived = np.zeros((len(rows_checked), plan.walkers), np.int64)
    for x, r in enumerate(rows_checked):
        for w in range(plan.walkers):
            t0, t1 = w * per, min(plan.tiles, w * per + per)
            seed_v = np.array(_walker_seed(k, tau, lists, r, t0, t1, tile),
                              np.float32)
            seed_i = np.full(k, EMPTY, np.int64)
            counts[x, w, 3] = max(0, t1 - t0)
            for t in range(t0, t1):
                before = np.arange(t0 * tile, t * tile)
                lv, li = _top(np.concatenate([seed_v, s[r, before]]),
                              np.concatenate([seed_i, before]), k)
                wv, wi = lv[-1], li[-1]
                docs = np.arange(t * tile, min(n, (t + 1) * tile))
                sd = s[r, docs]
                ent = int(((sd > wv) | ((sd == wv) & (docs < wi))).sum())
                counts[x, w, 0 if t - t0 < CP.EARLY_TILES else 1] += ent
                counts[x, w, 2] += ent > 0
                _, after = _top(np.concatenate([lv, sd]),
                                np.concatenate([li, docs]), k)
                survived[x, w] += int(((after >= docs[0])
                                       & (after <= docs[-1])).sum()) \
                    if docs.size else 0
    return counts, survived


@pytest.mark.parametrize("rows_dtype,kind", KINDS)
@pytest.mark.parametrize("qg", [1, 2])
@pytest.mark.parametrize("walkers", [1, 3, 7])
def test_counters_against_their_definition(rows_dtype, kind, qg, walkers):
    b = 20 if qg == 1 else 70
    d = 64 if rows_dtype == "bf16" else 128
    tile = ct.tile_docs(qg)
    n = walkers * 18 * tile - 37  # the first walkers past 16 tiles, ragged
    k = 5 if walkers == 3 else 16
    rows, q, scales, q_scales = _grid(rows_dtype, n, d, b, walkers + qg)
    src = CP.source_kind(rows_dtype == "int8", kind)
    plan = CP.probe_plan(n, b, d, k, src, True, active_clusters=walkers
                         * ct.cluster_plan(n, b, d, k, qg=qg,
                                           kind=src).groups, qg=qg)
    assert plan.walkers == walkers and plan.qg == qg
    s = CP._scorer(src, rows, scales, q, None)(slice(0, n)).numpy()
    if scales is None or kind == "exact":
        np.testing.assert_array_equal(s, _numpy_scores(src, rows, q, scales))
    tau, lists = CP.subsample_seeds(rows, q, k, src, scales)
    checked = [0, 1, b - 1]
    ref = CP.top_k_torch(rows, q, k, src, scales, q_scales, qg=qg)
    for seed in ({}, {"tau": tau}, {"lists": lists}):
        got = CP.cluster_probe_torch("counted", rows, q, k, src, scales,
                                     q_scales, qg=qg,
                                     active=plan.walkers * plan.groups,
                                     **seed)
        want, surv = _brute_counted(s, k, plan, n, checked,
                                    seed.get("tau"), seed.get("lists"))
        np.testing.assert_array_equal(got[2][checked].numpy(), want)
        np.testing.assert_array_equal(got[3][checked].numpy(), surv)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert got[2].shape == (b, walkers, 4)
        assert int(got[2][..., 1].sum()) > 0  # late entries exist
        # The kernel's insertions lie between these bounds; the plain
        # version's survivors meet them.
        A.check_counted(got, got)


def test_entries_change_with_the_seed():
    # Seven walkers of 18 tiles: a cold walker takes its first tile whole,
    # tau and the lists start it at the subsample's k-th, and the lists
    # raise a walker's threshold faster than k copies of tau.
    rows, q, _, _ = _grid("bf16", 7 * 18 * 256, 64, 20, 5)
    _, lists = CP.subsample_seeds(rows, q, 16, "exact")
    tau = CP.subsample_seeds(rows, q, 16, "exact")[0]
    runs = [A.fused_top_k_counted_cluster_torch(rows, q, 16, active=7, **s)
            for s in ({}, {"tau": tau}, {"lists": lists})]
    cold, warm_tau, warm_lists = (r[2][..., :2].sum() for r in runs)
    assert cold > warm_tau >= warm_lists
    for r in runs[1:]:
        assert torch.equal(r[1], runs[0][1])


@pytest.mark.parametrize("rows_dtype,kind", KINDS)
def test_stage_score_compare_against_numpy(rows_dtype, kind):
    b, k = 70, 8
    d = 64 if rows_dtype == "bf16" else 128
    n = 3000 + 37
    rows, q, scales, q_scales = _grid(rows_dtype, n, d, b, 9)
    src = CP.source_kind(rows_dtype == "int8", kind)
    plan = CP.probe_plan(n, b, d, k, src, active_clusters=3)
    # stage: per (query block, walker) the XOR of the walker's doc words
    # and the block's query plane words.
    words = CP.cluster_probe_torch("stage", rows, q, k, src, scales,
                                   active=3).numpy().view(np.uint32)
    assert words.shape == (plan.groups * plan.cluster, plan.walkers)
    raw = (rows.view(torch.int16).numpy() if rows.dtype == torch.bfloat16
           else rows.numpy())
    ew = np.ascontiguousarray(raw).view(np.uint32)
    if src == "int8_exact" or src == "int8":
        planes = q.numpy()[None]
    elif src == "compare":
        planes = q.bfloat16().view(torch.int16).numpy()[None]
    else:
        planes = split_query(q).view(torch.int16).numpy()
    qw = np.ascontiguousarray(planes).view(np.uint32)  # [P, B, W]
    tile, per = ct.tile_docs(plan.qg), -(-plan.tiles // plan.walkers)
    rows_q = ct.cta_queries(plan.qg)
    for blk in range(words.shape[0]):
        qx = np.bitwise_xor.reduce(
            qw[:, blk * rows_q:(blk + 1) * rows_q].ravel(), initial=0)
        for w in range(plan.walkers):
            docs = ew[w * per * tile:min(n, (w * per + per) * tile)]
            assert words[blk, w] == np.bitwise_xor.reduce(
                docs.ravel(), initial=0) ^ qx, (blk, w)
    # score and compare against numpy's selection scores.
    s = _numpy_scores(src, rows, q, scales)
    got = A.anatomy_top_k_cluster_torch(rows, q, k, "score", kind=kind) \
        if scales is None else A.anatomy_top_k_int8_cluster_torch(
            rows, scales, q, q_scales, k, "score", kind=kind)
    np.testing.assert_array_equal(got.numpy(), s.max(axis=1))
    thr = np.sort(s, axis=1)[:, -k].astype(np.float32)
    thr_t = torch.tensor(thr)
    got = A.anatomy_top_k_cluster_torch(rows, q, k, "compare", thr_t,
                                        kind=kind) if scales is None else \
        A.anatomy_top_k_int8_cluster_torch(rows, scales, q, q_scales, k,
                                           "compare", thr_t, kind=kind)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), (s >= thr[:, None]).sum(1))


def test_score_and_compare_leave_out_masked_docs():
    # A masked doc (NaN in the plain scores, a NaN multiplier on the card)
    # is no row's best and is never at or above a threshold.
    rows, q, _, _ = _grid("bf16", 3000, 64, 20, 4)
    mask = torch.ones(3000, dtype=torch.bool)
    mask[:1500] = False
    s = _numpy_scores("exact", rows, q, None)
    for mode in ("score", "compare"):
        thr = torch.zeros(20)
        got = CP.cluster_probe_torch(mode, rows, q, 8, "exact", mask=mask,
                                     threshold=thr)
        want = (s[:, 1500:].max(axis=1) if mode == "score" else
                (s[:, 1500:] >= 0).sum(axis=1))
        np.testing.assert_array_equal(got.numpy(), want)


# -- the plan and the design switch ------------------------------------------


def test_cluster_plan_refusals_raise():
    rows, q, scales, q_scales = _grid("bf16", 4096, 64, 40, 1)
    with pytest.raises(ValueError, match="B = 16"):
        A.anatomy_top_k(rows, q[:16], 8, "score", design="cluster")
    with pytest.raises(ValueError, match="f32 rows"):
        A.fused_top_k_counted(rows.float(), q, 8, design="cluster")
    buf = torch.zeros(rows.numel() + 8, dtype=torch.bfloat16)
    odd = buf[1:1 + rows.numel()].view(rows.shape)
    odd.copy_(rows)
    with pytest.raises(ValueError, match="TMA"):
        A.anatomy_top_k(odd, q, 8, "stage", design="cluster")
    with pytest.raises(ValueError, match="TMA"):  # rows under 128 bytes
        A.anatomy_top_k(rows[:, :32].contiguous(), q[:, :32], 8, "full",
                        design="cluster")
    wide = torch.zeros((4096, 4096), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="resident"):
        A.fused_top_k_counted(wide, torch.zeros((40, 4096)), 8,
                              design="cluster")
    v8, q8, s8, qs8 = _grid("int8", 4096, 128, 40, 2)
    with pytest.raises(ValueError, match="no compare kind"):
        A.anatomy_top_k_int8(v8, s8, q8, qs8, 8, "score", design="cluster",
                             kind="compare")
    with pytest.raises(ValueError, match="design"):
        A.anatomy_top_k(rows, q, 8, "score", design="ring")
    with pytest.raises(ValueError, match="kind"):
        A.anatomy_top_k(rows, q, 8, "score", design="cluster", kind="fast")
    with pytest.raises(ValueError, match="tau or lists"):
        _, lists = CP.subsample_seeds(rows, q, 8, "exact")
        A.fused_top_k_counted(rows, q, 8, torch.zeros(40), design="cluster",
                              lists=lists)
    with pytest.raises(ValueError, match="threshold"):
        A.anatomy_top_k(rows, q, 8, "compare", design="cluster")


def test_split_design_is_unchanged_by_default():
    rows, q, _, _ = _grid("bf16", 3000, 64, 20, 3)
    got = A.fused_top_k_counted(rows, q, 8)
    assert len(got) == 3
    splits = A.split_plan(3000, 20, 64, 8, "bfloat16",
                          torch.device("cpu")).splits
    assert got[2].shape == (20, splits, 4)
    assert torch.equal(A.anatomy_top_k(rows, q, 8, "score"),
                       A.anatomy_top_k(rows, q, 8, "score", design="split"))


@pytest.mark.parametrize("kind", ["exact", "rounded", "int8_exact", "int8"])
@pytest.mark.parametrize("d", [64, 256, 1024])
def test_counted_plan_holds_its_counters(kind, d):
    # The counters take 20 bytes a query row: the same formula as the
    # source's layout, within a CTA's shared memory, and the ring takes
    # what is left (the stage count the probe runs with, beside the
    # fold's).
    for b in (40, 200):
        fold = ct.cluster_plan(2_000_000, b, d, 32, kind=kind)
        probe = ct.cluster_plan(2_000_000, b, d, 32, kind=kind, counted=True)
        q = ct.cta_queries(probe.qg)
        assert probe.smem_bytes == ct.cluster_smem_bytes(
            probe.qg, d, 32, probe.stages, probe.resident, kind) + 20 * q
        assert probe.smem_bytes <= ct.SMEM_LIMIT
        assert probe.stages <= fold.stages
        assert (probe.qg, probe.cluster, probe.groups) == (
            fold.qg, fold.cluster, fold.groups)


def test_check_counted_holds_the_heap_to_its_bounds():
    vals = torch.zeros((2, 3))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    counts = torch.tensor([[[3, 1, 2, 5]], [[0, 2, 1, 5]]], dtype=torch.int32)
    want = (vals, ids, counts, torch.tensor([[2], [1]], dtype=torch.int32))
    A.check_counted((vals, ids, counts, torch.tensor([[4], [2]])), want)
    with pytest.raises(AssertionError, match="insertions"):
        A.check_counted((vals, ids, counts, torch.tensor([[5], [2]])), want)
    with pytest.raises(AssertionError, match="insertions"):
        A.check_counted((vals, ids, counts, torch.tensor([[1], [2]])), want)
    with pytest.raises(AssertionError, match="counters"):
        A.check_counted((vals, ids, counts + 1, want[3]), want)
