"""The bf16 compare fold (K1c) of the port against the JAX package's
``_kernel_iterate`` with ``compare_dtype="bfloat16"``, run in interpret
mode as its own tests run it.

The JAX body is reached by ``algo="iterate"`` or by the default algo on a
masked or misaligned call (a maskless call over N % 1024 == 0 rows under
the default algo ignores ``compare_dtype`` and gives K1's exact result).
Its ``dot_general`` emits bf16: the product accumulated in f32 and rounded
to bf16 once, where a bf16 operand makes both operands bf16. On the CPU
the port's wrappers take their plain version. The same seeded numpy
inputs go through both packages.

Tolerances and what is compared:
- bf16-exact inputs (integer grids, f32 and bf16 rows, masked or not, N
  aligned and misaligned, k 1 / 8 / 16): values equal exactly; the
  port's ids equal an independent numpy ranking (score desc, id asc).
  The JAX fold neither orders equal values by id nor keeps the lower id
  at the k-th boundary: a better document replaces the first slot
  holding the list's minimum, the earliest of the tied entries, so the
  ties it keeps are the later ones. Its ids are held through
  ``check_top_k`` at atol 0 (an id may differ only for another of the
  same score), and equal the port's above the k-th value once each row
  is sorted by (value desc, id asc).
- random normals: sorted values within rtol 8e-3 / atol 1e-6 (the
  rounded fold's tolerance: the f32 sums may be taken in another order
  and round to a neighbouring bf16); id sets equal on every row whose
  k-th and (k+1)-th rounded scores differ.
- the operand rule: a bf16 operand makes the other bf16 before the
  product. On bf16 rows against an f32 query, a fold that multiplied the
  exact f32 query (K1r's three-piece split) picks other ids than the JAX
  kernel; on f32 rows against a bf16 query, so does one that left the
  rows in f32. ``test_operand_rule_*`` holds the port to the JAX kernel
  and shows that such a fold fails the same check. Checked by mutation
  too: the port's ``_compare_scores`` changed to multiply the f32 query
  (and, apart, to leave f32 rows unrounded) fails these tests.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.ops.pallas import fused_dense_top_k as jax_fused
from a_nice_rag_tpu_torch.ops import kernels
from a_nice_rag_tpu_torch.ops.kernels import (
    fused_dense_top_k,
    fused_dense_top_k_bf16_compare,
    fused_dense_top_k_bf16_compare_torch,
    fused_dense_top_k_rounded,
    fused_dense_top_k_torch,
    topk_plan,
)
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    SCORE_COMPARE,
    SCORE_EXACT,
    SCORE_ROUNDED,
    TAU_STRIDE,
    _compare_scores,
    _plain_top_k,
    _tau_of,
    fold_route,
)
from a_nice_rag_tpu_torch.testing.parity import check_top_k

VALUE_RTOL, VALUE_ATOL = 8e-3, 1e-6
# (n, d, b, k): aligned and misaligned doc axes.
GRID_SHAPES = [(2048, 32, 8, 1), (3072, 64, 16, 16), (1500 + 37, 32, 8, 8)]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(TORCH[dtype])


def _j(x, dtype="float32"):
    return jnp.asarray(x, dtype=jnp.dtype(dtype))


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def _scores_np(emb, q, emb_dtype, q_dtype):
    """Independent numpy scores: the f32 product if both operands are f32,
    else the product of both rounded to bf16; rounded to bf16."""
    if emb_dtype == q_dtype == "float32":
        return _bf16(q @ emb.T)
    return _bf16(_bf16(q) @ _bf16(emb).T)


def _ranked(scores, k, mask=None):
    """Numpy's top k of each row by (score desc, id asc), (-inf, -1) past
    the candidates."""
    s = np.where(mask[None, :], scores, -np.inf) if mask is not None \
        else scores
    n = s.shape[1]
    ids = np.stack([np.lexsort((np.arange(n), -row))[:k] for row in s])
    vals = np.take_along_axis(s, ids, 1)
    return vals, np.where(np.isneginf(vals), -1, ids)


def _sorted_rows(vals, ids):
    """Each row by (value desc, id asc): -0.0 and +0.0 tie."""
    vals, ids = np.asarray(vals), np.asarray(ids)
    order = np.stack([np.lexsort((i, -v)) for v, i in zip(vals, ids)])
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


def _jax_compare(emb, q, k, mask=None, emb_dtype="float32",
                 q_dtype="float32", **kw):
    kw = {"algo": "iterate", **kw}
    return jax_fused(_j(emb, emb_dtype), _j(q, q_dtype), k=k,
                     block_q=q.shape[0], block_n=1024,
                     mask=None if mask is None else jnp.asarray(mask),
                     compare_dtype="bfloat16", interpret=True, **kw)


def _hold_exact(jax_out, port_out, scores, k, mask=None):
    """bf16-exact scores: values equal, ids the numpy ranking's, and the
    JAX kernel's up to its choice among the k-th value's ties (rows
    sorted by (value desc, id asc))."""
    jv, ji = _sorted_rows(*jax_out)
    tv, ti = port_out[0].numpy(), port_out[1].numpy()
    wv, wi = _ranked(scores, k, mask)
    np.testing.assert_array_equal(tv, wv)
    np.testing.assert_array_equal(ti, wi)
    np.testing.assert_array_equal(tv, jv)
    check_top_k(jv, ji, tv, ti, 0.0)
    above = tv > tv[:, -1:]
    np.testing.assert_array_equal(ti[above], ji[above])


def _grid(shape, seed, levels=(-1.0, 0.0, 1.0)):
    n, d, b, _ = shape
    rng = np.random.default_rng(seed)
    emb = rng.choice(levels, (n, d)).astype(np.float32)
    # Duplicated rows further on: exact ties across tiles.
    emb[n // 2:n // 2 + 64] = emb[:64]
    q = rng.choice([-1.0, 1.0], (b, d)).astype(np.float32)
    mask = rng.random(n) > 0.4
    return emb, q, mask


@pytest.mark.parametrize("masked", [False, True], ids=["maskless", "masked"])
@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GRID_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_integer_grid_matches_iterate(shape, emb_dtype, masked):
    """Integer scores (bf16-exact up to 256): ties everywhere, across
    tiles and the k boundary, in both packages' compare fold."""
    n, d, b, k = shape
    emb, q, mask = _grid(shape, [n, d, masked])
    m = mask if masked else None
    jax_out = _jax_compare(emb, q, k, m, emb_dtype)
    port = fused_dense_top_k_bf16_compare(
        _t(emb, emb_dtype), _t(q), k, mask=None if m is None else _t(m))
    _hold_exact(jax_out, port, q @ emb.T, k, m)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2048, 64, 8, 8), (1500 + 37, 48, 16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_random_normals_match_iterate(shape, emb_dtype, q_dtype):
    n, d, b, k = shape
    rng = np.random.default_rng(n + d)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    jv, ji = _jax_compare(emb, q, k, emb_dtype=emb_dtype, q_dtype=q_dtype)
    tv, ti = fused_dense_top_k_bf16_compare(_t(emb, emb_dtype),
                                            _t(q, q_dtype), k)
    np.testing.assert_allclose(np.sort(tv.numpy(), 1),
                               np.sort(np.asarray(jv), 1),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)
    assert torch.equal(tv, tv.to(torch.bfloat16).float())
    r = _scores_np(emb, q, emb_dtype, q_dtype)
    kth = -np.sort(-r, 1)[:, k - 1:k + 1]
    clear = kth[:, 0] != kth[:, 1]
    assert clear.sum() >= b // 2
    for row in np.flatnonzero(clear):
        assert set(ti[row].tolist()) == set(np.asarray(ji)[row].tolist())


def _operand_case(emb_dtype, q_dtype, wrong_scores):
    """Random normals where the operand rule moves the ids: the port and
    the JAX kernel agree exactly, and the top k of ``wrong_scores`` (a
    fold that breaks the rule) fails the same check."""
    n, d, b, k = 2048, 64, 16, 8
    rng = np.random.default_rng(311)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    jv, ji = _sorted_rows(*_jax_compare(emb, q, k, emb_dtype=emb_dtype,
                                        q_dtype=q_dtype))
    tv, ti = fused_dense_top_k_bf16_compare(_t(emb, emb_dtype),
                                            _t(q, q_dtype), k)
    np.testing.assert_array_equal(tv.numpy(), jv)
    check_top_k(jv, ji, tv, ti, 0.0)
    wv, wi = _ranked(wrong_scores(emb, q), k)
    assert not np.array_equal(wi, ji)
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(wv, jv)
        check_top_k(jv, ji, wv, wi, 0.0)


def test_operand_rule_bf16_rows_f32_query():
    """bf16 rows, f32 query: bf16(bf16(q) @ e.T), not K1r's bf16(q @ e.T)
    over the three-piece split of the f32 query."""
    _operand_case("bfloat16", "float32",
                  lambda emb, q: _bf16(q @ _bf16(emb).T))


def test_operand_rule_bf16_query_f32_rows():
    """bf16 query, f32 rows: the rows are rounded to bf16 too."""
    _operand_case("float32", "bfloat16",
                  lambda emb, q: _bf16(_bf16(q) @ emb.T))


def test_compare_scores_follow_the_operand_rule():
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    for ed in ("float32", "bfloat16"):
        for qd in ("float32", "bfloat16"):
            got = _compare_scores(_t(emb, ed), _t(q, qd))(0, 300).numpy()
            np.testing.assert_array_equal(got, _scores_np(emb, q, ed, qd))


def test_default_route_ignores_compare_on_maskless_aligned_calls():
    """Maskless over N % 1024 == 0: the JAX default algo (xpack) ignores
    compare_dtype and returns K1's exact result; so does the port."""
    n, d, b, k = 2048, 32, 8, 8
    rng = np.random.default_rng(61)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    jv, ji = jax_fused(_j(emb), _j(q), k=k, block_q=b, block_n=1024,
                       compare_dtype="bfloat16", interpret=True)
    tv, ti = fused_dense_top_k(_t(emb), _t(q), k, compare_dtype="bfloat16")
    ev, ei = fused_dense_top_k(_t(emb), _t(q), k)
    assert torch.equal(tv, ev) and torch.equal(ti, ei)
    assert not torch.equal(tv, tv.to(torch.bfloat16).float())  # exact
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    assert fold_route(n, None, False, "bfloat16") == SCORE_EXACT


@pytest.mark.parametrize("case", ["masked", "misaligned"])
def test_default_route_takes_compare_on_masked_or_misaligned_calls(case):
    """A mask or N % 1024 != 0: the JAX default algo falls back to the
    iterate body, in its compare fold; the port takes K1c."""
    n = 2048 if case == "masked" else 2048 + 5
    d, b, k = 32, 8, 16
    emb, q, mask = _grid((n, d, b, k), 62)
    m = mask if case == "masked" else None
    jax_out = jax_fused(_j(emb), _j(q), k=k, block_q=b, block_n=1024,
                        mask=None if m is None else jnp.asarray(m),
                        compare_dtype="bfloat16", interpret=True)
    tm = None if m is None else _t(m)
    port = fused_dense_top_k(_t(emb), _t(q), k, mask=tm,
                             compare_dtype="bfloat16")
    direct = fused_dense_top_k_bf16_compare(_t(emb), _t(q), k, mask=tm)
    assert torch.equal(port[0], direct[0]) and torch.equal(port[1], direct[1])
    _hold_exact(jax_out, port, q @ emb.T, k, m)
    plain = fused_dense_top_k_torch(_t(emb), _t(q), k, mask=tm,
                                    compare_dtype="bfloat16")
    assert torch.equal(plain[1], port[1])
    assert fold_route(n, tm, False, "bfloat16") == SCORE_COMPARE


def test_rounded_and_compare_route_as_packed_does():
    """rounded=True (the JAX algo="packed") with compare_dtype="bfloat16":
    a masked call takes K1c, as the JAX launcher's fallback to iterate
    does; a maskless aligned one K1r."""
    n, d, b, k = 2048, 32, 8, 8
    rng = np.random.default_rng(63)
    emb = rng.integers(-16, 17, (n, d)).astype(np.float32)
    q = rng.integers(-16, 17, (b, d)).astype(np.float32)
    mask = rng.random(n) > 0.5
    temb, tq, tm = _t(emb), _t(q), _t(mask)
    jax_out = jax_fused(_j(emb), _j(q), k=k, block_q=b, block_n=1024,
                        mask=jnp.asarray(mask), algo="packed",
                        compare_dtype="bfloat16", interpret=True)
    port = fused_dense_top_k(temb, tq, k, mask=tm, rounded=True,
                             compare_dtype="bfloat16")
    _hold_exact(jax_out, port, _bf16(q @ emb.T), k, mask)
    assert not torch.equal(port[0], fused_dense_top_k(temb, tq, k,
                                                      mask=tm)[0])
    aligned = fused_dense_top_k(temb, tq, k, rounded=True,
                                compare_dtype="bfloat16")
    k1r = fused_dense_top_k_rounded(temb, tq, k)
    assert torch.equal(aligned[0], k1r[0]) and torch.equal(aligned[1],
                                                           k1r[1])
    assert fold_route(n, None, True, "bfloat16") == SCORE_ROUNDED
    assert fold_route(n, tm, True, "bfloat16") == SCORE_COMPARE
    assert fold_route(n, tm, True, "float32") == SCORE_EXACT


def test_all_masked_and_fewer_than_k_candidates():
    n, d, b, k = 1500, 16, 4, 12
    emb, q, _ = _grid((n, d, b, k), 64)
    none = np.zeros(n, bool)
    few = np.zeros(n, bool)
    few[[3, 700, 701, 1499]] = True
    for mask in (none, few):
        jv, ji = _jax_compare(emb, q, k, mask)
        tv, ti = fused_dense_top_k(_t(emb), _t(q), k, mask=_t(mask),
                                   compare_dtype="bfloat16")
        _hold_exact((jv, ji), (tv, ti), q @ emb.T, k, mask)
        count = int(mask.sum())
        assert (ti.numpy()[:, count:] == -1).all()
        assert np.isneginf(tv.numpy()[:, count:]).all()


@pytest.mark.parametrize("bad", ["float16", "bf16", "int8", None,
                                 torch.bfloat16])
def test_other_compare_dtypes_raise(bad):
    emb, q = torch.zeros((64, 8)), torch.zeros((2, 8))
    with pytest.raises(ValueError, match="compare_dtype"):
        fused_dense_top_k(emb, q, 4, compare_dtype=bad)
    with pytest.raises(ValueError, match="compare_dtype"):
        fused_dense_top_k_torch(emb, q, 4, compare_dtype=bad)
    with pytest.raises(ValueError, match="compare_dtype"):
        fold_route(64, None, False, bad)


def test_tau_of_rounded_scores_keeps_the_result():
    """K1c's warm start: the lowered k-th best rounded score of every 64th
    row stays below the k-th best of all of them, so seeding the lists
    with it keeps the result, ties at tau included (the kernel's tau pass
    rounds the subsample exactly as its main pass rounds it)."""
    rng = np.random.default_rng(17)
    n, d, b = 8192, 32, 12
    emb = _t(rng.integers(-2, 3, (n, d)).astype(np.float32), "bfloat16")
    q = _t(rng.standard_normal((b, d)).astype(np.float32))
    mask = _t(rng.random(n) > 0.3)
    s = _compare_scores(emb, q, mask)(0, n)
    for k in (1, 25, 128):
        tau = _tau_of(s[:, ::TAU_STRIDE], k)
        kth = torch.topk(s[:, ::TAU_STRIDE], k, dim=1).values[:, -1]
        assert bool(((tau < kth) | torch.isneginf(kth)).all())
        assert bool((tau <= kth).all())
        assert bool((tau <= torch.topk(s, k, dim=1).values[:, -1]).all())
        seeded = _plain_top_k(_compare_scores(emb, q, mask), n, b, d, k,
                              emb.device, tau=tau)
        want = fused_dense_top_k_bf16_compare_torch(emb, q, k, mask)
        assert torch.equal(seeded[0], want[0])
        assert torch.equal(seeded[1], want[1])


def test_one_query_plane_for_bf16_rows():
    """K1c's bf16 rows take one query plane: 1/3 of K1's query block, so
    a 64-query block of bf16 rows at D = 1024, k = 32 stays resident."""
    one = topk_plan.COMPARE_PLANES
    assert one == 1
    for bq, d, k in ((16, 256, 32), (64, 1024, 32), (64, 37, 128)):
        three = topk_plan.smem_bytes(bq, d, k, "bfloat16")
        got = topk_plan.smem_bytes(bq, d, k, "bfloat16", planes=one)
        assert three - got == 2 * bq * topk_plan.depth_pad(2 * d)
        assert topk_plan.smem_bytes(bq, d, k, "float32", planes=one) == \
            topk_plan.smem_bytes(bq, d, k, "float32")
    assert not topk_plan.resident(64, 1024, 32, "bfloat16")
    assert topk_plan.resident(64, 1024, 32, "bfloat16", planes=one)
    plan = topk_plan.fused_plan(1 << 21, 256, 256, 32, 132, "bfloat16",
                                planes=one)
    assert plan.bq == 64
    # A caller's plan is checked against the one-plane block on the CPU.
    emb, q = torch.zeros((4096, 8), dtype=torch.bfloat16), torch.zeros((2, 8))
    fused_dense_top_k_bf16_compare(emb, q, 4, plan=(64, 3))
    with pytest.raises(ValueError, match="bq"):
        fused_dense_top_k_bf16_compare(emb, q, 4, plan=(32, None))


def test_cpu_calls_launch_no_kernel():
    emb, q = torch.zeros((1536, 8)), torch.zeros((2, 8))
    before = fused_dense_top_k_bf16_compare.launches
    fused_dense_top_k(emb, q, 4, compare_dtype="bfloat16")
    fused_dense_top_k_bf16_compare(emb[:1024], q, 4)
    assert fused_dense_top_k_bf16_compare.launches == before
    assert fused_dense_top_k_bf16_compare in kernels.WRAPPERS
    kernels.reset_launch_counts()
    assert fused_dense_top_k_bf16_compare.launches == 0
