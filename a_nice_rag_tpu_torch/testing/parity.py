"""Tie-aware comparison of two top-k results, and the stream sums'
checks against their plain versions.

Two correct top-k implementations agree on ids exactly except where
scores tie: exactly (the order among equal scores is the caller's tie
rule) or within the rounding of two summation orders. ``check_top_k``
accepts a differing id only where that holds and counts such swaps.
"""

from __future__ import annotations

import numpy as np
import torch

from a_nice_rag_tpu_torch.ops.kernels import stream


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu() if x.is_floating_point() else x.cpu()
    return np.asarray(x)


def check_top_k(ref_vals, ref_ids, vals, ids, atol: float) -> int:
    """Assert (vals, ids) matches (ref_vals, ref_ids) up to ties.

    Both are [B, k], values descending, (-inf, -1) in unfilled slots.
    Values must agree within ``atol`` slot by slot. Where the ids at a
    slot differ, the reference's id must appear in the other list with a
    score within ``atol`` of its reference score, or, if it fell off the
    list, its score must lie within ``atol`` of the other list's last
    score. Returns the number of slots whose ids differ.
    """
    rv, ri, v, i = (_host(a) for a in (ref_vals, ref_ids, vals, ids))
    if rv.shape != v.shape or ri.shape != i.shape:
        raise AssertionError(f"shape {v.shape} != reference {rv.shape}")
    both_inf = np.isneginf(rv) & np.isneginf(v)
    with np.errstate(invalid="ignore"):
        diff = np.where(both_inf, 0.0, np.abs(rv.astype(np.float64) - v))
    if not (diff <= atol).all():
        r, j = np.argwhere(~(diff <= atol))[0]
        raise AssertionError(
            f"value mismatch at [{r}, {j}]: {v[r, j]!r} vs reference "
            f"{rv[r, j]!r} (atol {atol})"
        )
    if not ((ri == -1) == np.isneginf(rv)).all() \
            or not ((i == -1) == np.isneginf(v)).all():
        raise AssertionError("id -1 must mark exactly the -inf slots")
    swaps = 0
    for r, j in np.argwhere(ri != i):
        swaps += 1
        want = ri[r, j]
        where = np.flatnonzero(i[r] == want)
        if where.size:
            gap = abs(float(v[r, where[0]]) - float(rv[r, j]))
        else:
            gap = abs(float(rv[r, j]) - float(v[r, -1]))
        if not gap <= atol:
            raise AssertionError(
                f"id mismatch at [{r}, {j}]: {i[r, j]} vs reference {want} "
                f"whose scores differ by {gap} (atol {atol})"
            )
    return swaps


# Stream sums: float32 partial sums in another order than the plain
# version's float64 sum, relative to the sum of absolute values.
STREAM_RTOL = 1e-5


def check_stream_sum(parts, bias=None, **launch) -> float:
    """``stream_sum(parts, bias, **launch)`` against its plain version
    within ``STREAM_RTOL`` of the sum of absolute values (the bias's
    included). Returns the absolute difference."""
    got = float(stream.stream_sum(parts, bias, **launch))
    ref = float(stream.stream_sum_torch(parts, bias))
    tol = STREAM_RTOL * (stream.abs_total(parts)
                         + (0.0 if bias is None else abs(float(bias))))
    if not abs(got - ref) <= tol:
        raise AssertionError(f"stream_sum {got} differs from its plain "
                             f"version {ref} (tolerance {tol}, {launch})")
    return abs(got - ref)


def check_stream_sum_busy(emb, seed, x_iters: int, grid: int,
                          tile_rows: int) -> float:
    """``stream_sum_busy`` against its plain version: every chain bit for
    bit, the sum within ``STREAM_RTOL``. Returns the sum's difference."""
    out, work = stream.stream_sum_busy(emb, seed, x_iters, grid, tile_rows)
    ref_out, ref_work = stream.stream_sum_busy_torch(emb, seed, x_iters,
                                                     grid, tile_rows)
    if not torch.equal(work, ref_work):
        raise AssertionError(f"stream_sum_busy: a chain differs from the "
                             f"host's (X={x_iters})")
    err = abs(float(out) - float(ref_out))
    tol = STREAM_RTOL * (stream.abs_total(emb) + abs(float(seed)))
    if not err <= tol:
        raise AssertionError(f"stream_sum_busy: sum off by {err} (X="
                             f"{x_iters}, tolerance {tol})")
    return err
