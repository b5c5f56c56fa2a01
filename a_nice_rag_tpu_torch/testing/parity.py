"""Tie-aware comparison of two top-k results.

Two correct top-k implementations agree on ids exactly except where
scores tie: exactly (the order among equal scores is the caller's tie
rule) or within the rounding of two summation orders. ``check_top_k``
accepts a differing id only where that holds and counts such swaps.
"""

from __future__ import annotations

import numpy as np


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
