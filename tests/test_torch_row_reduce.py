"""P6's one-pass row reduction: its split-and-merge order, on the CPU.

``bf16_row_reduce``'s CUDA kernel (``csrc/keys.cu``) gives each row one
CTA of ``threads`` threads (``row_plan``), gives each thread a strided
share of the row's 16-byte vectors (and a column of the scalar head
before the first 16-byte boundary and of the scalar tail), keeps per
thread the summary (max, its lowest column, the largest value strictly
below the max, the lowest column of +0.0) and merges the summaries by
warp butterflies, then by one warp's butterflies over the warps'
partials; the masked max
is max(below, bf16(-3e38)), the packed-key argmax the max's column but
where the max is 0 and +0.0 occurs. No kernel runs here, so ``_emulate``
repeats that order in plain torch and is held against
``bf16_row_reduce_torch`` with ``torch.equal`` on all four outputs (the
algebra is exact, so no tolerance), on the edge cases the card's checks
use.
"""

import pytest
import torch

from a_nice_rag_tpu_torch.ops.kernels import bf16_row_reduce_torch
from a_nice_rag_tpu_torch.ops.kernels.keys import (
    ROW_UNROLL,
    bf16_row_reduce,
    row_plan,
)
from a_nice_rag_tpu_torch.probes import bf16_fold

MASKED = torch.tensor(-3e38).to(torch.bfloat16).float()


def _merge(a, b):
    (at, ac, ab, az), (bt, bc, bb, bz) = a, b
    t = torch.where(bt > at, bt, at)
    below = torch.maximum(ab, bb)
    below = torch.where(at < t, torch.maximum(below, at), below)
    below = torch.where(bt < t, torch.maximum(below, bt), below)
    col = torch.where(bt > at, bc,
                      torch.where(at > bt, ac, torch.minimum(ac, bc)))
    return t, col, below, torch.minimum(az, bz)


def _butterfly(p):
    """Each lane merged with lane ^ off for off = 16 ... 1 (last axis)."""
    for off in (16, 8, 4, 2, 1):
        perm = torch.arange(32) ^ off
        p = _merge(p, tuple(t[..., perm] for t in p))
    return p


def _owners(width, head, threads):
    """Thread that reads each column."""
    n_vec = (width - head) // 4
    tail0 = head + 4 * n_vec
    col = torch.arange(width)
    owner = (col - head).clamp(min=0) // 4 % threads
    owner = torch.where(col < head, col, owner)
    return torch.where(col >= tail0, col - tail0, owner)


def _thread_parts(x, owner, n):
    """Each of n threads' summary of the columns it reads: [R, n]."""
    r, w = x.shape
    s = x.to(torch.bfloat16).float()
    idx = owner.expand(r, w)
    cols = torch.arange(w)
    top = torch.full((r, n), float("-inf")).scatter_reduce(
        1, idx, s, "amax")
    top_c = top.gather(1, idx)
    col = torch.full((r, n), w, dtype=torch.int64).scatter_reduce(
        1, idx, torch.where(s == top_c, cols, w), "amin")
    below = torch.full((r, n), float("-inf")).scatter_reduce(
        1, idx, torch.where(s < top_c, s, float("-inf")), "amax")
    plus_zero = s.view(torch.int32) == 0
    pz = torch.full((r, n), w, dtype=torch.int64).scatter_reduce(
        1, idx, torch.where(plus_zero, cols, w), "amin")
    return top, col, below, pz


def _emulate(x, align, threads):
    """The kernel's reduction order in plain torch; ``align`` is row 0's
    base address mod 16, in elements."""
    r, w = x.shape
    out = [torch.empty(r), torch.empty(r, dtype=torch.int64), torch.empty(r),
           torch.empty(r, dtype=torch.int64)]
    heads = torch.tensor([min(w, (4 - (align + i * w) % 4) % 4)
                          for i in range(r)])
    for head in heads.unique().tolist():
        rows = heads == head
        parts = _thread_parts(x[rows], _owners(w, head, threads), threads)
        # [R, warp, lane]: butterflies in each warp; then one warp's
        # butterflies over the warps' partials (lanes past the warp count
        # hold warp 0's).
        p = tuple(t.reshape(-1, threads // 32, 32) for t in parts)
        p = _butterfly(p)
        lanes = torch.arange(32)
        lanes = torch.where(lanes < threads // 32, lanes, 0)
        warps = tuple(t[:, lanes, 0] for t in p)
        top, col, below, pz = (t[..., 0] for t in _butterfly(warps))
        out[0][rows], out[1][rows] = top, col
        out[2][rows] = torch.maximum(below, MASKED)
        out[3][rows] = torch.where((top == 0) & (pz < w), pz, col)
    return (out[0], out[1].to(torch.int32), out[2], out[3].to(torch.int32))


# The card's edge shapes up to 2^21 elements (the emulation is slow).
SHAPES = [s for s in bf16_fold.EDGE_SHAPES if s[0] * s[1] <= 1 << 21]


@pytest.mark.parametrize("threads", [256, 512])
@pytest.mark.parametrize("kind", bf16_fold.EDGE_KINDS)
def test_split_merge_order_matches_plain(kind, threads):
    # threads: the CTA of a row.
    g = torch.Generator().manual_seed(8)
    for i, (rows, width) in enumerate(SHAPES):
        x = bf16_fold.edge_values(kind, rows, width, g)
        align = i % 4
        for name, got, want in zip(("max", "arg", "second", "packed"),
                                   _emulate(x, align, threads),
                                   bf16_row_reduce_torch(x)):
            assert torch.equal(got, want), (name, kind, rows, width, align)


@pytest.mark.parametrize("threads", [256, 512])
def test_emulation_sees_a_tie_across_warps(threads):
    # The max in the last warp's first vectors and in warp 0's second
    # ones (a higher column): the lower column wins, whichever warp
    # merges first.
    w = 4 * threads * 2
    hi, lo = 4 * (threads - 32) + 1, 4 * threads + 2
    x = torch.zeros((1, w))
    x[0, hi] = x[0, lo] = x[0, w - 1] = 5.0
    x[0, 7] = 4.0
    for align in range(4):
        top, arg, second, packed = _emulate(x, align, threads)
        assert (float(top), int(arg), float(second), int(packed)) == (
            5.0, hi, 4.0, hi)


def test_packed_argmax_prefers_plus_zero():
    # -0.0 and +0.0 tie for the max; the packed key puts +0.0 above.
    x = torch.tensor([[-1.0, -0.0, -2.0, 0.0, -0.0, 0.0]])
    for threads in (256, 512):
        top, arg, second, packed = _emulate(x, 0, threads)
        assert (float(top), int(arg), float(second), int(packed)) == (
            0.0, 1, -1.0, 3)
        assert int(bf16_row_reduce_torch(x)[3]) == 3


@pytest.mark.parametrize("width,want", [
    (1, 256), (17, 256), (4097, 256), (8192, 256), (8196, 512),
    (16_384, 512), (65_536, 512),
])
def test_row_plan(width, want):
    threads = row_plan(width)
    assert threads == want
    # 256 threads while each holds at most ROW_UNROLL 16-byte vectors.
    assert (threads == 512) == (width // 4 > ROW_UNROLL * 256)


def test_edge_cases_on_the_cpu_take_the_plain_version():
    before = bf16_row_reduce.launches
    shapes = ((1, 1), (7, 3), (4096, 17))
    line = bf16_fold.check_edges(torch.device("cpu"), shapes)
    assert bf16_row_reduce.launches == before
    assert line["cases"] == (len(shapes) * len(bf16_fold.EDGE_KINDS)
                             * len(bf16_fold.EDGE_OFFSETS))
    # The views start mid-buffer, as on the card.
    labels = [label for label, x in bf16_fold.edge_cases(
        torch.device("cpu"), shapes=((7, 3),), kinds=("normal",))]
    assert labels == ["normal [7, 3] +0", "normal [7, 3] +1",
                      "normal [7, 3] +3"]


def test_kernel_times_take_warm_and_cold_inputs():
    seen = []

    def kernel_ms(fn, n):
        fn()
        seen.append(n)
        return 1.0

    lines = bf16_fold.kernel_times(torch.device("cpu"), kernel_ms,
                                   shapes=((8, 4096),), n=3)
    assert seen == [3, 3]
    (line,) = lines
    assert line["shape"] == [8, 4096]
    assert line["kernel_ms"] == line["kernel_cold_ms"] == 1.0
    # 2 x 50 MB of 128 KB copies, and one more.
    assert line["cold_copies"] == 2 * bf16_fold.L2_BYTES // (8 * 4096 * 4) + 1
