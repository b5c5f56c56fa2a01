"""BM25's sparse top-k on the card at the BEIR-NQ shape: the slab kernel
(``bm25_sparse_top_k``) against the sort-based torch route
(``ops.bm25.bm25_top_k_sparse``) on the same postings and queries.

    python -m a_nice_rag_tpu_torch.probes.bm25_sparse [--seed N]
        [--out FILE]

The corpus is made on the card from ``--seed``: 2,681,468 passages of
78.88 words on average (sd 25, clipped to [8, 256]), each word a rank of
a Zipf(1) law over 2^20 ranks, the 179 head ranks dropped as stopwords
(about 127M postings, each term's passages ascending, impacts uniform in
[0.5, 4)); B = 256 queries of Poisson(9.16) words (at most 32), half
from a gold passage and half from the law, stopwords dropped, the rest
-1; a query's terms past the 2^19-posting budget are dropped, as the
benchmark's generator does. k = 25, the flat fetch.

For the kernel under each slab width (``SHIFTS``) and for the torch
route: the event pair around one call (median of 10 after 3 warm-ups),
and the kernels of one call alone and their count (``torch.profiler``);
the byte bound (the fetched postings' 8 bytes each, the query terms and
the output over 3.35 TB/s); whether the kernel's lists equal its plain
version's and the torch route's ids (the route's totals are a prefix-sum
difference, so its ids may differ where totals are within its rounding).
One JSON line, card first, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import NamedTuple

REPO = Path(__file__).resolve().parents[2]
HBM_BYTES_S = 3.35e12
WORDS_MEAN, WORDS_SD, WORDS_MIN, WORDS_MAX = 78.88, 25.0, 8, 256
QUERY_WORDS = 9.16
K = 25
SHIFTS = (12, 13, 14)
CHUNK = 1 << 25


class Shape(NamedTuple):
    """The corpus and batch of the probe: ``docs`` passages, Zipf(1)
    words over ``ranks`` ranks less ``stopwords`` head ranks, ``b``
    queries of at most ``t_max`` terms within ``budget`` postings."""

    docs: int = 2_681_468
    ranks: int = 1 << 20
    stopwords: int = 179
    b: int = 256
    t_max: int = 32
    budget: int = 1 << 19


NQ = Shape()


def zipf_corpus(g, device, shape: Shape = NQ):
    """(``Bm25Arrays``, words [W] int32, offsets [docs + 1] int64, the
    law's cdf) of the seeded corpus: each term's passages ascending,
    impacts uniform in [0.5, 4)."""
    import torch

    from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays

    n = shape.docs
    lens = torch.round(WORDS_MEAN + WORDS_SD * torch.randn(
        (n,), generator=g, device=device))
    lens = torch.clamp(lens, WORDS_MIN, WORDS_MAX).long()
    offsets = torch.zeros((n + 1,), dtype=torch.int64, device=device)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1])
    p = torch.arange(1, shape.ranks + 1, dtype=torch.float64,
                     device=device) ** -1.0
    cdf = torch.cumsum(p / p.sum(), 0)
    cdf[-1] = 1.0
    words = torch.empty((total,), dtype=torch.int32, device=device)
    for w0 in range(0, total, CHUNK):
        m = min(CHUNK, total - w0)
        u = torch.rand((m,), generator=g, dtype=torch.float64, device=device)
        words[w0:w0 + m] = torch.clamp(torch.searchsorted(cdf, u),
                                       max=shape.ranks - 1)
    doc_of = torch.repeat_interleave(
        torch.arange(n, device=device, dtype=torch.int64), lens)
    content = words >= shape.stopwords
    keys = (words[content].long() - shape.stopwords) * n + doc_of[content]
    del doc_of, content
    keys = torch.unique(keys)  # sorted: by term, then passage
    term = keys // n
    docs = (keys - term * n).to(torch.int32)
    del keys
    df = torch.bincount(term, minlength=shape.ranks - shape.stopwords)
    del term
    indptr = torch.zeros((df.numel() + 1,), dtype=torch.int64, device=device)
    torch.cumsum(df, 0, out=indptr[1:])
    impact = 0.5 + 3.5 * torch.rand((docs.numel(),), generator=g,
                                    device=device)
    bm = Bm25Arrays(
        indptr=indptr.to(torch.int32),
        doc_ids=torch.cat([docs, torch.tensor([n], dtype=torch.int32,
                                              device=device)]),
        impact=torch.cat([impact, torch.zeros(1, device=device)]),
        n_docs_padded=n)
    return bm, words, offsets, cdf


def queries(g, bm, words, offsets, cdf, shape: Shape = NQ):
    """[b, t_max] int32 term ids, -1 padded, within the budget."""
    import torch

    dev = words.device
    b, t_max = shape.b, shape.t_max
    qlen = torch.poisson(torch.full((b,), QUERY_WORDS, device=dev),
                         generator=g)
    qlen = torch.clamp(qlen, 1, t_max).long()
    gold = torch.randint(0, shape.docs, (b,), generator=g, device=dev)
    start, span = offsets[gold], offsets[gold + 1] - offsets[gold]
    u = torch.rand((b, t_max), generator=g, device=dev, dtype=torch.float64)
    pick = start[:, None] + torch.clamp((u * span[:, None]).long(),
                                        max=(span - 1)[:, None])
    fresh = torch.clamp(torch.searchsorted(cdf, torch.rand(
        (b, t_max), generator=g, device=dev, dtype=torch.float64)),
        max=shape.ranks - 1)
    from_doc = torch.rand((b, t_max), generator=g, device=dev) < 0.5
    ranks = torch.where(from_doc, words[pick].long(), fresh)
    live = torch.arange(t_max, device=dev)[None, :] < qlen[:, None]
    term = torch.where(live & (ranks >= shape.stopwords),
                       ranks - shape.stopwords, -1)
    order = torch.argsort((term < 0).to(torch.int8), dim=1, stable=True)
    term = torch.gather(term, 1, order)
    df = torch.diff(bm.indptr).long()
    need = torch.where(term >= 0, df[term.clamp(min=0)], 0)
    term = torch.where(torch.cumsum(need, 1) > shape.budget, -1, term)
    return term.to(torch.int32).contiguous()


def case(seed: int, device, shape: Shape = NQ):
    """(arrays, query terms [b, t_max]) of ``seed`` at ``shape``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    bm, words, offsets, cdf = zipf_corpus(g, device, shape)
    return bm, queries(g, bm, words, offsets, cdf, shape)


def fetched(bm, q, shape: Shape = NQ) -> int:
    """The postings the batch fetches."""
    from a_nice_rag_tpu_torch.ops.kernels.bm25_sparse import counted_spans

    return int(counted_spans(bm.indptr, q, shape.budget)[1].sum())


def call_bytes(bm, q, shape: Shape = NQ) -> int:
    """The bytes one call must move: each fetched posting's 8 (int32 id,
    f32 impact), the query terms and the (score, id) output."""
    return 8 * fetched(bm, q, shape) + 4 * q.numel() + 8 * shape.b * K


def timed(fn, timing) -> dict:
    kernel_ms, launches = timing.profiled_device_ms(fn, 10, warmup=3)
    return {"event_ms": timing.cuda_event_ms(fn), "kernel_ms": kernel_ms,
            "launches": launches}


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2681468)
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA GPU visible", file=sys.stderr)
        return 3
    from a_nice_rag_tpu_torch import bench
    from a_nice_rag_tpu_torch.ops.bm25 import bm25_top_k_sparse
    from a_nice_rag_tpu_torch.ops.kernels import bm25_sparse
    from a_nice_rag_tpu_torch.testing import timing

    dev = torch.device("cuda")
    shape = NQ
    bm, q = case(args.seed, dev, shape)
    assert bm25_sparse.kernel_route(bm, K)
    fetched = bm25_sparse.counted_spans(bm.indptr, q, shape.budget)[1].sum(1)

    def kernel(shift):
        plan = bm25_sparse.bm25_plan(shape.docs, shape.budget, shift=shift)
        return lambda: bm25_sparse.bm25_sparse_top_k(
            bm, q, K, budget=shape.budget, plan=plan)

    def route():
        return bm25_top_k_sparse(bm, q, K, budget=shape.budget)

    got = kernel(bm25_sparse.SLAB_SHIFT)()
    plain = bm25_sparse.bm25_sparse_top_k_torch(bm, q, K,
                                                budget=shape.budget)
    sorted_route = route()
    torch.cuda.synchronize()
    out = {
        "card": bench.card_line(), "seed": args.seed,
        "shape": dict(shape._asdict(), nnz=bm.nnz, k=K,
                      max_df=int(torch.diff(bm.indptr).max())),
        "fetched_mean": float(fetched.double().mean()),
        "fetched_max": int(fetched.max()),
        "bound_ms": call_bytes(bm, q, shape) / HBM_BYTES_S * 1e3,
        "equal_plain": bool(torch.equal(got[0], plain[0])
                            and torch.equal(got[1], plain[1])),
        "ids_equal_route": float((got[1] == sorted_route[1]).double().mean()),
        "method": "event_ms: CUDA events around one call, median of 10 "
        "after 3 warm-ups; kernel_ms / launches: torch.profiler, the device "
        "time and kernels of one call over 10 calls",
        "kernel": {str(s): timed(kernel(s), timing) for s in SHIFTS},
        "torch_route": timed(route, timing),
    }
    best = min(v["kernel_ms"] for v in out["kernel"].values())
    out["route_over_kernel"] = out["torch_route"]["kernel_ms"] / best
    out["kernel_over_bound"] = best / out["bound_ms"]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
