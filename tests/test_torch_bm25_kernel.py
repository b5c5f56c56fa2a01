"""BM25's sparse top-k kernel (``ops/kernels/bm25_sparse.py``) on the CPU.

The kernel runs only on the card (``tests/test_torch_kernels_cuda.py``);
here its plain version, a slot-by-slot scatter-add of the counted
postings into a dense total and a stable top k, is held torch.equal to
the torch route it replaces on the card (``ops.bm25.bm25_top_k_sparse``)
on integer-valued impacts, whose totals are exact in any order: the flat
budget cut in the middle of a term, the window fetch, repeated terms, an
all-padding row, rows with fewer than k matches, a mask, postings at and
past the dump row, many exact ties. Also the counted spans, the
ascending-postings check and the retriever's route rule.
"""

import types

import pytest
import torch

from a_nice_rag_tpu_torch.index.array_index import build_bm25_arrays
from a_nice_rag_tpu_torch.ops.bm25 import (
    Bm25Arrays,
    _flat_postings_indices,
    bm25_top_k_sparse,
)
from a_nice_rag_tpu_torch.ops.kernels import bm25_sparse
from a_nice_rag_tpu_torch.ops.kernels.bm25_sparse import (
    bm25_plan,
    bm25_sparse_top_k,
    bm25_sparse_top_k_torch,
    counted_spans,
    kernel_route,
    postings_ascend,
)
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import K_MAX


def _csr(seed, n=600, v=48, df_max=150, values=(1, 6), past=0):
    """Integer-impact CSR of v terms over n documents, each term's
    documents ascending; ``past`` extra postings at and after the dump
    row n close some terms' lists."""
    g = torch.Generator().manual_seed(seed)
    indptr, ids, imps = [0], [], []
    for t in range(v):
        df = int(torch.randint(0, df_max + 1, (1,), generator=g))
        d = torch.randperm(n, generator=g)[:df].sort().values
        if past and t % 3 == 0:
            d = torch.cat([d, n + torch.arange(past)])
        ids.append(d)
        imps.append(torch.randint(values[0], values[1], (d.numel(),),
                                  generator=g).float())
        indptr.append(indptr[-1] + d.numel())
    return Bm25Arrays(
        indptr=torch.tensor(indptr, dtype=torch.int32),
        doc_ids=torch.cat(ids + [torch.tensor([n])]).to(torch.int32),
        impact=torch.cat(imps + [torch.zeros(1)]),
        n_docs_padded=n,
    )


def _queries(seed, b, t, v):
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randint(-1, v, (b, t), generator=g, dtype=torch.int32)


def _equal(bm, q, k, **kw):
    want = bm25_top_k_sparse(bm, q, k, **kw)
    got = bm25_sparse_top_k_torch(bm, q, k, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # On CPU tensors the wrapper is its plain version.
    again = bm25_sparse_top_k(bm, q, k, **kw)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    return got


@pytest.mark.parametrize("case", [
    "flat_cut_mid_term", "window", "repeated_terms", "padding_row",
    "fewer_than_k", "mask", "past_dump_row", "ties",
])
def test_plain_version_equals_torch_route(case):
    bm = _csr(7, past=3 if case == "past_dump_row" else 0,
              values=(1, 2) if case == "ties" else (1, 6))
    q = _queries(7, 9, 8, bm.vocab_size)
    kw, k = {"budget": 4096}, 25
    if case == "flat_cut_mid_term":
        starts, dfs = counted_spans(bm.indptr, q, 10**9)
        kw["budget"] = int(dfs[0, :3].sum()) + int(dfs[0, 3]) // 2 + 1
        assert 0 < int(dfs[0, 3]) // 2 + 1 < int(dfs[0, 3])
    elif case == "window":
        kw = {"df_cap": int(torch.diff(bm.indptr).max())}
    elif case == "repeated_terms":
        q[:, 4:] = q[:, :4]
    elif case == "padding_row":
        q[2] = -1
    elif case == "fewer_than_k":
        q[:, 1:] = -1
        k = 120
    elif case == "mask":
        g = torch.Generator().manual_seed(3)
        kw["mask"] = torch.rand(bm.n_docs_padded, generator=g) < 0.4
    elif case == "ties":
        k = 60
    vals, ids = _equal(bm, q, k, **kw)
    if case == "padding_row":
        assert bool((ids[2] == -1).all())
        assert bool(torch.isneginf(vals[2]).all())
    if case == "fewer_than_k":
        assert bool((ids == -1).any()) and bool((ids[:, 0] >= 0).any())
    if case == "mask":
        live = ids >= 0
        assert bool(kw["mask"][ids[live].long()].all())
    if case == "past_dump_row":
        assert bool((ids < bm.n_docs_padded).all())
    if case == "ties":
        same = vals[:, 1:] == vals[:, :-1]
        valid = ids[:, 1:] >= 0
        assert bool(same[valid].any())
        assert bool((ids[:, 1:] > ids[:, :-1])[same & valid].all())


@pytest.mark.parametrize("budget", [1, 37, 300, 10**6])
def test_counted_spans_are_the_flat_fetch(budget):
    bm = _csr(11)
    q = _queries(11, 6, 10, bm.vocab_size)
    q[1, 5:] = q[1, :5]
    starts, lens = counted_spans(bm.indptr, q, budget)
    g = _flat_postings_indices(bm.indptr, q, budget, bm.nnz)
    assert torch.equal(lens.sum(1), (g != bm.nnz).sum(1))
    # The gathered positions are the spans', slot after slot.
    for r in range(q.shape[0]):
        want = torch.cat([torch.arange(int(s), int(s) + int(n))
                          for s, n in zip(starts[r], lens[r])])
        assert torch.equal(g[r][g[r] != bm.nnz], want)
    assert bool((lens >= 0).all()) and bool((lens.sum(1) <= budget).all())


def test_counted_spans_window_and_padding():
    bm = _csr(12)
    q = _queries(12, 5, 6, bm.vocab_size)
    q[0] = -1
    df = torch.diff(bm.indptr).long()
    starts, lens = counted_spans(bm.indptr, q, 1, df_cap=20)
    want = torch.where(q >= 0, torch.clamp(df[q.clamp(min=0).long()],
                                           max=20), 0)
    assert torch.equal(lens, want)
    assert bool((lens[0] == 0).all())


def test_postings_ascend_for_the_index_layouts():
    arrays, _, _ = build_bm25_arrays(
        [["a", "b", "c"], [], ["c", "b", "b"], ["a"], ["d", "c"]], 8,
        device="cpu")
    assert postings_ascend(arrays) is True

    from benchmark.harness import gen
    cfg = {"n_docs": 400, "bm25": {
        "vocab_ranks": 256, "zipf_exponent": 1.0, "stopword_ranks": 10,
        "doc_words_mean": 30.0, "doc_words_sd": 8.0, "doc_words_min": 4,
        "doc_words_max": 64}}
    tc = gen.term_corpus(cfg, 2**31 + 5, torch.device("cpu"))
    laid = Bm25Arrays(
        indptr=tc.indptr.to(torch.int32),
        doc_ids=torch.cat([tc.post_doc, torch.tensor([400],
                                                     dtype=torch.int32)]),
        impact=torch.zeros(tc.post_doc.numel() + 1), n_docs_padded=400)
    assert postings_ascend(laid) is True
    assert postings_ascend(_csr(3, past=2)) is True


@pytest.mark.parametrize("fault", ["shuffled", "repeated", "negative"])
def test_postings_ascend_false_and_cached(fault):
    bm = _csr(5)
    df = torch.diff(bm.indptr)
    t = int(torch.nonzero(df > 3)[0])
    a, z = int(bm.indptr[t]), int(bm.indptr[t + 1])
    ids = bm.doc_ids.clone()
    if fault == "shuffled":
        ids[a:z] = ids[a:z].flip(0)
    elif fault == "repeated":
        ids[a + 1] = ids[a]
    else:
        ids[a] = -1
    bad = Bm25Arrays(bm.indptr, ids, bm.impact, bm.n_docs_padded)
    assert postings_ascend(bad) is False
    # Cached on the object: the check runs once.
    bad.doc_ids = bm.doc_ids
    assert postings_ascend(bad) is False
    assert postings_ascend(Bm25Arrays(bm.indptr, bm.doc_ids, bm.impact,
                                      bm.n_docs_padded)) is True


def test_kernel_route_rule():
    bm = _csr(9)
    assert kernel_route(bm, 25) is False  # CPU arrays
    assert bm._postings_ascend is None  # decided before the check
    card = types.SimpleNamespace(
        doc_ids=types.SimpleNamespace(device=torch.device("cuda")),
        _postings_ascend=True)
    assert kernel_route(card, 25) is True
    assert kernel_route(card, K_MAX) is True
    assert kernel_route(card, K_MAX + 1) is False
    card._postings_ascend = False
    assert kernel_route(card, 25) is False


def test_plan():
    p = bm25_plan(2_681_468, 1 << 19)
    assert p.shift == bm25_sparse.SLAB_SHIFT
    assert p.n_slabs == -(-2_681_468 >> p.shift)
    assert p.span_grid == bm25_sparse.SPAN_GRID_MAX // 2
    assert bm25_plan(5, 1).span_grid == 1
    wide = bm25_plan((bm25_sparse.MAX_SLABS << p.shift) + 1, 1)
    assert wide.shift == p.shift + 1
    assert wide.n_slabs <= bm25_sparse.MAX_SLABS
    with pytest.raises(ValueError):
        bm25_plan(100, 1, shift=11)


def _retriever(bm, **kw):
    from a_nice_rag_tpu_torch.bench import array_index
    from a_nice_rag_tpu_torch.retrieval import FusedRetriever

    n = bm.n_docs_padded
    g = torch.Generator().manual_seed(1)
    dense = torch.nn.functional.normalize(torch.randn((n, 16), generator=g),
                                          dim=1)
    index = array_index(n, dense={"m": dense}, bm25=bm)
    return FusedRetriever(index, ("m",), use_bm25=True, similarity_k=25,
                          budget=4096, dense_backend="kernel", **kw)


def test_retriever_route_on_cpu_stays_torch(monkeypatch):
    from a_nice_rag_tpu_torch.retrieval import engine

    bm = _csr(4)
    q = _queries(4, 6, 8, bm.vocab_size)
    r = _retriever(bm, two_tier_common=0)
    assert r.use_kernel
    bm25_sparse_top_k.launches = bm25_sparse_top_k.torch_route = 0
    ids = r._bm25_list(bm, q, None)
    assert bm25_sparse_top_k.torch_route == 1
    assert bm25_sparse_top_k.launches == 0
    want = bm25_top_k_sparse(bm, q, 25, budget=4096)[1]
    assert torch.equal(ids, torch.where(want >= 0, want, -1).to(ids.dtype))
    # Where the rule takes the kernel, the call reaches its wrapper (here
    # its plain version, the arrays being on the CPU) and the same list.
    monkeypatch.setattr(engine, "bm25_kernel_route", lambda *a: True)
    assert torch.equal(r._bm25_list(bm, q, None), ids)
    assert bm25_sparse_top_k.torch_route == 1


def test_two_tier_keeps_its_route(monkeypatch):
    from a_nice_rag_tpu_torch.retrieval import engine

    bm = _csr(6)
    r = _retriever(bm, two_tier_common=8)
    assert r._two_tier is not None

    def refuse(*a, **kw):
        raise AssertionError("two-tier BM25 reached the slab kernel")

    monkeypatch.setattr(engine, "bm25_sparse_top_k", refuse)
    bm25_sparse_top_k.torch_route = 0
    q = _queries(6, 4, 8, bm.vocab_size)
    r._bm25_list(r._two_tier, q, None)
    assert bm25_sparse_top_k.torch_route == 0
