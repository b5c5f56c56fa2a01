"""The generators repeat from a seed, and their shapes hold."""

import torch

from benchmark.harness import gen

CFG = {"n_docs": 512, "dim": 64, "clusters": 8, "row_noise": 0.1,
       "query_noise": 0.05,
       "bm25": {"vocab_ranks": 256, "zipf_exponent": 1.0,
                "stopword_ranks": 10, "doc_words_mean": 30.0,
                "doc_words_sd": 8.0, "doc_words_min": 4,
                "doc_words_max": 64, "query_words_mean": 6.0,
                "query_from_doc": 0.5, "k1": 1.7, "b": 0.83,
                "epsilon": 0.05}}
CPU = torch.device("cpu")


def _all(seed):
    bf16 = gen.dense_bf16(CFG, seed, CPU)
    int8 = gen.dense_int8(CFG, seed, CPU)
    tc = gen.term_corpus(CFG, seed, CPU)
    pool = gen.query_pool(CFG, 64, seed, CPU, bf16_rows=bf16, tc=tc,
                          t_max=16, budget=400)
    return bf16, int8, tc, pool


def test_same_seed_same_inputs():
    a, b = _all(2**31 + 11), _all(2**31 + 11)
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1][0], b[1][0]) and torch.equal(a[1][1], b[1][1])
    for f in ("words", "indptr", "post_doc", "post_tf", "doc_len"):
        assert torch.equal(getattr(a[2], f), getattr(b[2], f))
    assert torch.equal(a[3].dense, b[3].dense)
    assert torch.equal(a[3].terms, b[3].terms)
    assert a[3].rows_cut == b[3].rows_cut


def test_other_seed_other_inputs_same_sizes():
    a, b = _all(1), _all(2)
    assert not torch.equal(a[0], b[0])
    assert a[0].shape == b[0].shape == (512, 64)
    assert a[3].terms.shape == b[3].terms.shape == (64, 16)


def test_postings_sorted_and_counted():
    tc = gen.term_corpus(CFG, 3, CPU)
    df = torch.diff(tc.indptr)
    assert int(df.sum()) == tc.post_doc.shape[0]
    for t in torch.nonzero(df > 1).flatten()[:20].tolist():
        d = tc.post_doc[tc.indptr[t]:tc.indptr[t + 1]]
        assert bool((d[1:] > d[:-1]).all())
    # Content lengths: every content word of a passage counted once.
    words = tc.words
    content = words >= tc.stop
    doc_of = torch.repeat_interleave(torch.arange(512),
                                     torch.diff(tc.offsets))
    want = torch.bincount(doc_of[content], minlength=512)
    assert torch.equal(want.to(torch.int32), tc.doc_len)


def test_query_terms_packed_and_within_budget():
    tc = gen.term_corpus(CFG, 4, CPU)
    bf16 = gen.dense_bf16(CFG, 4, CPU)
    pool = gen.query_pool(CFG, 256, 4, CPU, bf16_rows=bf16, tc=tc,
                          t_max=16, budget=300)
    t = pool.terms
    live = t >= 0
    # -1 only after the terms.
    assert bool((live[:, 1:] <= live[:, :-1]).all())
    assert bool((gen.postings_of(tc, t) <= 300).all())
    assert bool((t < tc.vocab).all())


def test_int8_rows_quantized_per_row():
    v, s = gen.dense_int8(CFG, 5, CPU)
    assert v.dtype == torch.int8 and bool((v.abs().amax(1) == 127).all())
    assert bool((s > 0).all())
