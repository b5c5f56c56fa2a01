"""The plain reference against hand-made cases and the tie rule."""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import gen, reference as ref

INF = math.inf


def _gap(best, got, ids, scale=None):
    def t(x, d):
        return torch.tensor([x], dtype=d)

    s = None if scale is None else torch.tensor([scale], dtype=torch.float64)
    return float(ref.list_gap(t(best, torch.float64), t(got, torch.float64),
                              t(ids, torch.int64), s)[0])


def test_list_gap_ties_pass_any_order():
    # Two documents tie at 0.5: either order reads 0.
    assert _gap([0.9, 0.5, 0.5], [0.9, 0.5, 0.5], [3, 8, 2]) == 0.0
    assert _gap([0.9, 0.5, 0.5], [0.9, 0.5, 0.5], [3, 2, 8]) == 0.0


def test_list_gap_order_missing_and_repeats():
    assert _gap([0.9, 0.7, 0.5], [0.7, 0.9, 0.5], [1, 0, 2]) \
        == pytest.approx(0.2)
    # A missed document shows at the rank it should have held.
    assert _gap([0.9, 0.7, 0.5], [0.9, 0.5, 0.4], [0, 2, 5]) \
        == pytest.approx(0.2)
    assert _gap([0.9, 0.7, 0.5], [0.9, 0.9, 0.5], [0, 0, 2]) == INF
    # -1 where a document is due, or a document where none is.
    assert _gap([0.9, 0.7, 0.5], [0.9, 0.7, -INF], [0, 1, -1]) == INF
    assert _gap([0.9, -INF, -INF], [0.9, 0.0, -INF], [0, 4, -1]) == INF
    assert _gap([0.9, -INF, -INF], [0.9, -INF, -INF], [0, -1, -1]) == 0.0
    assert _gap([2.0, 1.0], [1.0, 1.0], [1, 9], scale=2.0) \
        == pytest.approx(0.5)


def test_dense_reference_bf16_and_int8():
    rows = torch.tensor([[1.0, 0.0], [0.6, 0.8], [0.0, 1.0]])
    q = torch.tensor([[0.8, 0.6]])
    r16 = rows.to(torch.bfloat16)
    d = ref.DenseReference(q, bf16_rows=r16)
    exact = (r16.double() @ q.double().T)[:, 0]  # 0.6 -> 0.6015625 etc.
    assert d.best(2).tolist()[0] == sorted(exact.tolist())[::-1][:2]
    assert d.scores_of(torch.tensor([[1, -1]]))[0, 1] == -INF
    assert d.scores_of(torch.tensor([[7, 0]]))[0, 0] == -INF
    v = torch.tensor([[127, 0], [76, 102], [0, 127]], dtype=torch.int8)
    s = torch.tensor([1 / 127, 0.8 / 102, 1 / 127])
    d8 = ref.DenseReference(q, int8_rows=(v, s))
    qv, qs = ref.quantize(q, 127)
    assert qv.tolist() == [[127.0, 95.0]]  # 0.6 / (0.8 / 127) = 95.25
    want = (127 * 76 + 95 * 102) * float(qs[0]) * float(s[1])
    assert float(d8.scores_of(torch.tensor([[1]]))[0, 0]) \
        == pytest.approx(want, rel=1e-12)


def test_quantize_rounds_half_to_even():
    v, s = ref.quantize(torch.tensor([[2.5, -0.5, 1.5, 127.0]]), 127)
    assert float(s[0]) == 1.0
    assert v.tolist() == [[2.0, -0.0, 2.0, 127.0]]


def _hand_corpus():
    # 5 passages, 3 content terms: term 0 in p0 (tf 2), p2, p3, p4 (tf 1);
    # term 1 in p1 (tf 1); term 2 in p3 (tf 3).
    return gen.TermCorpus(
        words=None, offsets=None, indptr=torch.tensor([0, 4, 5, 6]),
        post_doc=torch.tensor([0, 2, 3, 4, 1, 3], dtype=torch.int32),
        post_tf=torch.tensor([2, 1, 1, 1, 1, 3], dtype=torch.int16),
        doc_len=torch.tensor([4, 2, 3, 6, 1], dtype=torch.int32), vocab=3,
        stop=0)


def test_bm25_reference_okapi():
    bm = {"k1": 1.5, "b": 0.75, "epsilon": 0.25}
    r = ref.Bm25Reference(_hand_corpus(), bm)
    avgdl = 16 / 5
    raw = [math.log(5 - df + 0.5) - math.log(df + 0.5) for df in (4, 1, 1)]
    idf0 = 0.25 * sum(raw) / 3  # negative: floored at epsilon x mean
    idf1 = idf2 = raw[1]

    def imp(idf, tf, dl):
        return idf * tf * 2.5 / (tf + 1.5 * (0.25 + 0.75 * dl / avgdl))

    s = r.scores([0, 0, 2, -1])  # term 0 twice
    assert s.tolist() == pytest.approx(
        [2 * imp(idf0, 2, 4), 0.0, 2 * imp(idf0, 1, 3),
         2 * imp(idf0, 1, 6) + imp(idf2, 3, 6), 2 * imp(idf0, 1, 1)])
    best, got = r.best_and_of([1], torch.tensor([1, 0, -1]), 3)
    assert best.tolist() == pytest.approx([imp(idf1, 1, 2), -INF, -INF])
    assert got.tolist()[1:] == [-INF, -INF]  # p0 does not match term 1
    # The order follows the scores, -1 past the matching passages.
    order = sorted(range(5), key=lambda d: -s[d] if d != 1 else 0)
    assert r.top_ids([0, 0, 2], 5).tolist() == [
        d for d in order if d != 1] + [-1]


def test_bm25_fetched_total_counts_every_fetch():
    bm = {"k1": 1.5, "b": 0.75, "epsilon": 0.25}
    r = ref.Bm25Reference(_hand_corpus(), bm)
    one = float(r.scores([0]).sum())
    two = float(r.scores([2]).sum())
    assert r.fetched_total([0, 0, 2, -1]) == pytest.approx(2 * one + two)
    assert r.fetched_total([-1]) == 0.0


def test_bm25_gap_in_float32_roundings():
    """``bm25_gap_f32`` is the gap over 2^-24 x the row's fetched total;
    ``bm25_gap`` the same gap over the row's best score."""
    from benchmark.harness import check

    tc = _hand_corpus()
    cfg = {"retriever": {"similarity_k": 3, "common_sections_n": 3},
           "weights": {"M": 1.0, "BM25": 1.0}, "model": "M", "wrrf_k": 40.0,
           "bm25": {"k1": 1.5, "b": 0.75, "epsilon": 0.25}}
    r = ref.Bm25Reference(tc, cfg["bm25"])
    terms = [0, 2]
    s = r.scores(terms)
    order = torch.sort(s, descending=True, stable=True).indices[:3]
    swapped = order[[1, 0, 2]]  # the two best in the wrong order
    rows = torch.zeros((5, 2), dtype=torch.bfloat16)
    rows[:, 0] = 1
    q = np.array([[1.0, 0.0]], np.float32)
    dense = np.array([[0, 1, 2]], np.int32)

    def numbers(bm_ids):
        lists = np.stack([dense, bm_ids.numpy()[None].astype(np.int32)])
        fids, fvals = ref.wrrf(lists, [1.0, 1.0], 40.0, 3)
        sampled = check.Sampled(
            queries=q, terms=np.array([terms + [-1]], np.int32),
            lists=lists, fids=fids, fvals=fvals)
        return check.list_numbers(
            cfg, sampled, {"device": torch.device("cpu"), "bf16": rows,
                           "terms": tc})

    assert numbers(order)["bm25_gap"] == 0.0
    assert numbers(order)["bm25_gap_f32"] == 0.0
    got = numbers(swapped)
    gap = float(s[order[0]] - s[order[1]])
    assert got["bm25_gap"] == pytest.approx(gap / float(s[order[0]]))
    assert got["bm25_gap_f32"] == pytest.approx(
        gap / (2.0 ** -24 * r.fetched_total(terms)))


def test_wrrf_sums_and_tie_rule():
    lists = np.array([[[5, 7, -1]], [[7, 9, 5]]], dtype=np.int32)
    ids, vals = ref.wrrf(lists, [2.0, 1.0], 40.0, 3)
    def c(w, r):
        return np.float32(w) / (np.float32(40.0) + np.float32(r))

    want = {5: np.float32(c(2, 1) + c(1, 3)),
            7: np.float32(c(2, 2) + c(1, 1)), 9: c(1, 2)}
    order = sorted(want, key=lambda d: (-want[d], d))
    assert ids[0].tolist() == order
    assert vals[0].tolist() == [want[d] for d in order]
    # Equal scores: the lower id first.
    tie = np.array([[[4, -1]], [[-1, 4]]], dtype=np.int32)
    same = np.array([[[8, 3]]], dtype=np.int32)
    ids, vals = ref.wrrf(np.concatenate([same, same]), [1.0, 1.0], 40.0, 2)
    assert ids[0].tolist() == [8, 3]
    ids, _ = ref.wrrf(np.array([[[8, 3]], [[3, 8]]], dtype=np.int32),
                      [1.0, 1.0], 40.0, 2)
    assert ids[0].tolist() == [3, 8]
    ids, vals = ref.wrrf(tie, [1.0, 1.0], 40.0, 2)
    assert ids[0].tolist() == [4, -1]
    one = ref.wrrf(np.array([[[3, 1, 2]]], dtype=np.int32), [1.0], 40.0, 2)
    assert one[0].tolist() == [[3, 1]] and one[1].tolist() == [[0.0, 0.0]]


def test_control_lists_one_precision_lower():
    g = torch.Generator().manual_seed(0)
    rows = gen.unit(torch.randn((2048, 64), generator=g)).to(torch.bfloat16)
    q = gen.unit(torch.randn((16, 64), generator=g))
    d = ref.DenseReference(q, bf16_rows=rows)
    ids = d.control_ids(q, 10)
    gap = ref.list_gap(d.best(10), d.scores_of(ids), ids)
    assert float(gap.max()) > 1e-4  # int8 rows and queries
