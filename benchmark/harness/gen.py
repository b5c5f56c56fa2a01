"""Seeded generators of the corpora and the query pool, on the device.

Everything a run feeds the system comes from ``--seed`` through
:func:`make_generator`, one stream per purpose, so the same seed gives
the same corpus and queries and the streams do not shift one another.
Every seed gets the same sizes: only values and order change.

* Dense rows: unit vectors around ``clusters`` random unit centres
  (``row_noise`` per component), as an embedding model's neighbourhoods;
  bf16 rows are rounded once, int8 rows quantized per row (scale =
  max|x| / 127, round half to even).
* Term counts: each passage draws its length in words from a normal law
  around the source's mean, each word a rank of a Zipf law over
  ``vocab_ranks`` ranks; the ``stopword_ranks`` head ranks are dropped as
  the port's text path drops stopwords, and rank r >= stopword_ranks is
  term r - stopword_ranks. Postings are (term, passage, tf), sorted by
  term and then passage.
* Queries: a gold passage each; the dense query is the gold row plus
  ``query_noise`` per component, renormalized; the query's words (a
  Poisson length around the source's mean, clipped to t_max) come from
  the gold passage's words with probability ``query_from_doc``, else from
  the Zipf law; stopwords dropped, term ids packed first and -1 after.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

# Rows generated (and quantized) at a time: 2^20 x 1024 f32 is 4 GiB.
CHUNK_ROWS = 1 << 20
# Words drawn at a time.
CHUNK_WORDS = 1 << 25


def make_generator(device, seed: int, stream: str) -> torch.Generator:
    """A generator on ``device`` for one purpose of one seed."""
    h = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return g


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def centres(g: torch.Generator, clusters: int, d: int,
            device) -> torch.Tensor:
    """[clusters, d] random unit centres."""
    return unit(torch.randn((clusters, d), generator=g, device=device))


def clustered_rows(g: torch.Generator, n: int, d: int, clusters: int,
                   noise: float, device) -> Iterator[Tuple[int, torch.Tensor]]:
    """(first row, f32 unit rows [<= CHUNK_ROWS, d]) around random unit
    centres."""
    return rows_around(g, centres(g, clusters, d, device), n, noise, device)


def rows_around(g: torch.Generator, cent: torch.Tensor, n: int, noise: float,
                device) -> Iterator[Tuple[int, torch.Tensor]]:
    """(first row, f32 unit rows [<= CHUNK_ROWS, d]) around ``cent``."""
    clusters, d = cent.shape
    for r0 in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - r0)
        a = torch.randint(0, clusters, (m,), generator=g, device=device)
        x = cent[a] + noise * torch.randn((m, d), generator=g, device=device)
        yield r0, unit(x)
        del x, a


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8: scale max|x| / 127, values round(x / scale) (half to
    even), clipped to +-127."""
    x = x.to(torch.float32)
    scales = x.abs().amax(dim=1) / 127.0
    safe = torch.clamp_min(scales, 1e-12)
    vals = torch.clamp(torch.round(x / safe[:, None]), -127, 127)
    return vals.to(torch.int8), scales


def dense_bf16(cfg: dict, seed: int, device) -> torch.Tensor:
    n, d = cfg["n_docs"], cfg["dim"]
    g = make_generator(device, seed, "dense")
    out = torch.empty((n, d), dtype=torch.bfloat16, device=device)
    for r0, x in clustered_rows(g, n, d, cfg["clusters"], cfg["row_noise"],
                                device):
        out[r0:r0 + x.shape[0]] = x.to(torch.bfloat16)
    return out


def dense_int8(cfg: dict, seed: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = cfg["n_docs"], cfg["dim"]
    g = make_generator(device, seed, "dense")
    values = torch.empty((n, d), dtype=torch.int8, device=device)
    scales = torch.empty((n,), dtype=torch.float32, device=device)
    for r0, x in clustered_rows(g, n, d, cfg["clusters"], cfg["row_noise"],
                                device):
        v, s = quantize_rows(x)
        values[r0:r0 + x.shape[0]] = v
        scales[r0:r0 + x.shape[0]] = s
    return values, scales


def shard_rows(n: int, shards: int) -> int:
    """Rows a corpus shard holds (``n_local``), as the port lays a corpus
    over a mesh: ceil(n / shards) rounded up to a multiple of 128. Shard s
    holds global rows [s * n_local, (s + 1) * n_local); rows past ``n``
    are zero pad rows."""
    n_local = -(-n // shards)
    return -(-n_local // 128) * 128


@dataclasses.dataclass
class Int8Shard:
    """One shard's int8 rows on its own device: global rows [offset,
    offset + n_real) and zero pad rows after them."""

    values: torch.Tensor   # [n_local, D] int8
    scales: torch.Tensor   # [n_local] f32
    offset: int
    n_real: int

    @property
    def device(self) -> torch.device:
        return self.values.device


def dense_int8_shards(cfg: dict, seed: int, devices
                      ) -> List[Int8Shard]:
    """The int8 corpus laid out by shard, shard s made on ``devices[s]``.
    The centres come from one stream, the same on every device; each
    shard's rows from a stream of their own, named after the seed and the
    shard, so a shard's rows do not depend on the others or on the order
    they are made in. Blocks of ``CHUNK_ROWS`` go to the devices in turn,
    so that every device works while the host queues the next."""
    n, d = cfg["n_docs"], cfg["dim"]
    n_local = shard_rows(n, len(devices))
    out, blocks = [], []
    for s, dev in enumerate(devices):
        cent = centres(make_generator(dev, seed, "dense"), cfg["clusters"],
                       d, dev)
        offset = s * n_local
        n_real = max(0, min(n_local, n - offset))
        sh = Int8Shard(
            values=torch.zeros((n_local, d), dtype=torch.int8, device=dev),
            scales=torch.zeros((n_local,), dtype=torch.float32, device=dev),
            offset=offset, n_real=n_real)
        out.append(sh)
        blocks.append(rows_around(make_generator(dev, seed, f"dense/{s}"),
                                  cent, n_real, cfg["row_noise"], dev))
    for turn in itertools.zip_longest(*blocks):
        for sh, block in zip(out, turn):
            if block is None:
                continue
            r0, x = block
            v, sc = quantize_rows(x)
            sh.values[r0:r0 + x.shape[0]] = v
            sh.scales[r0:r0 + x.shape[0]] = sc
    return out


def zipf_cdf(ranks: int, exponent: float, device) -> torch.Tensor:
    p = torch.arange(1, ranks + 1, dtype=torch.float64,
                     device=device) ** -exponent
    cdf = torch.cumsum(p / p.sum(), 0)
    cdf[-1] = 1.0
    return cdf


def draw_ranks(g: torch.Generator, cdf: torch.Tensor, m: int) -> torch.Tensor:
    u = torch.rand((m,), generator=g, dtype=torch.float64, device=cdf.device)
    r = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(r, max=cdf.shape[0] - 1).to(torch.int32)


@dataclasses.dataclass
class TermCorpus:
    """Generated term counts: every passage's words (ranks, passage-major)
    and the postings of the content terms, CSR by term."""

    words: torch.Tensor      # [W] int32 ranks, passage-major
    offsets: torch.Tensor    # [n + 1] int64 first word of each passage
    indptr: torch.Tensor     # [V + 1] int64 postings of each term
    post_doc: torch.Tensor   # [nnz] int32 passage, ascending in a term
    post_tf: torch.Tensor    # [nnz] int16 term count in the passage
    doc_len: torch.Tensor    # [n] int32 content terms of each passage
    vocab: int               # content terms (ranks - stopword ranks)
    stop: int                # stopword ranks


def term_corpus(cfg: dict, seed: int, device) -> TermCorpus:
    bm = cfg["bm25"]
    n = cfg["n_docs"]
    stop = bm["stopword_ranks"]
    vocab = bm["vocab_ranks"] - stop
    g = make_generator(device, seed, "words")
    lens = torch.round(bm["doc_words_mean"] + bm["doc_words_sd"] * torch.randn(
        (n,), generator=g, device=device))
    lens = torch.clamp(lens, bm["doc_words_min"], bm["doc_words_max"]).long()
    offsets = torch.zeros((n + 1,), dtype=torch.int64, device=device)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1])
    cdf = zipf_cdf(bm["vocab_ranks"], bm["zipf_exponent"], device)
    words = torch.empty((total,), dtype=torch.int32, device=device)
    for w0 in range(0, total, CHUNK_WORDS):
        m = min(CHUNK_WORDS, total - w0)
        words[w0:w0 + m] = draw_ranks(g, cdf, m)
    doc_of = torch.repeat_interleave(
        torch.arange(n, device=device, dtype=torch.int64), lens)
    content = words >= stop
    keys = (words[content].long() - stop) * n + doc_of[content]
    del doc_of, content
    keys = torch.sort(keys).values
    keys, tf = torch.unique_consecutive(keys, return_counts=True)
    term = keys // n
    post_doc = (keys - term * n).to(torch.int32)
    del keys
    df = torch.bincount(term, minlength=vocab)
    del term
    indptr = torch.zeros((vocab + 1,), dtype=torch.int64, device=device)
    torch.cumsum(df, 0, out=indptr[1:])
    doc_len = torch.zeros((n,), dtype=torch.int64, device=device)
    doc_len.index_add_(0, post_doc.long(), tf)
    return TermCorpus(words=words, offsets=offsets, indptr=indptr,
                      post_doc=post_doc, post_tf=tf.to(torch.int16),
                      doc_len=doc_len.to(torch.int32), vocab=vocab, stop=stop)


def index_impacts(tc: TermCorpus, bm: dict) -> torch.Tensor:
    """[nnz] f32 BM25 impacts of the postings, for the system's index:
    rank_bm25's Okapi numerics in float64 (idf floored at epsilon times
    the mean idf of the terms present), rounded once to float32."""
    df = torch.diff(tc.indptr)
    present = df > 0
    n_live = int((tc.doc_len > 0).sum())
    avgdl = float(tc.doc_len.double().sum()) / n_live
    raw = torch.log(n_live - df.double() + 0.5) - torch.log(df.double() + 0.5)
    mean_idf = float(raw[present].mean())
    idf = torch.where(raw < 0, bm["epsilon"] * mean_idf, raw)
    term = torch.repeat_interleave(
        torch.arange(df.shape[0], device=df.device), df)
    tf = tc.post_tf.double()
    k1, b = bm["k1"], bm["b"]
    dl = tc.doc_len[tc.post_doc.long()].double()
    imp = idf[term] * tf * (k1 + 1.0) / (tf + k1 * (1.0 - b + b * dl / avgdl))
    return imp.to(torch.float32)


@dataclasses.dataclass
class QueryPool:
    """The traffic's query rows (on the device)."""

    dense: torch.Tensor                 # [R, D] f32 unit rows
    terms: Optional[torch.Tensor]       # [R, t_max] int32, -1 padded
    rows_cut: int                       # rows whose terms the budget cut


def query_pool(cfg: dict, rows: int, seed: int, device,
               bf16_rows: Optional[torch.Tensor] = None,
               int8_rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               tc: Optional[TermCorpus] = None, t_max: int = 32,
               budget: Optional[int] = None,
               int8_shards: Optional[Sequence[Int8Shard]] = None
               ) -> QueryPool:
    """``int8_shards``: the corpus laid out by shard; each gold row is
    gathered from the shard that holds it, onto ``device``."""
    n = cfg["n_docs"]
    g = make_generator(device, seed, "queries")
    gold = torch.randint(0, n, (rows,), generator=g, device=device)
    if bf16_rows is not None:
        base = bf16_rows[gold].float()
    elif int8_shards is not None:
        base = _gather_shards(int8_shards, gold, cfg["dim"])
    else:
        values, scales = int8_rows
        base = values[gold].float() * scales[gold][:, None]
    dense = unit(unit(base) + cfg["query_noise"] * torch.randn(
        base.shape, generator=g, device=device))
    terms, cut = None, 0
    if tc is not None:
        terms, cut = _query_terms(cfg["bm25"], tc, gold, g, t_max, budget)
    return QueryPool(dense=dense.contiguous(), terms=terms, rows_cut=cut)


def _gather_shards(shards: Sequence[Int8Shard], gold: torch.Tensor,
                   d: int) -> torch.Tensor:
    """[R, d] f32 dequantized rows ``gold`` (global ids) on gold's device,
    each from the shard that holds it."""
    base = torch.empty((gold.shape[0], d), dtype=torch.float32,
                       device=gold.device)
    for sh in shards:
        at = torch.nonzero((gold >= sh.offset)
                           & (gold < sh.offset + sh.n_real)).flatten()
        if at.numel() == 0:
            continue
        local = (gold[at] - sh.offset).to(sh.device)
        rows = sh.values[local].float() * sh.scales[local][:, None]
        base[at] = rows.to(gold.device)
    return base


def _query_terms(bm: dict, tc: TermCorpus, gold: torch.Tensor,
                 g: torch.Generator, t_max: int, budget: Optional[int]):
    dev = gold.device
    rows = gold.shape[0]
    qlen = torch.poisson(torch.full((rows,), float(bm["query_words_mean"]),
                                    device=dev), generator=g)
    qlen = torch.clamp(qlen, 1, t_max).long()
    pos = torch.arange(t_max, device=dev)
    live = pos[None, :] < qlen[:, None]
    start = tc.offsets[gold]
    span = tc.offsets[gold + 1] - start
    u = torch.rand((rows, t_max), generator=g, device=dev, dtype=torch.float64)
    pick = start[:, None] + torch.clamp(
        (u * span[:, None]).long(), max=(span - 1)[:, None])
    from_doc = tc.words[pick]
    cdf = zipf_cdf(bm["vocab_ranks"], bm["zipf_exponent"], dev)
    fresh = draw_ranks(g, cdf, rows * t_max).reshape(rows, t_max)
    doc_word = torch.rand((rows, t_max), generator=g,
                          device=dev) < bm["query_from_doc"]
    ranks = torch.where(doc_word, from_doc, fresh)
    term = torch.where(live & (ranks >= tc.stop), ranks - tc.stop, -1)
    order = torch.argsort((term < 0).to(torch.int8), dim=1, stable=True)
    term = torch.gather(term, 1, order)
    cut = 0
    if budget is not None:
        df = torch.diff(tc.indptr)
        need = torch.where(term >= 0, df[term.clamp(min=0).long()], 0)
        over = torch.cumsum(need, 1) > budget
        cut = int(over.any(dim=1).sum())
        term = torch.where(over, -1, term)
    return term.to(torch.int32).contiguous(), cut


def postings_of(tc: TermCorpus, terms: torch.Tensor) -> torch.Tensor:
    """[R] postings each query row's terms fetch (repeats counted)."""
    df = torch.diff(tc.indptr)
    return torch.where(terms >= 0, df[terms.clamp(min=0).long()], 0).sum(1)


def bucket(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, n))))
