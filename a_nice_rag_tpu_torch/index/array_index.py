"""Array index structures and builder.

Counterpart of ``a_nice_rag_tpu/index/array_index.py``: a columnar index
built on the host with NumPy (the same arithmetic as the JAX package)
and uploaded once to an explicit torch device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device
from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays, Bm25DenseArrays
from a_nice_rag_tpu_torch.ops.quantized import (
    QuantizedDense,
    quantize_embeddings,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; use {sorted(_DTYPES)}")
    return _DTYPES[name]


def _pad_to(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple) if n else multiple


@dataclasses.dataclass
class CorpusMeta:
    """Host-side document metadata (never shipped to the device)."""

    ids: List[str]
    sources: List[str]
    contents: List[str]
    urls: List[str]
    n_docs: int
    n_docs_padded: int

    def __post_init__(self) -> None:
        self.id_to_row: Dict[str, int] = {d: i for i, d in enumerate(self.ids)}
        self._sources_upper = np.array([s.upper() for s in self.sources])
        # Tombstones: deleted documents stay in the arrays but are
        # excluded from every candidate mask.
        self.deleted = np.zeros(self.n_docs, dtype=bool)

    def filter_mask(self, filename_type_filter: Optional[str]) -> np.ndarray:
        """Boolean [N_pad] mask of documents whose source starts with any
        of the comma-separated prefixes; None/empty -> all valid docs.
        Tombstoned documents are always excluded."""
        mask = np.zeros(self.n_docs_padded, dtype=bool)
        if not filename_type_filter:
            mask[: self.n_docs] = ~self.deleted
            return mask
        prefixes = tuple(
            p.strip().upper() for p in filename_type_filter.split(",")
        )
        m = np.zeros(self.n_docs, dtype=bool)
        for p in prefixes:
            m |= np.char.startswith(self._sources_upper, p)
        mask[: self.n_docs] = m & ~self.deleted
        return mask

    def doc(self, row: int) -> Dict[str, str]:
        return {
            "id": self.ids[row],
            "source": self.sources[row],
            "document": self.contents[row],
            "url": self.urls[row] if row < len(self.urls) else "Unknown",
        }


def build_bm25_arrays(
    token_lists: Sequence[Sequence[str]],
    n_docs_padded: int,
    k1: float = 1.7,
    b: float = 0.83,
    epsilon: float = 0.05,
    device: DeviceLike = "cuda",
) -> Tuple[Bm25Arrays, Dict[str, int], Dict[str, float]]:
    """Build eager-impact CSR postings from per-document token lists.

    rank_bm25 Okapi numerics: idf = ln((N-df+0.5)/(df+0.5)), negative
    idfs floored to epsilon*mean(idf); impact is the full per-(term, doc)
    contribution. Documents with zero tokens are left out of the corpus
    statistics. Returns (arrays, vocab, stats).
    """
    dev = resolve_device(device)
    n_docs = len(token_lists)
    nonempty = [i for i, t in enumerate(token_lists) if len(t) > 0]
    corpus_size = len(nonempty)
    if corpus_size == 0:
        raise ValueError("BM25 build requires at least one non-empty document")
    doc_len = np.zeros(n_docs, dtype=np.float64)
    for i in nonempty:
        doc_len[i] = len(token_lists[i])
    avgdl = float(doc_len.sum()) / corpus_size

    tf_maps: Dict[str, Dict[int, int]] = {}
    for i in nonempty:
        seen: Dict[str, int] = {}
        for tok in token_lists[i]:
            seen[tok] = seen.get(tok, 0) + 1
        for tok, c in seen.items():
            tf_maps.setdefault(tok, {})[i] = c

    vocab_terms = sorted(tf_maps)
    vocab = {t: i for i, t in enumerate(vocab_terms)}

    raw_idf = np.array(
        [
            math.log(corpus_size - len(tf_maps[t]) + 0.5)
            - math.log(len(tf_maps[t]) + 0.5)
            for t in vocab_terms
        ],
        dtype=np.float64,
    )
    average_idf = float(raw_idf.mean())
    idf = np.where(raw_idf < 0, epsilon * average_idf, raw_idf)

    denom_base = k1 * (1.0 - b + b * doc_len / avgdl)

    indptr = np.zeros(len(vocab_terms) + 1, dtype=np.int32)
    doc_ids_parts: List[np.ndarray] = []
    impact_parts: List[np.ndarray] = []
    for ti, term in enumerate(vocab_terms):
        postings = tf_maps[term]
        docs = np.fromiter(postings.keys(), dtype=np.int32, count=len(postings))
        order = np.argsort(docs, kind="stable")
        docs = docs[order]
        tf = np.fromiter(postings.values(), dtype=np.float64,
                         count=len(postings))[order]
        imp = idf[ti] * tf * (k1 + 1.0) / (tf + denom_base[docs])
        doc_ids_parts.append(docs)
        impact_parts.append(imp)
        indptr[ti + 1] = indptr[ti] + len(docs)

    nnz = int(indptr[-1])
    doc_ids = np.empty(nnz + 1, dtype=np.int32)
    impact = np.empty(nnz + 1, dtype=np.float32)
    doc_ids[:nnz] = np.concatenate(doc_ids_parts) if nnz else []
    impact[:nnz] = (
        np.concatenate(impact_parts).astype(np.float32) if nnz else []
    )
    doc_ids[nnz] = n_docs_padded  # sentinel dump row
    impact[nnz] = 0.0

    arrays = Bm25Arrays(
        indptr=torch.as_tensor(indptr, device=dev),
        doc_ids=torch.as_tensor(doc_ids, device=dev),
        impact=torch.as_tensor(impact, device=dev),
        n_docs_padded=n_docs_padded,
    )
    stats = {
        "k1": k1,
        "b": b,
        "epsilon": epsilon,
        "avgdl": avgdl,
        "corpus_size": corpus_size,
        "average_idf": average_idf,
        "max_df": int((indptr[1:] - indptr[:-1]).max()) if nnz else 0,
        "nnz": nnz,
    }
    return arrays, vocab, stats


def dense_impact_from_csr(
    bm25: Bm25Arrays, dtype: str = "float32"
) -> Bm25DenseArrays:
    """The [V, N_pad] impact matrix from CSR postings, built with one
    scatter on the postings' device."""
    dev = bm25.indptr.device
    v = bm25.vocab_size
    nnz = bm25.nnz
    mat = torch.zeros((v, bm25.n_docs_padded), dtype=torch.float32,
                      device=dev)
    rows = torch.repeat_interleave(
        torch.arange(v, device=dev), torch.diff(bm25.indptr).long()
    )
    mat[rows, bm25.doc_ids[:nnz].long()] = bm25.impact[:nnz]
    return Bm25DenseArrays(impact=mat.to(torch_dtype(dtype)))


@dataclasses.dataclass
class ArrayIndex:
    """The complete device-resident hybrid index for one source."""

    meta: CorpusMeta
    dense: Dict[str, torch.Tensor]  # model -> [N_pad, D]
    bm25: Optional[Bm25Arrays]
    vocab: Optional[Dict[str, int]]
    bm25_stats: Optional[Dict[str, float]]
    bm25_doc_mask: Optional[np.ndarray] = None  # docs with >=1 token
    bm25_dense: Optional[Bm25DenseArrays] = None
    # int8-quantized matrices; a model lives in EITHER ``dense`` or
    # ``dense_q``, never both.
    dense_q: Optional[Dict[str, QuantizedDense]] = None
    # IVF ANN structures per model (index/ivf.py ``IVFDense``), attached
    # with ``attach_ivf``: FusedRetriever(nprobe=p) probes p clusters
    # instead of scanning the corpus. The IVF copy is permuted
    # cluster-major beside the original matrix.
    ivf: Optional[Dict[str, "IVFDense"]] = None  # noqa: F821

    def __post_init__(self) -> None:
        self._filter_cache: Dict[object, object] = {}
        # Bumped by tombstone mutations so retriever-side mask caches
        # refresh.
        self._version = 0

    @property
    def device(self) -> torch.device:
        """The device every array of the index lives on."""
        for t in self.dense.values():
            return t.device
        for qd in (self.dense_q or {}).values():
            return qd.values.device
        if self.bm25 is not None:
            return self.bm25.indptr.device
        raise ValueError("index holds no arrays")

    @property
    def dense_model_names(self) -> Tuple[str, ...]:
        return tuple(self.dense) + tuple(self.dense_q or {})

    def dense_matrix(self, model: str):
        """A [N_pad, D] tensor or a QuantizedDense — callers branch on
        the type."""
        if model in self.dense:
            return self.dense[model]
        if self.dense_q and model in self.dense_q:
            return self.dense_q[model]
        raise KeyError(f"no dense matrix for model {model!r}")

    @property
    def n_docs(self) -> int:
        return self.meta.n_docs

    @property
    def n_docs_padded(self) -> int:
        return self.meta.n_docs_padded

    def filter_mask(self, filename_type_filter: Optional[str]) -> torch.Tensor:
        """Device mask for a filter string, cached per filter."""
        key = filename_type_filter or None
        if key not in self._filter_cache:
            self._filter_cache[key] = torch.as_tensor(
                self.meta.filter_mask(filename_type_filter),
                device=self.device,
            )
        return self._filter_cache[key]

    def filter_mask_or_none(
        self, filename_type_filter: Optional[str]
    ) -> Optional[torch.Tensor]:
        """Like :meth:`filter_mask`, but ``None`` when the mask would be
        all-true (no filter, no tombstones, no doc-axis padding): the
        kernels then run without a mask operand."""
        if filename_type_filter:
            return self.filter_mask(filename_type_filter)
        key = ("trivial", self._version)
        if key not in self._filter_cache:
            for stale in [
                k for k in self._filter_cache
                if isinstance(k, tuple) and k[0] == "trivial" and k != key
            ]:
                del self._filter_cache[stale]
            self._filter_cache[key] = bool(
                self.n_docs == self.n_docs_padded
                and not self.meta.deleted.any()
            )
        if self._filter_cache[key]:
            return None
        return self.filter_mask(filename_type_filter)

    def bm25_doc_mask_or_none(self) -> Optional[np.ndarray]:
        """``None`` when every padded doc row has a BM25 token, else the
        stored mask. Cached: the all() scan is O(N)."""
        if self.bm25_doc_mask is None:
            return None
        if not hasattr(self, "_bm25_mask_trivial"):
            self._bm25_mask_trivial = bool(self.bm25_doc_mask.all())
        return None if self._bm25_mask_trivial else self.bm25_doc_mask

    def term_ids(self, tokens: Sequence[str]) -> np.ndarray:
        """Map tokens to vocab ids (-1 for OOV)."""
        if self.vocab is None:
            raise ValueError("index has no BM25 component")
        return np.array([self.vocab.get(t, -1) for t in tokens], dtype=np.int32)

    def pad_term_ids(
        self, token_lists: Sequence[Sequence[str]], t_max: int
    ) -> np.ndarray:
        """[B, t_max] padded term-id batch (-1 padding/OOV)."""
        out = np.full((len(token_lists), t_max), -1, dtype=np.int32)
        for i, toks in enumerate(token_lists):
            ids = self.term_ids(toks)[:t_max]
            out[i, : len(ids)] = ids
        return out


def build_index(
    ids: Sequence[str],
    sources: Sequence[str],
    contents: Sequence[str],
    embeddings: Dict[str, np.ndarray],
    urls: Optional[Sequence[str]] = None,
    token_lists: Optional[Sequence[Sequence[str]]] = None,
    k1: float = 1.7,
    b: float = 0.83,
    epsilon: float = 0.05,
    pad_multiple: int = 128,
    emb_dtype: str = "float32",
    normalize: bool = False,
    bm25_dense_max_bytes: int = 4 << 30,
    bm25_dense_dtype: str = "float32",
    streaming_align: int = 8192,
    streaming_threshold: int = 1 << 19,
    quantize_dense=False,
    device: DeviceLike = "cuda",
) -> ArrayIndex:
    """Build the hybrid array index on ``device``.

    ``embeddings``: model name -> [N, D] float array (unit-norm; set
    ``normalize=True`` to force it). ``token_lists``: preprocessed tokens
    per document for BM25; omit for a dense-only index.
    ``quantize_dense``: True (all models) or a sequence of model names
    stored int8 with per-row scales. Corpora at or above
    ``streaming_threshold`` docs pad the doc axis to ``streaming_align``,
    as the JAX package does, so both packages index the same padded rows.
    """
    dev = resolve_device(device)
    n = len(ids)
    if n >= streaming_threshold:
        pad_multiple = max(pad_multiple, streaming_align)
    n_pad = _pad_to(n, pad_multiple)
    meta = CorpusMeta(
        ids=list(ids),
        sources=list(sources),
        contents=list(contents),
        urls=list(urls) if urls is not None else ["Unknown"] * n,
        n_docs=n,
        n_docs_padded=n_pad,
    )

    if quantize_dense is True:
        q_models = set(embeddings)
    elif quantize_dense:
        q_models = set(quantize_dense)
        unknown = q_models - set(embeddings)
        if unknown:
            raise ValueError(f"quantize_dense names unknown models: "
                             f"{sorted(unknown)}")
    else:
        q_models = set()

    dense: Dict[str, torch.Tensor] = {}
    dense_q: Dict[str, QuantizedDense] = {}
    for model, emb in embeddings.items():
        emb = np.asarray(emb, dtype=np.float32)
        if emb.shape[0] != n:
            raise ValueError(f"{model}: {emb.shape[0]} rows != {n} ids")
        if normalize:
            norms = np.linalg.norm(emb, axis=1, keepdims=True)
            emb = emb / np.maximum(norms, 1e-12)
        padded = np.zeros((n_pad, emb.shape[1]), dtype=np.float32)
        padded[:n] = emb
        t = torch.as_tensor(padded, device=dev)
        if model in q_models:
            dense_q[model] = quantize_embeddings(t)
        else:
            dense[model] = t.to(torch_dtype(emb_dtype))

    bm25 = vocab = stats = None
    bm25_doc_mask = None
    bm25_dense = None
    if token_lists is not None:
        if len(token_lists) != n:
            raise ValueError(f"{len(token_lists)} token lists != {n} ids")
        bm25, vocab, stats = build_bm25_arrays(
            token_lists, n_pad, k1=k1, b=b, epsilon=epsilon, device=dev
        )
        bm25_doc_mask = np.zeros(n_pad, dtype=bool)
        bm25_doc_mask[:n] = [len(t) > 0 for t in token_lists]
        itemsize = torch_dtype(bm25_dense_dtype).itemsize
        if len(vocab) * n_pad * itemsize <= bm25_dense_max_bytes:
            bm25_dense = dense_impact_from_csr(bm25, bm25_dense_dtype)

    return ArrayIndex(
        meta=meta,
        dense=dense,
        bm25=bm25,
        vocab=vocab,
        bm25_stats=stats,
        bm25_doc_mask=bm25_doc_mask,
        bm25_dense=bm25_dense,
        dense_q=dense_q or None,
    )
