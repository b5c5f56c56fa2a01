"""Carry an index built by the JAX package over to this one.

``from_reference_index`` reads every field of an ``a_nice_rag_tpu``
``ArrayIndex`` (IVF structures included, via ``from_reference_ivf``)
with ``np.asarray`` and uploads it to a torch device. It touches the
reference objects only through their attributes, so this module imports
no jax: the caller's process already holds the JAX arrays.
"""

from __future__ import annotations

import numpy as np

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device
from a_nice_rag_tpu_torch.index.array_index import ArrayIndex, CorpusMeta
from a_nice_rag_tpu_torch.index.io import numpy_to_torch
from a_nice_rag_tpu_torch.index.ivf import IVFDense
from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays, Bm25DenseArrays
from a_nice_rag_tpu_torch.ops.quantized import QuantizedDense


def _uploader(device: DeviceLike):
    dev = resolve_device(device)

    def t(x):
        return None if x is None else numpy_to_torch(np.asarray(x), dev)

    return t


def from_reference_ivf(ref_ivf, device: DeviceLike = "cpu") -> IVFDense:
    """The port's IVFDense holding the same arrays and layout as
    ``ref_ivf`` (a JAX-package IVFDense), on ``device``."""
    t = _uploader(device)
    return IVFDense(
        centroids=t(ref_ivf.centroids), perm=t(ref_ivf.perm),
        cluster_start=t(ref_ivf.cluster_start), tile_n=int(ref_ivf.tile_n),
        n_real=int(ref_ivf.n_real),
        max_cluster_tiles=int(ref_ivf.max_cluster_tiles),
        emb=t(ref_ivf.emb), values=t(ref_ivf.values),
        scales=t(ref_ivf.scales), spilled=bool(ref_ivf.spilled),
    )


def from_reference_index(ref_index, device: DeviceLike = "cpu") -> ArrayIndex:
    """The port's ArrayIndex holding the same arrays as ``ref_index`` (a
    JAX-package ArrayIndex), IVF structures included, on ``device``."""
    t = _uploader(device)
    rm = ref_index.meta
    meta = CorpusMeta(
        ids=list(rm.ids), sources=list(rm.sources),
        contents=list(rm.contents), urls=list(rm.urls),
        n_docs=rm.n_docs, n_docs_padded=rm.n_docs_padded,
    )
    meta.deleted[:] = np.asarray(rm.deleted)
    bm25 = None
    if ref_index.bm25 is not None:
        rb = ref_index.bm25
        bm25 = Bm25Arrays(
            indptr=t(rb.indptr), doc_ids=t(rb.doc_ids), impact=t(rb.impact),
            n_docs_padded=rb.n_docs_padded,
        )
    bm25_dense = None
    if ref_index.bm25_dense is not None:
        bm25_dense = Bm25DenseArrays(impact=t(ref_index.bm25_dense.impact))
    dense_q = {
        m: QuantizedDense(values=t(qd.values), scales=t(qd.scales))
        for m, qd in (ref_index.dense_q or {}).items()
    } or None
    index = ArrayIndex(
        meta=meta,
        dense={m: t(e) for m, e in ref_index.dense.items()},
        bm25=bm25,
        vocab=None if ref_index.vocab is None else dict(ref_index.vocab),
        bm25_stats=(None if ref_index.bm25_stats is None
                    else dict(ref_index.bm25_stats)),
        bm25_doc_mask=(None if ref_index.bm25_doc_mask is None
                       else np.asarray(ref_index.bm25_doc_mask).copy()),
        bm25_dense=bm25_dense,
        dense_q=dense_q,
        ivf={m: from_reference_ivf(iv, device)
             for m, iv in (ref_index.ivf or {}).items()} or None,
    )
    index._version = getattr(ref_index, "_version", 0)
    return index
