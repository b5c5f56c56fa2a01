"""Index artifact persistence: the same ``arrays.npz`` + ``meta.json``
directory that ``a_nice_rag_tpu.index.io`` writes and reads, so either
package loads the other's artifact.

bf16 matrices saved by the JAX package come back from npz as a raw
2-byte (``V2``) dtype; they are reinterpreted as bfloat16 bit patterns.
bf16 matrices saved here are written as float32 (exact), which both
packages read.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device
from a_nice_rag_tpu_torch.index.array_index import (
    ArrayIndex,
    CorpusMeta,
    dense_impact_from_csr,
    torch_dtype,
)
from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays
from a_nice_rag_tpu_torch.ops.quantized import QuantizedDense

_FORMAT_VERSION = 1


def numpy_to_torch(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``; 2-byte void or ml_dtypes
    bfloat16 arrays are read as bfloat16 bit patterns."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            or arr.dtype.name == "bfloat16":
        arr = np.ascontiguousarray(arr).view(np.int16)
        bf16 = True
    else:
        bf16 = False
    # Copy read-only buffers (e.g. another framework's arrays) so the
    # tensor never aliases memory it must not write.
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)  # npz has no bfloat16; f32 is exact
    return t.cpu().numpy()


def _ivf_path(path: str, model: str) -> str:
    return os.path.join(path, f"ivf_{model.replace('/', '_')}.npz")


def save_index(index: ArrayIndex, path: str) -> None:
    from a_nice_rag_tpu_torch.index.ivf import save_ivf  # imports this module

    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for model, emb in index.dense.items():
        arrays[f"dense/{model}"] = _host(emb)
    for model, qd in (index.dense_q or {}).items():
        arrays[f"dense_q/{model}/values"] = _host(qd.values)
        arrays[f"dense_q/{model}/scales"] = _host(qd.scales)
    if index.bm25 is not None:
        arrays["bm25/indptr"] = _host(index.bm25.indptr)
        arrays["bm25/doc_ids"] = _host(index.bm25.doc_ids)
        arrays["bm25/impact"] = _host(index.bm25.impact)
        arrays["bm25/doc_mask"] = np.asarray(index.bm25_doc_mask)
    np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)
    for model, ivf in (index.ivf or {}).items():
        save_ivf(ivf, _ivf_path(path, model))
    meta = {
        "format_version": _FORMAT_VERSION,
        "n_docs": index.meta.n_docs,
        "n_docs_padded": index.meta.n_docs_padded,
        "ids": index.meta.ids,
        "sources": index.meta.sources,
        "urls": index.meta.urls,
        "contents": index.meta.contents,
        "dense_models": list(index.dense.keys()),
        "dense_q_models": list((index.dense_q or {}).keys()),
        "vocab": index.vocab,
        "bm25_stats": index.bm25_stats,
        "deleted_rows": np.flatnonzero(index.meta.deleted).tolist(),
        "ivf_models": list((index.ivf or {}).keys()),
    }
    with open(os.path.join(path, "meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f)


def load_index(
    path: str, emb_dtype: str = "float32", device: DeviceLike = "cpu"
) -> ArrayIndex:
    """Load an index artifact, IVF structures included, onto ``device``."""
    from a_nice_rag_tpu_torch.index.ivf import load_ivf  # imports this module

    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json"), "r", encoding="utf-8") as f:
        meta_d = json.load(f)
    found = meta_d.get("format_version")
    if found != _FORMAT_VERSION:
        raise ValueError(
            f"index artifact at {path} has format_version {found!r}; "
            f"this build reads version {_FORMAT_VERSION}. Rebuild the "
            "artifact with build_index + save_index."
        )
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {name: data[name] for name in data.files}
    meta = CorpusMeta(
        ids=meta_d["ids"],
        sources=meta_d["sources"],
        contents=meta_d["contents"],
        urls=meta_d["urls"],
        n_docs=meta_d["n_docs"],
        n_docs_padded=meta_d["n_docs_padded"],
    )
    for row in meta_d.get("deleted_rows", []):
        meta.deleted[row] = True
    dense = {
        m: numpy_to_torch(arrays[f"dense/{m}"], dev).to(torch_dtype(emb_dtype))
        for m in meta_d["dense_models"]
    }
    dense_q = {
        m: QuantizedDense(
            values=numpy_to_torch(arrays[f"dense_q/{m}/values"], dev),
            scales=numpy_to_torch(arrays[f"dense_q/{m}/scales"], dev),
        )
        for m in meta_d.get("dense_q_models", [])
    } or None
    bm25 = None
    bm25_doc_mask = None
    bm25_dense = None
    if "bm25/indptr" in arrays:
        bm25 = Bm25Arrays(
            indptr=numpy_to_torch(arrays["bm25/indptr"], dev),
            doc_ids=numpy_to_torch(arrays["bm25/doc_ids"], dev),
            impact=numpy_to_torch(arrays["bm25/impact"], dev),
            n_docs_padded=meta_d["n_docs_padded"],
        )
        bm25_doc_mask = arrays["bm25/doc_mask"]
        # The dense impact matrix is derived, not stored: rebuild it when
        # it fits the default memory budget (as build_index does).
        if bm25.vocab_size * meta_d["n_docs_padded"] * 4 <= (4 << 30):
            bm25_dense = dense_impact_from_csr(bm25)
    ivf = {
        m: load_ivf(_ivf_path(path, m), dev)
        for m in meta_d.get("ivf_models", [])
    } or None
    return ArrayIndex(
        meta=meta,
        dense=dense,
        bm25=bm25,
        vocab=meta_d["vocab"],
        bm25_stats=meta_d["bm25_stats"],
        bm25_doc_mask=bm25_doc_mask,
        bm25_dense=bm25_dense,
        dense_q=dense_q,
        ivf=ivf,
    )
