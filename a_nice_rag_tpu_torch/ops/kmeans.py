"""Spherical k-means for IVF coarse quantization (build time).

Counterpart of ``a_nice_rag_tpu/ops/kmeans.py``. Lloyd iterations stream
the rows in chunks: assignment is ``argmax(X @ C^T)`` (cosine == dot on
unit-norm rows), the update sums each cluster's rows. Rows are upcast one
chunk at a time, so an int8 or bf16 corpus is never upcast whole.

Numerics match the JAX package's: it multiplies float rows in their own
dtype and int8 rows in bf16, with bf16 centroids and f32 accumulation.
Here each chunk is upcast to f32 and the centroids are rounded through
that same dtype, then multiplied in IEEE f32 (no TF32): every product is
exact, so only the order of summation differs. The update sums rows with
``index_add_`` (on CUDA its atomics change the order of summation from
run to run; centroids agree to ~1e-6).

Initialisation draws a random row subset from a ``torch.Generator``
seeded with ``seed``; it cannot reproduce ``jax.random.choice``, so
:func:`spherical_kmeans` also takes the initial centroids (``init``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.topk import stable_top_k


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """Floats multiply in their own dtype; int8 corpora in bf16."""
    return x.dtype if x.is_floating_point() else torch.bfloat16


def _centroids_f32(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """[D, C] f32 centroids rounded through the chunk compute dtype."""
    return cent.to(_compute_dtype(x)).to(torch.float32).T


def _chunk_scores(x: torch.Tensor, s0: int, s1: int,
                  cent_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f32 rows [s1 - s0, D], f32 scores [s1 - s0, C])."""
    xc = x[s0:s1].to(_compute_dtype(x)).to(torch.float32)
    return xc, xc @ cent_t


def _lloyd_iter(x: torch.Tensor, cent: torch.Tensor, n_valid: int,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration. x [Np, D] (rows >= n_valid are padding),
    cent [C, D] f32 unit-norm. Returns (new_cent [C, D], counts [C])."""
    c, d = cent.shape
    cent_t = _centroids_f32(x, cent)
    sums = torch.zeros((c, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((c,), dtype=torch.float32, device=x.device)
    for s0 in range(0, n_valid, chunk):
        s1 = min(n_valid, s0 + chunk)
        xc, scores = _chunk_scores(x, s0, s1, cent_t)
        a = torch.argmax(scores, dim=1)
        sums.index_add_(0, a, xc)
        counts.index_add_(0, a, torch.ones_like(a, dtype=torch.float32))
    # Empty clusters keep their previous centroid.
    norm = torch.sqrt((sums * sums).sum(dim=1, keepdim=True))
    new = torch.where(
        (counts[:, None] > 0) & (norm > 0),
        sums / torch.clamp_min(norm, 1e-12), cent,
    )
    return new, counts


def _assign(x: torch.Tensor, cent: torch.Tensor, chunk: int) -> torch.Tensor:
    """Final hard assignment. Returns [Np] int32 cluster ids."""
    cent_t = _centroids_f32(x, cent)
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    for s0 in range(0, x.shape[0], chunk):
        s1 = min(x.shape[0], s0 + chunk)
        _, scores = _chunk_scores(x, s0, s1, cent_t)
        out[s0:s1] = torch.argmax(scores, dim=1).to(torch.int32)
    return out


def _chunk_for(n: int, chunk: int) -> int:
    return min(chunk, -(-n // 256) * 256)  # small inputs: one chunk


def kmeans_init_rows(n: int, c: int, seed: int) -> torch.Tensor:
    """The row subset :func:`spherical_kmeans` initializes from: ``c``
    distinct rows of ``n``, drawn on the CPU from ``seed`` (so the draw
    does not depend on the device)."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=g)[:c]


def spherical_kmeans(
    x: torch.Tensor,
    n_clusters: int,
    n_iters: int = 10,
    seed: int = 0,
    chunk: int = 8192,
    init: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster unit-norm rows by cosine. Returns (centroids [C, D] f32
    unit-norm, assignments [N] int32), on ``x``'s device.

    ``x`` may be f32, bf16 or int8; rows need not be exactly unit-norm.
    ``init`` ([C, D], unit rows) replaces the random initial subset.
    """
    n, _ = x.shape
    c = int(n_clusters)
    assert c >= 1 and n >= c, (n, c)
    chunk = _chunk_for(n, chunk)
    if init is None:
        rows = kmeans_init_rows(n, c, seed).to(x.device)
        cent = x.index_select(0, rows).to(torch.float32)
        cent = cent / torch.clamp_min(
            torch.sqrt((cent * cent).sum(dim=1, keepdim=True)), 1e-12
        )
    else:
        cent = torch.as_tensor(init, dtype=torch.float32, device=x.device)
    for _ in range(n_iters):
        cent, _ = _lloyd_iter(x, cent, n, chunk)
    return cent, _assign(x, cent, chunk)


def _assign_top(x: torch.Tensor, cent: torch.Tensor, top: int,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``top`` cluster assignment with scores. Returns (ids [Np, top]
    int32 by descending score, lower id first among equal scores; scores
    [Np, top] f32)."""
    cent_t = _centroids_f32(x, cent)
    ids = torch.empty((x.shape[0], top), dtype=torch.int32, device=x.device)
    scs = torch.empty((x.shape[0], top), dtype=torch.float32,
                      device=x.device)
    for s0 in range(0, x.shape[0], chunk):
        s1 = min(x.shape[0], s0 + chunk)
        _, scores = _chunk_scores(x, s0, s1, cent_t)
        v, a = stable_top_k(scores, top)
        ids[s0:s1] = a.to(torch.int32)
        scs[s0:s1] = v
    return ids, scs


def assign_clusters(
    x: torch.Tensor, cent: torch.Tensor, top: int = 1, chunk: int = 8192
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``top`` hard assignments of rows to the given centroids, chunk
    by chunk. Used by the spilled IVF layout (secondary assignments).
    Returns (cluster ids [N, top], scores [N, top])."""
    chunk = _chunk_for(x.shape[0], chunk)
    return _assign_top(x, cent, min(top, cent.shape[0]), chunk)
