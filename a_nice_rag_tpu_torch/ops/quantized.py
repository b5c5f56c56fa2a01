"""Int8-quantized dense scoring.

One scale per row: e_q = round(e / s), s = max|e| / 127, and

    score(q, d) = (q_int . e_int[d]) * s_q * s_d

The int8 values are bit-exact with the JAX package: the division is by
``safe`` (never a multiply by its reciprocal) and rounding is half to
even, as both ``jnp.round`` and ``torch.round`` do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from a_nice_rag_tpu_torch.ops.topk import masked_top_k

# float32 sums of int8 x int8 products are exact while every partial sum
# stays below 2**24: D * 127**2 < 2**24 holds for D <= 1040.
_EXACT_F32_DEPTH = 1024


@dataclasses.dataclass
class QuantizedDense:
    values: torch.Tensor  # [N_pad, D] int8
    scales: torch.Tensor  # [N_pad] f32, per-row


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.to(torch.float32)
    scales = x.abs().amax(dim=1) / 127.0
    safe = torch.clamp_min(scales, 1e-12)
    values = torch.clamp(torch.round(x / safe[:, None]), -127, 127)
    return values.to(torch.int8), scales


def quantize_embeddings(emb: torch.Tensor) -> QuantizedDense:
    values, scales = _quantize_rows(emb)
    return QuantizedDense(values=values, scales=scales)


def quantize_queries(
    queries: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return _quantize_rows(queries)


def int8_dot(q_values: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Exact int32 [B, N] = q_values [B, D] . values [N, D]^T.

    CUDA has no integer matmul in torch, so the product runs as float32
    matmuls over depth chunks short enough to stay exact, summed in
    int32.
    """
    d = q_values.shape[1]
    acc = None
    for d0 in range(0, d, _EXACT_F32_DEPTH):
        part = (
            q_values[:, d0:d0 + _EXACT_F32_DEPTH].to(torch.float32)
            @ values[:, d0:d0 + _EXACT_F32_DEPTH].to(torch.float32).T
        ).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def quantized_dense_scores(
    qd: QuantizedDense, q_values: torch.Tensor, q_scales: torch.Tensor
) -> torch.Tensor:
    """[B, N] f32 scores from int8 operands: (acc * s_q) * s_d."""
    acc = int8_dot(q_values, qd.values)
    return acc.to(torch.float32) * q_scales[:, None] * qd.scales[None, :]


def quantized_dense_top_k(
    qd: QuantizedDense,
    queries: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 scoring + masked top-k; queries quantized on the fly."""
    q_values, q_scales = quantize_queries(queries)
    scores = quantized_dense_scores(qd, q_values, q_scales)
    return masked_top_k(scores, k, None if mask is None else mask[None, :])
