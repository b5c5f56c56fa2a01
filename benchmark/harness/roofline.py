"""Peaks of one NVIDIA H100 SXM and the work of each kernel, counted once.

Published dense peaks (NVIDIA's H100 SXM data sheet, no sparsity, at the
700 W limit): 3.35 TB/s of HBM, 989 TFLOP/s bf16, 1,979 TOP/s int8. A
kernel's bound is the larger of its bytes over the HBM rate and its
operations over the highest peak that can compute them; its roofline
share is that bound over its measured time. The work is counted from the
call's shapes, whatever implements it: every row read once, the queries
read once, the k (value, id) pairs of every query written once, and
2 * B * N * D operations.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "int8": 1979e12}


def bound_s(bytes_: float, ops: float, peak_ops_s: float) -> float:
    return max(bytes_ / HBM_BYTES_S, ops / peak_ops_s)


def k1_bound_s(b: int, n: int, d: int, k: int) -> float:
    """K1 over bf16 rows [n, d] for f32 queries [b, d]."""
    bytes_ = n * d * 2 + b * d * 4 + b * k * 8
    return bound_s(bytes_, 2.0 * b * n * d, PEAK_OPS_S["bfloat16"])


def k2_bound_s(b: int, n: int, d: int, k: int) -> float:
    """K2 over int8 rows [n, d] with per-row f32 scales, for int8 queries
    [b, d] with per-query f32 scales."""
    bytes_ = n * d + n * 4 + b * d + b * 4 + b * k * 8
    return bound_s(bytes_, 2.0 * b * n * d, PEAK_OPS_S["int8"])
