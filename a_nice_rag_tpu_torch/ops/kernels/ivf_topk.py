"""IVF-probed dense scoring + top-k: CUDA kernels and plain versions.

``ivf_dense_top_k`` (K3, f32/bf16 rows) and ``ivf_dense_top_k_int8``
(K4, int8 rows with per-row scales) replace the TPU kernels of the same
names in the JAX package (``a_nice_rag_tpu.ops``, ivf_topk.py:143 and
:174). On CUDA tensors each wrapper launches its kernel from
``csrc/ivf_topk.cu`` or raises; it takes its plain PyTorch version only
for tensors on the CPU. ``.launches`` on each wrapper counts kernel
launches.

Contract: the rows are a cluster-major permuted matrix [Np, D] with Np a
multiple of ``tile_n``; ``tile_table`` [max_tiles] int32 names the tiles
to score, real entries first and then -1. Rows at or past ``n_real`` are
never candidates. ``n_real == 0`` selects the dynamic form: the table
then carries one more slot, holding the real-row count, which is read on
the device. Returns values [B, k] f32 descending and PERMUTED row ids
[B, k] int32 under the tie rule (score desc, row asc), (-inf, -1) in
unfilled slots. k <= 256.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import _build
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    _BLOCK_Q,
    _CTAS_PER_SM,
    _PLAIN_CHUNK_ELEMS,
    _I,
    _P,
    _check,
    _launch,
    _outputs,
)
from a_nice_rag_tpu_torch.ops.quantized import int8_dot

K_MAX = 256
_BIG_ID = 2**31 - 1


def _library():
    lib = _build.load("ivf_topk")
    if not hasattr(lib, "_anr_bound"):
        common = [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
        lib.anr_ivf_topk_f32.argtypes = [_P, _P] + common
        lib.anr_ivf_topk_bf16.argtypes = [_P, _P] + common
        lib.anr_ivf_topk_int8.argtypes = [_P, _P, _P, _P] + common
        for fn in (lib.anr_ivf_topk_f32, lib.anr_ivf_topk_bf16,
                   lib.anr_ivf_topk_int8):
            fn.restype = _I
        lib._anr_bound = True
    return lib


def _splits(max_tiles: int, b: int, device: torch.device) -> int:
    """Slot splits: enough that the grid puts more than two CTAs on each
    SM, at most one per table slot."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_blocks = -(-b // _BLOCK_Q)
    return min(max(1, -(-_CTAS_PER_SM * sms // q_blocks)), max_tiles)


def _check_call(rows: torch.Tensor, queries: torch.Tensor, tile_table,
                k: int, tile_n: int, n_real: int) -> int:
    """Validate the shapes and layout arguments; returns max_tiles."""
    if not isinstance(k, int) or not 1 <= k <= K_MAX:
        raise ValueError(f"k must be an int in [1, {K_MAX}], got {k!r}")
    if rows.ndim != 2 or queries.ndim != 2 or queries.shape[0] < 1 \
            or queries.shape[1] != rows.shape[1]:
        raise ValueError(
            f"need rows [Np, D] and queries [B >= 1, D], got "
            f"{tuple(rows.shape)} and {tuple(queries.shape)}")
    npad = rows.shape[0]
    if not isinstance(tile_n, int) or tile_n < 1 or npad % tile_n:
        raise ValueError(f"Np={npad} must be a multiple of tile_n={tile_n}")
    if not isinstance(n_real, int) or not 0 <= n_real <= npad:
        raise ValueError(f"n_real must be an int in [0, {npad}], got {n_real!r}")
    max_tiles = tile_table.shape[0] - (1 if n_real == 0 else 0)
    if tile_table.ndim != 1 or max_tiles < 1:
        raise ValueError(f"tile_table must be 1-D with at least "
                         f"{2 if n_real == 0 else 1} slots")
    _check(tile_table, "tile_table", (torch.int32,), tuple(tile_table.shape),
           rows.device)
    return max_tiles


def _plain_ivf_top_k(
    score_rows: Callable[[torch.Tensor], torch.Tensor],
    tile_table: torch.Tensor, b: int, d: int, k: int, tile_n: int,
    n_real: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over the rows of the tabled tiles, slot chunk by slot
    chunk, selected by (score desc, row asc) whatever the table's order.
    -1 slots read tile 0 and are masked out; nothing syncs to the host."""
    dev = tile_table.device
    max_tiles = tile_table.shape[0] - (1 if n_real == 0 else 0)
    tiles = tile_table[:max_tiles].long()
    limit = tile_table[max_tiles].long() if n_real == 0 else n_real
    run_v = torch.full((b, k), float("-inf"), device=dev)
    run_i = torch.full((b, k), _BIG_ID, dtype=torch.int64, device=dev)
    per = max(1, _PLAIN_CHUNK_ELEMS // (tile_n * max(b, d, 1)))
    offs = torch.arange(tile_n, device=dev)
    for s0 in range(0, max_tiles, per):
        t = tiles[s0:s0 + per]
        rows = (t.clamp(min=0)[:, None] * tile_n + offs).reshape(-1)
        live = (t >= 0).repeat_interleave(tile_n) & (rows < limit)
        s = torch.where(live[None, :], score_rows(rows), float("-inf"))
        ids = torch.where(live, rows, _BIG_ID).expand(b, -1)
        cat_v = torch.cat([run_v, s], dim=1)
        cat_i = torch.cat([run_i, ids], dim=1)
        # (score desc, row asc): rows ascending first, then a stable sort
        # on the scores.
        cat_i, by_id = torch.sort(cat_i, dim=1, stable=True)
        cat_v = torch.take_along_dim(cat_v, by_id, dim=1)
        v, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
        run_v = v[:, :k]
        run_i = torch.take_along_dim(cat_i, pos[:, :k], dim=1)
    run_i = torch.where(torch.isneginf(run_v), -1, run_i)
    return run_v, run_i.to(torch.int32)


def ivf_dense_top_k_torch(
    emb: torch.Tensor, queries: torch.Tensor, tile_table: torch.Tensor,
    k: int, tile_n: int, n_real: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: f32 scores (both operands upcast) of
    the tabled tiles' real rows, stable selection."""
    q = queries.to(torch.float32)

    def scores(rows: torch.Tensor) -> torch.Tensor:
        return q @ emb.index_select(0, rows).to(torch.float32).T

    return _plain_ivf_top_k(scores, tile_table, q.shape[0], emb.shape[1], k,
                            tile_n, n_real)


def ivf_dense_top_k(
    emb: torch.Tensor, queries: torch.Tensor, tile_table: torch.Tensor,
    k: int, tile_n: int, n_real: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: f32 scoring + top-k over the tiles of ``tile_table``. emb [Np,
    D] f32 or bf16, cluster-major; queries [B, D] f32 (bf16 is upcast)."""
    max_tiles = _check_call(emb, queries, tile_table, k, tile_n, n_real)
    b = queries.shape[0]
    dev = emb.device
    _check(emb, "emb", (torch.float32, torch.bfloat16), tuple(emb.shape), dev)
    # The queries are copied to a contiguous f32 block before the launch.
    _check(queries, "queries", (torch.float32, torch.bfloat16),
           (b, emb.shape[1]), dev, contiguous=False)
    if dev.type == "cpu":
        return ivf_dense_top_k_torch(emb, queries, tile_table, k, tile_n,
                                     n_real)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    q = queries.to(torch.float32).contiguous()
    splits = _splits(max_tiles, b, dev)
    part_v, part_i, out_v, out_i = _outputs(b, k, splits, dev)
    fn = (lib.anr_ivf_topk_f32 if emb.dtype == torch.float32
          else lib.anr_ivf_topk_bf16)
    with torch.cuda.device(dev):
        _launch(fn, q.data_ptr(), emb.data_ptr(), tile_table.data_ptr(),
                max_tiles, n_real, b, emb.shape[1], k, tile_n, splits,
                part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
                out_i.data_ptr(), device=dev)
    ivf_dense_top_k.launches += 1
    return out_v, out_i


ivf_dense_top_k.launches = 0


def ivf_dense_top_k_int8_torch(
    values: torch.Tensor, scales: torch.Tensor, q_values: torch.Tensor,
    q_scales: torch.Tensor, tile_table: torch.Tensor, k: int, tile_n: int,
    n_real: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: exact int32 dot, selection on
    float(acc) * row_scale, then * q_scale on the k outputs only."""

    def scores(rows: torch.Tensor) -> torch.Tensor:
        acc = int8_dot(q_values, values.index_select(0, rows))
        return acc.to(torch.float32) * scales.index_select(0, rows)[None, :]

    vals, ids = _plain_ivf_top_k(scores, tile_table, q_values.shape[0],
                                 values.shape[1], k, tile_n, n_real)
    vals = torch.where(ids < 0, float("-inf"), vals * q_scales[:, None])
    return vals, ids


def ivf_dense_top_k_int8(
    values: torch.Tensor, scales: torch.Tensor, q_values: torch.Tensor,
    q_scales: torch.Tensor, tile_table: torch.Tensor, k: int, tile_n: int,
    n_real: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: int8 scoring + top-k over the tiles of ``tile_table``. values
    [Np, D] int8 + scales [Np] f32 (0.0 on pad rows), cluster-major;
    q_values [B, D] int8 + q_scales [B] f32."""
    max_tiles = _check_call(values, q_values, tile_table, k, tile_n, n_real)
    b = q_values.shape[0]
    npad, d = values.shape
    dev = values.device
    _check(values, "values", (torch.int8,), (npad, d), dev)
    _check(scales, "scales", (torch.float32,), (npad,), dev)
    _check(q_values, "q_values", (torch.int8,), (b, d), dev)
    _check(q_scales, "q_scales", (torch.float32,), (b,), dev)
    if dev.type == "cpu":
        return ivf_dense_top_k_int8_torch(values, scales, q_values,
                                          q_scales, tile_table, k, tile_n,
                                          n_real)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    splits = _splits(max_tiles, b, dev)
    part_v, part_i, out_v, out_i = _outputs(b, k, splits, dev)
    with torch.cuda.device(dev):
        _launch(lib.anr_ivf_topk_int8, q_values.data_ptr(),
                q_scales.data_ptr(), values.data_ptr(), scales.data_ptr(),
                tile_table.data_ptr(), max_tiles, n_real, b, d, k, tile_n,
                splits, part_v.data_ptr(), part_i.data_ptr(),
                out_v.data_ptr(), out_i.data_ptr(), device=dev)
    ivf_dense_top_k_int8.launches += 1
    return out_v, out_i


ivf_dense_top_k_int8.launches = 0
