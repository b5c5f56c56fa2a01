"""On-card tuning of K1's work plan: the query block and the doc splits.

Counterpart of the JAX package's tuner (``tune_fused_blocks`` of its TPU
kernels' ``autotune.py``). The TPU tuner searched block shapes and fold
algorithms of a Mosaic kernel; here the exact fold is one kernel (K1,
``csrc/fused_topk.cu``) and only its plan varies: the query block (16 or
64, where its block fits a CTA's shared memory) and the doc splits at
half, one and two times ``topk_plan``'s. ``allow_rounded`` adds the
rounded fold (K1r, the TPU tuner's ``ROUNDED_CANDIDATES``,
``algo="packed"``) as it runs at the call's shape: where
``fused_topk.bf16_cluster_route`` sends it to the cluster kernel, which
has no K1 plan, once (``KernelConfig(rounded=True)``); where it runs K1's
kernel, the same plans on it. The plan spreads the work only, so every candidate
must give its fold's default plan's ids (K1's, or K1r's for a rounded
candidate); one that does not is skipped with a warning, as the TPU tuner
skipped a miscompiled candidate. The winner's plan is tied to the batch
it was tuned at (``KernelConfig.batch``), its fold is not; it is memoized
per signature (card name, N, D, B, k, row dtype, and ":rounded" with
``allow_rounded``) and optionally kept in a JSON file.

On tensors off CUDA the defaults come back without measuring: the plain
version's time says nothing about the card.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from a_nice_rag_tpu_torch.ops.kernels import topk_plan
from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
    _ROWS,
    ROUNDED_ALIGN,
    SCORE_ROUNDED,
    _sm_count,
    bf16_cluster_route,
    fused_dense_top_k,
)

logger = logging.getLogger(__name__)


class KernelConfig(NamedTuple):
    """K1's query block and doc splits; None keeps ``topk_plan``'s own.
    ``KernelConfig()`` is the default plan. Passed as ``plan=`` to
    ``fused_dense_top_k`` and as ``kernel_config=`` to the retrievers.

    ``batch``: the batch the plan was tuned at. ``splits`` is a count of
    CTAs that ``topk_plan`` sizes to a batch's query blocks, so the
    retrievers apply the plan to calls of that many queries only (None:
    to every call); other batches keep the plan's own.

    ``rounded``: the rounded fold (``fused_dense_top_k(rounded=True)``,
    the TPU kernels' ``algo="packed"``) on the retrievers' dense lists,
    float and int8 alike, at every batch: a selection rule, not a plan."""

    bq: Optional[int] = None
    splits: Optional[int] = None
    batch: Optional[int] = None
    rounded: bool = False

    def for_batch(self, b: int) -> Optional["KernelConfig"]:
        """This config's plan for a call of ``b`` queries, or None there
        (``rounded`` is read apart from it)."""
        return self if self.batch in (None, b) else None


_memory_cache: Dict[str, KernelConfig] = {}


def _signature(emb: torch.Tensor, b: int, k: int) -> str:
    n, d = emb.shape
    card = (torch.cuda.get_device_name(emb.device)
            if emb.device.type == "cuda" else emb.device.type)
    return f"{card}:n{n}:d{d}:b{b}:k{k}:{emb.dtype}"


def default_candidates(n: int, b: int, d: int, k: int, sms: int,
                       rows: str) -> Tuple[KernelConfig, ...]:
    """bq in {16, 64} where it fits, each with splits at 1/2x, 1x and 2x
    the plan's for that block; the default plan first."""
    own = topk_plan.fused_plan(n, b, d, k, sms, rows)
    out = []
    for bq in (own.bq,) + tuple(x for x in (topk_plan.SMALL_BQ,
                                             topk_plan.LARGE_BQ)
                                if x != own.bq):
        try:
            base = topk_plan.override_plan(n, b, d, k, sms, rows, bq).splits
        except ValueError:
            continue
        for splits in (base, max(1, base // 2), 2 * base):
            cfg = KernelConfig(bq, splits)
            if cfg not in out:
                out.append(cfg)
    return tuple(out)


def rounded_candidates(candidates: Sequence[KernelConfig],
                       cluster: bool = False) -> Tuple[KernelConfig, ...]:
    """``candidates`` and, after them, the rounded fold: each of their
    plans on it where it runs K1's kernel, or (``cluster``: the call takes
    the cluster kernel, which K1's plan does not steer) its one route,
    ``KernelConfig(rounded=True)``."""
    if cluster:
        return tuple(candidates) + (KernelConfig(rounded=True),)
    return tuple(candidates) + tuple(c._replace(rounded=True)
                                     for c in candidates)


def rounded_takes_cluster(emb: torch.Tensor, b: int, k: int) -> bool:
    """Whether the rounded fold over ``emb`` at B = ``b`` runs the cluster
    kernel (``fused_topk.bf16_cluster_route``; N a multiple of
    ``ROUNDED_ALIGN``, else the call is K1's exact fold), which K1's plan
    does not steer."""
    n, d = emb.shape
    return n % ROUNDED_ALIGN == 0 and bf16_cluster_route(
        n, b, d, k, _ROWS[emb.dtype], SCORE_ROUNDED, emb.data_ptr() % 16 == 0)


def pick_fastest(
    run: Callable[[KernelConfig], torch.Tensor],
    time_ms: Callable[[KernelConfig], float],
    candidates: Sequence[KernelConfig],
) -> Tuple[KernelConfig, Dict[KernelConfig, float]]:
    """The fastest candidate whose ids (``run``) equal its fold's default
    plan's (``KernelConfig()``, or ``KernelConfig(rounded=True)`` for a
    rounded candidate); (winner, ms of every candidate timed). A candidate
    that diverges or fails is skipped; with none left, the default
    ``KernelConfig()``."""
    refs = {False: run(KernelConfig())}
    best, best_ms, timed = KernelConfig(), float("inf"), {}
    for cand in candidates:
        try:
            if cand.rounded not in refs:
                refs[cand.rounded] = run(KernelConfig(rounded=cand.rounded))
            got = run(cand)
            if not torch.equal(got, refs[cand.rounded]):
                logger.warning(
                    "autotune: %s ids DIVERGE from the default plan's on "
                    "this card; skipped", cand)
                continue
            ms = time_ms(cand)
        except (RuntimeError, ValueError) as e:
            logger.info("autotune: %s failed: %s", cand, e)
            continue
        timed[cand] = ms
        logger.info("autotune: bq=%s splits=%s rounded=%s -> %.4f ms",
                    cand.bq, cand.splits, cand.rounded, ms)
        if ms < best_ms:
            best, best_ms = cand, ms
    return best, timed


def tune_fused_blocks(
    emb: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    candidates: Optional[Sequence[KernelConfig]] = None,
    reps: int = 4,
    trials: int = 2,
    cache_path: Optional[str] = None,
    allow_rounded: bool = False,
) -> KernelConfig:
    """K1's fastest plan for ``emb`` [N, D] (f32 or bf16) and ``queries``
    [B, D] on the live card: each candidate's device ms (``reps`` calls
    between one pair of CUDA events, the best of ``trials``), returned
    with ``batch`` = B. ``allow_rounded`` also times the rounded fold
    (K1r) on its route (``rounded_candidates``), so the winner may select
    on bf16-rounded scores. Returns the default (``KernelConfig(rounded=
    allow_rounded)``) without measuring when ``emb`` is not on CUDA.
    Memoized per signature, and kept in ``cache_path`` (JSON) when
    set."""
    from a_nice_rag_tpu_torch.testing.timing import device_loop_ms

    b = queries.shape[0]
    sig = _signature(emb, b, k) + (":rounded" if allow_rounded else "")
    if sig in _memory_cache:
        return _memory_cache[sig]
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path, "r", encoding="utf-8") as f:
                disk = json.load(f)
            if sig in disk:
                cfg = KernelConfig(**disk[sig])
                _memory_cache[sig] = cfg
                return cfg
        except (OSError, ValueError, TypeError):
            pass
    if emb.device.type != "cuda":
        return KernelConfig(rounded=allow_rounded)

    n, d = emb.shape
    if candidates is None:
        candidates = default_candidates(n, b, d, k, _sm_count(emb.device),
                                        _ROWS[emb.dtype])
        if allow_rounded:
            candidates = rounded_candidates(
                candidates, rounded_takes_cluster(emb, b, k))

    def call(cfg):
        return fused_dense_top_k(emb, queries, k, plan=cfg,
                                 rounded=cfg.rounded)

    best, _ = pick_fastest(
        lambda cfg: call(cfg)[1],
        lambda cfg: device_loop_ms(lambda: call(cfg), n_loop=reps,
                                   trials=trials),
        candidates)
    best = best._replace(batch=b)
    _memory_cache[sig] = best
    if cache_path:
        try:
            disk = {}
            if os.path.exists(cache_path):
                with open(cache_path, "r", encoding="utf-8") as f:
                    disk = json.load(f)
            disk[sig] = best._asdict()
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            with open(cache_path, "w", encoding="utf-8") as f:
                json.dump(disk, f, indent=1)
        except OSError as e:
            logger.info("autotune: cache write failed: %s", e)
    return best
