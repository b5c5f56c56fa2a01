"""GPipe-style pipeline-parallel training for the embedding encoder (the
port of the JAX package's ``models/pipeline.py``).

The block stack is split into ``pp`` stages whose parameters live on
their stage's slots only, and a microbatched schedule streams activations
stage to stage over a ``(dp, pp)`` slot mesh: at schedule step t, stage s
runs microbatch t - s (t_steps = n_micro + n_stages - 1; the bubble steps
are skipped), its input moved from stage s - 1's slot with ``.to``.
Autograd runs through the moves, so the train step is a plain backward
and AdamW over the pipelined forward; the ``dp`` axis splits the batch.

Layout:

* the embedding and the final norm / pool / projection are replicated:
  a small share of the work, and keeping them off the pipeline leaves
  every stage ``layers_per_stage`` identical blocks;
* the blocks' parameters are STACKED ``[n_stages, layers_per_stage,
  ...]`` and split over ``pp`` on the leading axis.

``split_pipeline_params`` / ``merge_pipeline_params`` convert to and from
the encoder's state dict (``blocks.N.*``), so checkpoints and the
one-slot path interoperate.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from a_nice_rag_tpu_torch.models.encoder import (
    Block,
    EncoderConfig,
    masked_mean,
    positions_of,
    rms_norm,
    unit_rows,
)
from a_nice_rag_tpu_torch.models.train import (
    SlotParams,
    adamw,
    slot_train_step,
    split_batch,
)
from a_nice_rag_tpu_torch.parallel.mesh import DeviceMesh

StateDict = Dict[str, torch.Tensor]
HEAD, TAIL = ("embed.weight",), ("norm.scale", "out.weight")
_PREFIX = {"head": "head.", "blocks": "blocks.", "tail": "tail."}


def split_pipeline_params(params: StateDict, n_stages: int
                          ) -> Tuple[StateDict, StateDict, StateDict]:
    """(head, stacked_blocks, tail) from a ``TransformerEncoder`` state
    dict; ``stacked_blocks`` maps each block parameter's name (``qkv.weight``
    ...) to a [n_stages, layers_per_stage, ...] tensor."""
    n_layers = len({k.split(".")[1] for k in params
                    if k.startswith("blocks.")})
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         "stages")
    per = n_layers // n_stages
    names = [k[len("blocks.0."):] for k in params
             if k.startswith("blocks.0.")]
    stacked = {}
    for name in names:
        leaves = [params[f"blocks.{i}.{name}"] for i in range(n_layers)]
        stacked[name] = torch.stack(leaves).reshape(
            (n_stages, per) + tuple(leaves[0].shape))
    return ({k: params[k] for k in HEAD}, stacked,
            {k: params[k] for k in TAIL})


def merge_pipeline_params(head: StateDict, stacked: StateDict,
                          tail: StateDict) -> StateDict:
    """Inverse of ``split_pipeline_params`` (the encoder's state dict, in
    its order)."""
    n_stages, per = next(iter(stacked.values())).shape[:2]
    out = dict(head)
    for s in range(n_stages):
        for j in range(per):
            for name, v in stacked.items():
                out[f"blocks.{s * per + j}.{name}"] = v[s, j]
    out.update(tail)
    return out


def pipeline_parts(flat: StateDict) -> Tuple[StateDict, StateDict,
                                             StateDict]:
    """(head, stacked_blocks, tail) of a pipeline's flat state dict (the
    train step's ``SlotParams.state_dict()``)."""
    return tuple({k[len(p):]: v for k, v in flat.items() if k.startswith(p)}
                 for p in _PREFIX.values())


def _tail_apply(tail: StateDict, x, mask):
    """Final RMSNorm + masked mean pool + projection + L2 norm (clipped
    at 1e-6), the encoder's tail."""
    pooled = masked_mean(rms_norm(x, tail["norm.scale"]), mask)
    return unit_rows(F.linear(pooled, tail["out.weight"].float()))


def _gpipe(cfg: EncoderConfig, grid, n_micro: int, head_at: Callable,
           blocks_at: Callable, tail_at: Callable, tokens):
    """The pipelined forward over a (dp, pp) grid of slots: ``head_at(g)``
    / ``tail_at(g)`` give dp group g's replicated head / tail on its first
    / last stage, ``blocks_at(g, s)`` stage s's stacked piece
    [1, layers_per_stage, ...] on its slot."""
    dp, n_stages = grid.shape
    with torch.device("meta"):
        block = Block(cfg)
    first = grid[0, 0].device
    embs = []
    for g, rows in enumerate(split_batch(tokens, dp)):
        if rows.shape[0] % n_micro:
            raise ValueError(f"{rows.shape[0]} rows per dp group do not "
                             f"split into {n_micro} microbatches")
        mb = rows.shape[0] // n_micro
        rows = rows.to(grid[g, 0].device)
        mask = rows > 0
        x0 = F.embedding(rows, head_at(g)["embed.weight"]).to(cfg.dtype)
        xm, maskm = x0.split(mb), mask.split(mb)
        posm = positions_of(mask).split(mb)
        carry, outs = [None] * n_stages, [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            step = [None] * n_stages
            for s in range(n_stages):
                m = t - s  # stage s runs microbatch t - s at step t
                if not 0 <= m < n_micro:
                    continue
                dev = grid[g, s].device
                x = (xm[m] if s == 0 else carry[s - 1]).to(dev)
                msk, pos = maskm[m].to(dev), posm[m].to(dev)
                stage = blocks_at(g, s)
                for j in range(next(iter(stage.values())).shape[1]):
                    x = functional_call(
                        block, {k: v[0, j] for k, v in stage.items()},
                        (x, msk, pos))
                step[s] = x
            carry = step
            if 0 <= t - (n_stages - 1) < n_micro:
                outs[t - (n_stages - 1)] = carry[-1]
        last = grid[g, -1].device
        emb = _tail_apply(tail_at(g), torch.cat(outs), mask.to(last))
        embs.append(emb.to(first))
    return torch.cat(embs)


def make_pipeline_forward(cfg: EncoderConfig, mesh: DeviceMesh, n_micro: int,
                          dp_axis: str = "dp", pp_axis: str = "pp"):
    """The pipelined embedding forward over a (dp, pp) mesh:
    ``forward(head, stacked_blocks, tail, tokens) -> [B, out]`` on the
    first slot. Each stage's stacked blocks are moved to its slot (a no-op
    when they are there); tokens split over dp."""
    grid = mesh.slot_grid(dp_axis, pp_axis)

    def forward(head, stacked, tail, tokens):
        def at(d, dev):
            return {k: v.to(dev) for k, v in d.items()}

        return _gpipe(
            cfg, grid, n_micro, lambda g: at(head, grid[g, 0].device),
            lambda g, s: {k: v[s:s + 1].to(grid[g, s].device)
                          for k, v in stacked.items()},
            lambda g: at(tail, grid[g, -1].device), tokens)

    return forward


def make_pipeline_train_step(
    cfg: EncoderConfig,
    params: StateDict,
    mesh: DeviceMesh,
    n_micro: int = 2,
    optimizer: Optional[Callable] = None,
    temperature: float = 0.05,
    dp_axis: str = "dp",
    pp_axis: str = "pp",
):
    """Contrastive training with pipeline-parallel blocks from the
    encoder state dict ``params``.

    Returns ``(step, pipe_params, optimizer, batch_layout)``: ``step(q_ids,
    d_ids) -> loss``; ``pipe_params`` (``SlotParams``) holds each stage
    slot's stacked blocks (split over pp) and a copy of the head and tail
    (``merge_pipeline_params(*pipeline_parts(pipe_params.state_dict()))``
    is the encoder's state dict); ``batch_layout`` is ``(dp_axis, None)``."""
    grid = mesh.slot_grid(dp_axis, pp_axis)
    head, stacked, tail = split_pipeline_params(params, grid.shape[1])
    parts = {"head": head, "blocks": stacked, "tail": tail}
    flat = {_PREFIX[p] + k: v for p, d in parts.items() for k, v in d.items()}
    split = {_PREFIX["blocks"] + k: (pp_axis, 0) for k in stacked}
    pipe = SlotParams(grid, (dp_axis, pp_axis), flat, split)
    opt = (optimizer or adamw)(pipe.parameters())

    def pick(idx, prefix):
        return {k[len(prefix):]: v for k, v in pipe.params[idx].items()
                if k.startswith(prefix)}

    def forward(tokens):
        return _gpipe(cfg, grid, n_micro, lambda g: pick((g, 0), "head."),
                      lambda g, s: pick((g, s), "blocks."),
                      lambda g: pick((g, grid.shape[1] - 1), "tail."),
                      tokens)

    return (slot_train_step(pipe, opt, forward, temperature), pipe, opt,
            (dp_axis, None))
