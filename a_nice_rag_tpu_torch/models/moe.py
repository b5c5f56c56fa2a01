"""Mixture-of-experts encoder with expert parallelism (the port of the JAX
package's ``models/moe.py``).

The FFN of every block becomes a top-1 routed mixture of SwiGLU experts
with GShard-style dispatch: one-hot dispatch/combine tensors contracted by
einsum, no gather/scatter. Expert weights are stacked ``[E, ...]``; on the
``ep`` axis of a slot mesh each slot holds ``E / ep`` experts of
``w_gate``, ``w_up`` and ``w_out`` (``moe_param_shardings``), and the
host sends each slot its experts' share of the dispatched tokens.

Capacity: each expert takes at most ``max(1, int(capacity_factor * S /
E))`` tokens of a row; overflow tokens fall back to the residual stream.
The router runs in float32 and ``argmax`` takes the first index on a tie.
Padding tokens are neither routed nor counted in the load-balance
auxiliary loss, which keeps the router from collapsing onto one expert.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from a_nice_rag_tpu_torch.device import DeviceLike
from a_nice_rag_tpu_torch.models.encoder import (
    RMSNorm,
    attention_sublayer,
    flax_like_std,
    materialize,
    pooled_projection,
    positions_of,
)
from a_nice_rag_tpu_torch.models.train import (
    SlotParams,
    adamw,
    slot_train_step,
    split_batch,
)
from a_nice_rag_tpu_torch.parallel.mesh import DeviceMesh

EXPERTS = ("w_gate", "w_up", "w_out")


@dataclasses.dataclass(frozen=True)
class MoEEncoderConfig:
    vocab_size: int = 32768
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 512
    out_dim: int = 256
    n_experts: int = 4
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16


def route(cfg: MoEEncoderConfig, x, valid, router_weight):
    """(dispatch, combine, stats) of the tokens x [B, S, D]: dispatch
    [B, S, E, C] one-hot over (expert, capacity slot), combine the same
    weighted by the router gate, both in ``cfg.dtype``; stats [2E + 1] the
    valid tokens routed to each expert, their summed router probabilities
    and their count (``balance_loss``'s inputs, which add over batches)."""
    s, e = x.shape[1], cfg.n_experts
    cap = max(1, int(cfg.capacity_factor * s / e))
    probs = torch.softmax(F.linear(x.float(), router_weight.float()), -1)
    gate, expert = probs.max(-1)  # the first index on a tie
    valid_f = valid.float()
    onehot = F.one_hot(expert, e).float() * valid_f[..., None]
    gate = gate * valid_f
    stats = torch.cat([onehot.sum((0, 1)),
                       (probs * valid_f[..., None]).sum((0, 1)),
                       valid_f.sum()[None]])
    # Each routed token's place in its expert's buffer (-1 when unrouted).
    pos = ((torch.cumsum(onehot, 1) * onehot).sum(-1) - 1.0).long()
    keep = (pos < cap) & (pos >= 0)
    # Overflow and unrouted tokens take class ``cap``, which is dropped:
    # an all-zero dispatch row (flax's one_hot of an out-of-range index).
    slot_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]
    dispatch = (onehot.to(cfg.dtype)[..., None]
                * slot_oh.to(cfg.dtype)[:, :, None, :])
    return dispatch, dispatch * gate.to(cfg.dtype)[..., None, None], stats


def balance_loss(cfg: MoEEncoderConfig, stats):
    """GShard's load-balance loss (eq. 4): E times the sum over experts of
    the valid tokens' routed fraction times their mean probability."""
    e = cfg.n_experts
    n = stats[-1].clamp(min=1.0)
    return e * ((stats[:e] / n) * (stats[e:2 * e] / n)).sum()


def expert_ffn(xin, w_gate, w_up, w_out, dtype):
    """SwiGLU experts over their buffers: xin [B, E, C, D] -> [B, E, C, D]."""
    g = torch.einsum("becd,edh->bech", xin, w_gate.to(dtype))
    u = torch.einsum("becd,edh->bech", xin, w_up.to(dtype))
    return torch.einsum("bech,ehd->becd", F.silu(g) * u, w_out.to(dtype))


class MoEFFN(nn.Module):
    """Top-1 routed SwiGLU experts with einsum dispatch/combine."""

    def __init__(self, cfg: MoEEncoderConfig):
        super().__init__()
        d, e, h = cfg.dim, cfg.n_experts, cfg.mlp_ratio * cfg.dim
        self.cfg = cfg
        self.router = nn.Linear(d, e, bias=False)
        self.w_gate = nn.Parameter(torch.empty(e, d, h))
        self.w_up = nn.Parameter(torch.empty(e, d, h))
        self.w_out = nn.Parameter(torch.empty(e, h, d))

    def forward(self, x, valid):
        """(y, aux loss) of x [B, S, D] with ``valid`` [B, S]."""
        y, stats = self.mix(x, valid)
        return y, balance_loss(self.cfg, stats)

    def mix(self, x, valid, experts: Optional[Callable] = None):
        """(y, routing stats); ``experts(xin)`` replaces the local expert
        FFN (the expert-parallel step sends each slot its experts'
        buffers)."""
        dt = self.cfg.dtype
        dispatch, combine, stats = route(self.cfg, x, valid,
                                         self.router.weight)
        xin = torch.einsum("bsec,bsd->becd", dispatch, x.to(dt))
        out = (experts(xin) if experts is not None else
               expert_ffn(xin, self.w_gate, self.w_up, self.w_out, dt))
        y = torch.einsum("bsec,becd->bsd", combine, out)
        return y.to(x.dtype), stats


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoEEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = RMSNorm(cfg.dim)
        self.qkv = nn.Linear(cfg.dim, 3 * cfg.dim, bias=False)
        self.proj = nn.Linear(cfg.dim, cfg.dim, bias=False)
        self.mlp_norm = RMSNorm(cfg.dim)
        self.ffn = MoEFFN(cfg)

    def forward(self, x, mask, positions):
        x, stats = self.mix(x, mask, positions)
        return x, balance_loss(self.cfg, stats)

    def mix(self, x, mask, positions, experts=None):
        x = attention_sublayer(self.cfg, self.attn_norm, self.qkv,
                               self.proj, x, mask, positions)
        # The norm is float32, so is y, and the residual stream promotes
        # to float32 here, as the JAX module's does.
        y, stats = self.ffn.mix(self.mlp_norm(x), mask, experts)
        return x + y, stats


class MoETransformerEncoder(nn.Module):
    """Unit-norm embedding encoder whose FFNs are routed experts:
    ``forward(ids) -> (embeddings [B, out_dim], mean aux loss)``."""

    def __init__(self, cfg: MoEEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.blocks = nn.ModuleList(MoEBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim)
        self.out = nn.Linear(cfg.dim, cfg.out_dim, bias=False)

    def forward(self, token_ids, mask: Optional[torch.Tensor] = None):
        out, stats = self.mix(token_ids, mask)
        return out, aux_of(self.cfg, stats)

    def mix(self, token_ids, mask: Optional[torch.Tensor] = None,
            experts: Optional[Callable] = None):
        """(embeddings, each block's routing stats); ``experts(layer,
        xin)`` replaces every block's local expert FFN."""
        if mask is None:
            mask = token_ids > 0
        x = F.embedding(token_ids, self.embed.weight).to(self.cfg.dtype)
        positions = positions_of(mask)
        stats = []
        for i, blk in enumerate(self.blocks):
            x, st = blk.mix(x, mask, positions, None if experts is None
                            else functools.partial(experts, i))
            stats.append(st)
        return pooled_projection(self.norm, self.out, x, mask), stats


def aux_of(cfg: MoEEncoderConfig, stats) -> torch.Tensor:
    """The encoder's aux loss: the blocks' balance losses, averaged."""
    total = 0.0
    for st in stats:
        total = total + balance_loss(cfg, st)
    return total / cfg.n_layers


def init_moe_encoder(cfg: MoEEncoderConfig, seed: int = 0,
                     device: DeviceLike = "cuda") -> MoETransformerEncoder:
    """A ``MoETransformerEncoder`` with seeded random float32 weights on
    ``device`` (the card unless asked otherwise), at flax's scales
    (1/sqrt(fan_in)); the JAX package's come across through
    ``models.convert.moe_state_from_flax``."""
    return materialize(lambda: MoETransformerEncoder(cfg), device, seed,
                       flax_like_std)


def moe_param_shardings(model: nn.Module, mesh: DeviceMesh,
                        ep_axis: str = "ep") -> Dict[str, Optional[int]]:
    """Expert parallelism: the stacked expert tensors [E, ...] split over
    ``ep`` on their leading dim (when E divides); everything else is
    replicated. Returns each parameter's split dim or None."""
    ep = mesh.shape[ep_axis]
    return {name: 0 if (name.split(".")[-1] in EXPERTS and p.ndim == 3
                        and p.shape[0] % ep == 0) else None
            for name, p in model.named_parameters()}


def make_moe_train_step(
    model: MoETransformerEncoder,
    params: Optional[Dict[str, torch.Tensor]],
    mesh: DeviceMesh,
    optimizer: Optional[Callable] = None,
    temperature: float = 0.05,
    aux_weight: float = 0.01,
    dp_axis: str = "dp",
    ep_axis: str = "ep",
):
    """Contrastive training with expert-parallel FFNs over a (dp, ep)
    mesh, from the state dict ``params`` (the model's own when None).

    Returns ``(step, slot_params, optimizer, batch_layout)``: ``step(q_ids,
    d_ids) -> contrastive loss`` (``aux_weight`` times the two aux losses
    is added to what is minimized); slot (g, e) holds experts
    ``[e E/ep, (e+1) E/ep)`` and a copy of the rest; ``batch_layout`` is
    ``(dp_axis, None)``."""
    state = dict(params if params is not None else model.state_dict())
    layout = moe_param_shardings(model, mesh, ep_axis)
    grid = mesh.slot_grid(dp_axis, ep_axis)
    ep = grid.shape[1]
    slot_params = SlotParams(
        grid, (dp_axis, ep_axis), state,
        {n: None if d is None else (ep_axis, d) for n, d in layout.items()})
    opt = (optimizer or adamw)(slot_params.parameters())
    dt = model.cfg.dtype

    def bound(g):
        """A module over slot (g, 0)'s parameters, its experts left out
        when they are split (the hook computes them on their slots)."""
        with torch.device("meta"):
            m = MoETransformerEncoder(model.cfg)
        for name, p in slot_params.params[(g, 0)].items():
            if layout[name] is None:
                mod, _, leaf = name.rpartition(".")
                setattr(m.get_submodule(mod), leaf, p)
        return m

    def experts_of(g):
        lead = grid[g, 0].device

        def experts(i, xin):
            names = [f"blocks.{i}.ffn.{w}" for w in EXPERTS]
            parts = []
            for e, xs in enumerate(xin.tensor_split(ep, 1)):
                w = [slot_params.at((g, e), n) for n in names]
                parts.append(expert_ffn(xs.to(w[0].device), *w, dt)
                             .to(lead))
            return torch.cat(parts, 1)

        return None if layout[f"blocks.0.ffn.{EXPERTS[0]}"] is None \
            else experts

    modules = [bound(g) for g in range(grid.shape[0])]

    def forward(ids):
        outs, stats = [], None
        first = grid[0, 0].device
        for g, rows in enumerate(split_batch(ids, grid.shape[0])):
            emb, st = modules[g].mix(rows.to(grid[g, 0].device),
                                     experts=experts_of(g))
            outs.append(emb.to(first))
            st = [x.to(first) for x in st]
            # Routing stats add over the dp groups: the aux loss is the
            # whole batch's, as one slot computes it.
            stats = st if stats is None else [a + b for a, b in
                                              zip(stats, st)]
        return torch.cat(outs), aux_of(model.cfg, stats)

    return (slot_train_step(slot_params, opt, forward, temperature,
                            aux_weight), slot_params, opt, (dp_axis, None))
