"""Contrastive training for the encoder (the port of the JAX package's
``models/train.py``).

Training objective: symmetric InfoNCE with in-batch negatives, the
standard recipe for embedding models. The optimizer is AdamW with
``optax.adamw(1e-3)``'s settings (``adamw`` below): torch's default
weight decay is 1e-2, optax's 1e-4, applied to every parameter (optax's
mask is None), norms and embeddings included. Both decay the pre-update
parameter, so a step is the same update.

Multi-slot training runs on the single controller of ``parallel/mesh.py``:
``SlotParams`` lays a model's parameters over a slot grid, each slot
holding the whole of a replicated tensor or its piece of a split one (and
AdamW's two moments of that piece alone). The host dispatches each slot's
share of the forward; gradients of the copies of one piece are added in
slot order, so a step is deterministic, and every copy takes the same
update. ``make_sharded_train_step`` is the dp x tp (x sp) step:

* the batch is split over ``dp``; each dp group embeds its rows and the
  [B, B] logits are formed on the lead slot;
* every 2-D matrix is split over ``tp`` on its largest dim, the row axis
  on a tie, stated on flax's ``[in, out]`` orientation (``param_layout``):
  a column-split projection's outputs are gathered, a row-split one's
  partial sums added in slot order;
* with ``sp_axis`` the sequence is split over ``sp``: embeddings, norms
  and MLPs run on each slot's chunk, and attention gathers the group's
  K/V.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from a_nice_rag_tpu_torch.models.encoder import (
    attend,
    positions_of,
    rms_norm,
    split_heads,
    unit_rows,
)
from a_nice_rag_tpu_torch.parallel.mesh import DeviceMesh

Split = Optional[Tuple[str, int]]  # (mesh axis, tensor dim) or replicated


def adamw(params, lr: float = 1e-3) -> torch.optim.AdamW:
    """AdamW with ``optax.adamw(lr)``'s defaults: betas (0.9, 0.999), eps
    1e-8, weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def contrastive_loss(q_emb: torch.Tensor, d_emb: torch.Tensor,
                     temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE; positives are the matching (q_i, d_i) pairs."""
    logits = (q_emb @ d_emb.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2.0


def make_train_step(model: nn.Module, optimizer=None,
                    temperature: float = 0.05):
    """One-slot train step on the model's device: ``(step, optimizer)``
    with ``step(q_ids, d_ids) -> loss``, the model and the optimizer
    updated in place."""
    optimizer = optimizer or adamw(model.parameters())

    def step(q_ids, d_ids):
        optimizer.zero_grad(set_to_none=True)
        loss = contrastive_loss(model(q_ids), model(d_ids), temperature)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step, optimizer


def load_adamw_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                     state: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """Set AdamW's per-parameter state (``step``, ``exp_avg``,
    ``exp_avg_sq``; ``convert.adamw_state_from_optax``'s output) by
    parameter name."""
    for name, p in model.named_parameters():
        s = state[name]
        optimizer.state[p] = {
            "step": torch.tensor(float(s["step"]), dtype=torch.float32),
            "exp_avg": s["exp_avg"].to(p.device, p.dtype).clone(),
            "exp_avg_sq": s["exp_avg_sq"].to(p.device, p.dtype).clone(),
        }


def param_layout(model: nn.Module, mesh: DeviceMesh,
                 tp_axis: str = "tp") -> Dict[str, Optional[int]]:
    """The tensor-parallel rule of the JAX package: every 2-D matrix whose
    largest dim divides by tp is split on that dim, the row (input) axis
    on a tie, judged on flax's orientation (an ``nn.Linear`` weight is its
    kernel transposed). Returns each parameter's torch split dim, or None
    when it is replicated."""
    tp = mesh.shape[tp_axis]
    out: Dict[str, Optional[int]] = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            dim = None
            if p.ndim == 2 and max(p.shape) % tp == 0:
                linear = isinstance(mod, nn.Linear)
                flax = tuple(reversed(p.shape)) if linear else tuple(p.shape)
                flax_dim = 0 if flax[0] >= flax[1] else 1
                dim = 1 - flax_dim if linear else flax_dim
            out[name] = dim
    return out


class SlotParams:
    """A model's float32 parameters laid over a grid of slots.

    ``split[name]`` is None (every slot holds the whole tensor) or
    ``(axis, dim)``: the slot at grid index ``idx`` holds piece
    ``idx[axis]`` of the tensor split along ``dim`` into as many pieces as
    the axis has slots."""

    def __init__(self, grid: np.ndarray, axes: Sequence[str],
                 state: Mapping[str, torch.Tensor],
                 split: Mapping[str, Split]):
        self.grid, self.axes = grid, tuple(axes)
        self.split = {name: split.get(name) for name in state}
        self.index = list(np.ndindex(grid.shape))
        self.params: Dict[tuple, Dict[str, nn.Parameter]] = {
            idx: {} for idx in self.index}
        for name, full in state.items():
            for idx in self.index:
                piece = full
                if self.split[name] is not None:
                    a, dim = self._axis(name)
                    piece = full.tensor_split(grid.shape[a], dim)[idx[a]]
                self.params[idx][name] = nn.Parameter(piece.detach().to(
                    grid[idx].device, torch.float32, copy=True))

    def _axis(self, name) -> Tuple[int, int]:
        ax, dim = self.split[name]
        return self.axes.index(ax), dim

    def device(self, idx) -> torch.device:
        return self.grid[idx].device

    def at(self, idx, name) -> nn.Parameter:
        return self.params[idx][name]

    def parameters(self):
        return [p for idx in self.index for p in self.params[idx].values()]

    def _groups(self, name):
        """The slots holding each piece of ``name``, in slot order."""
        if self.split[name] is None:
            return [self.index]
        a, _ = self._axis(name)
        return [[i for i in self.index if i[a] == j]
                for j in range(self.grid.shape[a])]

    @torch.no_grad()
    def sync_grads(self) -> None:
        """Each copy of a piece takes the sum, in slot order, of every
        copy's gradient (the copies were used by different slots' shares of
        the forward)."""
        for name in self.split:
            for group in self._groups(name):
                total = None
                for i in group:
                    g = self.params[i][name].grad
                    if g is not None:
                        g = g.to(self.device(group[0]))
                        total = g.clone() if total is None else total + g
                if total is None:
                    continue
                for i in group:
                    self.params[i][name].grad = total.to(self.device(i),
                                                         copy=True)

    @torch.no_grad()
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole tensors, assembled on the first slot's device."""
        first = self.index[0]
        dev = self.device(first)
        out = {}
        for name in self.split:
            if self.split[name] is None:
                out[name] = self.params[first][name].detach().clone()
                continue
            a, dim = self._axis(name)
            pieces = [self.params[tuple(j if k == a else 0
                                        for k in range(len(first)))][name]
                      for j in range(self.grid.shape[a])]
            out[name] = torch.cat([p.detach().to(dev) for p in pieces], dim)
        return out


def slot_train_step(params: SlotParams, optimizer, embed: Callable,
                    temperature: float = 0.05,
                    aux_weight: Optional[float] = None):
    """``step(q_ids, d_ids) -> loss`` over a slot grid: ``embed(ids)`` is
    the model's sharded forward (``(emb, aux)`` when ``aux_weight`` is
    given, the auxiliary loss added to what is minimized and left out of
    the returned loss)."""

    def step(q_ids, d_ids):
        optimizer.zero_grad(set_to_none=True)
        q, d = embed(q_ids), embed(d_ids)
        if aux_weight is None:
            loss = total = contrastive_loss(q, d, temperature)
        else:
            loss = contrastive_loss(q[0], d[0], temperature)
            total = loss + aux_weight * (q[1] + d[1])
        total.backward()
        params.sync_grads()
        optimizer.step()
        return loss.detach()

    return step


def split_batch(ids: torch.Tensor, n: int):
    """``ids`` split into n equal row blocks (raises when it does not
    divide)."""
    if ids.shape[0] % n:
        raise ValueError(f"a batch of {ids.shape[0]} rows does not split "
                         f"over {n} slots")
    return ids.tensor_split(n, 0)


class TensorParallelEncoder:
    """The ``TransformerEncoder`` forward over a (dp, tp, sp) grid of
    ``SlotParams``: ``__call__(ids) -> [B, out_dim]`` on the first slot."""

    def __init__(self, cfg, params: SlotParams, layout):
        self.cfg, self.p, self.layout = cfg, params, layout
        self.dp, self.tp, self.sp = params.grid.shape

    def linear(self, g, s, name, x, dtype):
        """``dense`` of x (on slot (g, 0, s)) by a possibly split weight:
        a column split's outputs are gathered, a row split's partial sums
        added in slot order (float32), both on slot (g, 0, s)."""
        dim = self.layout[name]
        lead = self.p.device((g, 0, s))
        if dim is None:
            return F.linear(x.to(dtype),
                            self.p.at((g, 0, s), name).to(dtype))
        xs = x.tensor_split(self.tp, -1) if dim == 1 else [x] * self.tp
        parts = []
        for t in range(self.tp):
            w = self.p.at((g, t, s), name)
            parts.append(F.linear(xs[t].to(w.device, dtype),
                                  w.to(dtype)).to(lead))
        if dim == 0:
            return torch.cat(parts, -1)
        acc = parts[0].float()
        for part in parts[1:]:
            acc = acc + part.float()
        return acc.to(dtype)

    def embed(self, g, s, ids):
        """Token rows of a possibly split table: a vocab split adds each
        slot's rows of its own range (zeros elsewhere)."""
        name, dim = "embed.weight", self.layout["embed.weight"]
        lead = self.p.device((g, 0, s))
        if dim is None:
            return F.embedding(ids, self.p.at((g, 0, s), name))
        parts, lo = [], 0
        for t in range(self.tp):
            w = self.p.at((g, t, s), name)
            if dim == 1:
                parts.append(F.embedding(ids.to(w.device), w).to(lead))
                continue
            n = w.shape[0]
            local = ids.to(w.device) - lo
            hit = ((local >= 0) & (local < n))[..., None]
            parts.append((F.embedding(local.clamp(0, n - 1), w) * hit)
                         .to(lead))
            lo += n
        if dim == 1:
            return torch.cat(parts, -1)
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return acc

    def group(self, g, ids):
        """Embeddings of dp group g's rows, on slot (g, 0, 0)."""
        cfg, dt, sp = self.cfg, self.cfg.dtype, self.sp
        if ids.shape[1] % sp:
            raise ValueError(f"sequence of {ids.shape[1]} does not split "
                             f"over sp={sp}")
        leads = [self.p.device((g, 0, s)) for s in range(sp)]
        mask = ids > 0
        cut = [ids.tensor_split(sp, 1), mask.tensor_split(sp, 1),
               positions_of(mask).tensor_split(sp, 1)]
        ids_s, mask_s, pos_s = ([c[s].to(leads[s]) for s in range(sp)]
                                for c in cut)
        keys = [mask.to(d) for d in leads]
        x = [self.embed(g, s, ids_s[s]).to(dt) for s in range(sp)]

        def rep(s, name):
            return self.p.at((g, 0, s), name)

        for i in range(cfg.n_layers):
            pre = f"blocks.{i}."
            qkv = [split_heads(cfg, self.linear(
                g, s, pre + "qkv.weight",
                rms_norm(x[s], rep(s, pre + "attn_norm.scale")), dt),
                pos_s[s]) for s in range(sp)]
            for s in range(sp):
                k = torch.cat([h[1].to(leads[s]) for h in qkv], 1)
                v = torch.cat([h[2].to(leads[s]) for h in qkv], 1)
                out = attend(cfg, qkv[s][0], k, v, keys[s])
                x[s] = x[s] + self.linear(g, s, pre + "proj.weight", out, dt)
            for s in range(sp):
                h = rms_norm(x[s], rep(s, pre + "mlp_norm.scale"))
                a = F.silu(self.linear(g, s, pre + "gate.weight", h, dt)) \
                    * self.linear(g, s, pre + "up.weight", h, dt)
                x[s] = x[s] + self.linear(g, s, pre + "down.weight", a, dt)
        num = den = None
        for s in range(sp):
            w = mask_s[s].float()[:, :, None]
            part = (rms_norm(x[s], rep(s, "norm.scale")).float() * w).sum(1)
            part, cnt = part.to(leads[0]), w.sum(1).to(leads[0])
            num = part if num is None else num + part
            den = cnt if den is None else den + cnt
        pooled = num / den.clamp(min=1.0)
        return unit_rows(self.linear(g, 0, "out.weight", pooled,
                                     torch.float32))

    def __call__(self, ids):
        first = self.p.device(self.p.index[0])
        return torch.cat([self.group(g, rows).to(first) for g, rows in
                          enumerate(split_batch(ids, self.dp))])


def make_sharded_train_step(
    model: nn.Module,
    params: Optional[Mapping[str, torch.Tensor]],
    mesh: DeviceMesh,
    optimizer: Optional[Callable] = None,
    temperature: float = 0.05,
    dp_axis: str = "dp",
    tp_axis: str = "tp",
    sp_axis: Optional[str] = None,
):
    """dp x tp (x optionally sp) sharded train step of a
    ``TransformerEncoder`` (its config and structure; ``params``, a state
    dict, or the model's own when None, are the starting weights).

    Returns ``(step, slot_params, optimizer, batch_layout)``: ``step(q_ids,
    d_ids) -> loss``; ``slot_params`` (``SlotParams``) holds each slot's
    shards, ``.state_dict()`` the whole weights; ``optimizer`` (``adamw``
    unless ``optimizer(params)`` builds another) holds each shard's
    moments on its slot; ``batch_layout`` is ``(dp_axis, sp_axis)``: the
    batch rows split over dp, the sequence over sp."""
    state = dict(params if params is not None else model.state_dict())
    layout = param_layout(model, mesh, tp_axis)
    grid = mesh.slot_grid(dp_axis, tp_axis, sp_axis)
    if sp_axis is None:
        grid = grid[:, :, None]
    slot_params = SlotParams(
        grid, (dp_axis, tp_axis, sp_axis or "sp"), state,
        {n: None if d is None else (tp_axis, d) for n, d in layout.items()})
    opt = (optimizer or adamw)(slot_params.parameters())
    forward = TensorParallelEncoder(model.cfg, slot_params, layout)
    return (slot_train_step(slot_params, opt, forward, temperature),
            slot_params, opt, (dp_axis, sp_axis))
