"""Tensor-parallel placement for the decoder-LM serving path (the port of
the JAX package's ``parallel/lm.py``).

The JAX package shards the decoder's weights and KV caches with
``NamedSharding`` and lets XLA partition the unchanged programs. The port
keeps the single controller of ``parallel/mesh.py``: each slot of the
mesh's ``tp`` axis holds a ``DecoderLM`` of its own share of the heads
and MLP columns, and ``TensorParallelLM`` dispatches every sublayer to the
slots from the host. Its call is the plain decoder's, so the decode
programs, speculative rounds and the generation server run over it
unchanged.

Layout (the Megatron pattern, over the ``tp`` slots):

* ``q_proj / k_proj / v_proj / gate_proj / up_proj`` are split by output
  column: ``nn.Linear`` weights are ``[out, in]``, so that is torch dim 0
  (a flax ``[in, out]`` kernel's ``P(None, "tp")``);
* ``o_proj / down_proj`` are split by input row, torch dim 1 (flax's
  ``P("tp", None)``): each slot computes a partial sum, and the partials
  are added on the lead slot in slot order, once a sublayer, before the
  residual add;
* KV caches ``[B, Smax, nkv, hd]`` are split by kv head, so cache writes
  and the GQA attention stay on the slot. Slot i holds q heads
  ``[i nh/tp, (i+1) nh/tp)`` and kv heads ``[i nkv/tp, (i+1) nkv/tp)``,
  consistent because ``nh/tp`` is a whole multiple of the group size
  ``nh/nkv``;
* the embedding, every norm (Qwen3's per-head ``q_norm``/``k_norm`` too)
  and the tied head are replicated.

A slot's caches are ``kcaches[layer * tp + slot]`` of a flat list, so the
server's row installs, clones and pads work on them element by element
as they do on a plain per-layer list. The sums differ from the one-slot
forward's only in their order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from a_nice_rag_tpu_torch.parallel.mesh import DeviceMesh

__all__ = [
    "TensorParallelLM",
    "lm_cache_sharding",
    "lm_param_split",
    "shard_lm_caches",
    "shard_lm_params",
    "validate_tp_config",
]

_COL_SHARDED = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW_SHARDED = ("o_proj", "down_proj")
CACHE_SPLIT_DIM = 2  # the kv-head axis of [B, Smax, nkv, hd]


def lm_param_split(name: str) -> Optional[int]:
    """The torch dimension a decoder parameter (by its state-dict name) is
    split on over tp, or None when it is replicated."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-1] == "weight":
        if parts[-2] in _COL_SHARDED:
            return 0
        if parts[-2] in _ROW_SHARDED:
            return 1
    return None


def _tp_slots(mesh: DeviceMesh, tp_axis: str):
    if tp_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no axis {tp_axis!r}")
    return list(mesh.slot_grid(tp_axis))


def validate_tp_config(cfg, mesh: DeviceMesh, tp_axis: str = "tp") -> int:
    """Check a Qwen3Config divides evenly over the tp axis; returns the
    tp degree."""
    tp = len(_tp_slots(mesh, tp_axis))
    for name in ("num_heads", "num_kv_heads", "intermediate_size"):
        v = getattr(cfg, name)
        if v % tp != 0:
            raise ValueError(
                f"{name}={v} is not divisible by tp={tp}; pick a tp "
                f"degree that divides the head/MLP dimensions"
            )
    return tp


class TensorParallelLM:
    """A ``DecoderLM`` split over the tp slots, called as the plain one:
    ``(token_ids, kcaches, vcaches, cache_len) -> (logits, kcaches,
    vcaches)`` with the flat per-slot cache lists of ``init_caches``."""

    def __init__(self, model, slots: Sequence):
        from a_nice_rag_tpu_torch.models.decoder import DecoderLM

        cfg = model.cfg
        self.cfg, self.tp = cfg, len(slots)
        self.devices = [s.device for s in slots]
        self.local_cfg = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // self.tp,
            num_kv_heads=cfg.num_kv_heads // self.tp,
            intermediate_size=cfg.intermediate_size // self.tp)
        state = model.state_dict()
        self.shards: List[DecoderLM] = []
        for i, dev in enumerate(self.devices):
            sd = {}
            for name, p in state.items():
                dim = lm_param_split(name)
                # A replicated tensor already on the slot's device is
                # shared, not copied (a virtual mesh holds one).
                sd[name] = (p.to(dev) if dim is None else
                            p.tensor_split(self.tp, dim)[i].to(dev,
                                                                copy=True))
            with torch.device("meta"):
                shard = DecoderLM(self.local_cfg)
            shard.load_state_dict(sd, assign=True)
            self.shards.append(shard.eval())

    @property
    def device(self) -> torch.device:
        """The lead slot's device: the embedding, the head, the residual
        stream and the sums live there."""
        return self.devices[0]

    def init_caches(self, batch: int, max_len: int):
        """Zeroed flat cache lists: entry ``layer * tp + slot`` is slot's
        [batch, max_len, nkv/tp, hd] on its device."""
        per = [shard.init_caches(batch, max_len) for shard in self.shards]
        return _flat([k for k, _ in per]), _flat([v for _, v in per])

    def _sum(self, parts) -> torch.Tensor:
        """Partials added on the lead slot in slot order (float32
        accumulation, then the compute dtype)."""
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.to(self.device).float()
        return acc.to(self.cfg.dtype)

    @staticmethod
    def _on(x, dev):
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    def __call__(self, token_ids, kcaches, vcaches, cache_len):
        tp, dt, lead = self.tp, self.cfg.dtype, self.shards[0]
        if len(kcaches) != self.cfg.num_layers * tp:
            raise ValueError(f"{len(kcaches)} caches for "
                             f"{self.cfg.num_layers} layers x tp={tp}")
        w = lead.embed_tokens.weight
        x = F.embedding(token_ids.clamp(min=0), w).to(dt)
        lens = [self._on(cache_len, d) for d in self.devices]
        for li in range(self.cfg.num_layers):
            x = x + self._sum([
                sh.layers[li].attend(x.to(d), kcaches[li * tp + i],
                                     vcaches[li * tp + i], lens[i])
                for i, (sh, d) in enumerate(zip(self.shards, self.devices))])
            x = x + self._sum([
                sh.layers[li].mlp_out(x.to(d))
                for sh, d in zip(self.shards, self.devices)])
        x = lead.norm(x)
        logits = F.linear(x.to(dt), w.to(dt)).float()
        return logits, kcaches, vcaches


def shard_lm_params(model, mesh: DeviceMesh,
                    tp_axis: str = "tp") -> TensorParallelLM:
    """Place a ``DecoderLM`` onto ``mesh``'s tp slots with the Megatron
    column/row layout (replicated elsewhere), after validating its
    config against the tp degree."""
    validate_tp_config(model.cfg, mesh, tp_axis)
    return TensorParallelLM(model, _tp_slots(mesh, tp_axis))


def lm_cache_sharding(mesh: DeviceMesh, tp_axis: str = "tp"
                      ) -> Tuple[Tuple[torch.device, ...], int]:
    """Where a KV cache [B, Smax, nkv, hd] lives over the tp axis: the
    device of each kv-head shard, in slot order, and the split dimension."""
    return (tuple(s.device for s in _tp_slots(mesh, tp_axis)),
            CACHE_SPLIT_DIM)


def shard_lm_caches(kcaches, vcaches, mesh: DeviceMesh, tp_axis: str = "tp"):
    """Per-layer caches as the flat per-slot lists ``TensorParallelLM``
    takes (the layout of its ``init_caches``): entry ``layer * tp + slot``
    holds the slot's kv heads."""
    devices, dim = lm_cache_sharding(mesh, tp_axis)

    def split(caches):
        return _flat([[c.tensor_split(len(devices), dim)[i].to(d, copy=True)
                       for c in caches] for i, d in enumerate(devices)])

    return split(kcaches), split(vcaches)


def _flat(per_slot):
    """Slot-major per-layer lists ``per_slot[slot][layer]`` as the flat
    list whose entry ``layer * tp + slot`` is that cache."""
    return [c for layer in zip(*per_slot) for c in layer]
