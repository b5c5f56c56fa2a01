"""The JAX package's model weights as this package's state dicts.

Each function takes a flax params tree (nested dicts of numpy arrays,
with or without the outer ``"params"`` key; ``jax.device_get`` of the
JAX package's params) and returns the ``state_dict`` of the port's
module. Flax names come from creation order inside each ``nn.compact``
call; a flax ``kernel`` is [in, out] and ``nn.Linear.weight`` [out, in].
The tensors stay float32, as flax keeps them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device

StateDict = Dict[str, torch.Tensor]
# Block_i's submodules in creation order: attention_sublayer's RMSNorm,
# qkv and output projections, then the MLP's norm, gate, up and down.
_BLOCK = {"RMSNorm_0": "attn_norm", "Dense_0": "qkv", "Dense_1": "proj",
          "RMSNorm_1": "mlp_norm", "Dense_2": "gate", "Dense_3": "up",
          "Dense_4": "down"}
_QWEN3_LAYER = {
    "input_norm": "input_layernorm", "q_proj": "self_attn.q_proj",
    "k_proj": "self_attn.k_proj", "v_proj": "self_attn.v_proj",
    "q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm",
    "o_proj": "self_attn.o_proj", "post_attn_norm": "post_attention_layernorm",
    "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
}


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(np.asarray(a, np.float32)))


def _module(p: Mapping, name: str, norm_key: str = "scale") -> StateDict:
    """One flax module's leaves under the port's parameter names."""
    out = {}
    if "kernel" in p:
        out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])
    if "scale" in p:
        out[f"{name}.{norm_key}"] = _t(p["scale"])
    if "embedding" in p:
        out[f"{name}.weight"] = _t(p["embedding"])
    return out


def _tree(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _trunk(p: Mapping) -> StateDict:
    """Embed_0, Block_i and the final RMSNorm_0 (encoder and reranker)."""
    sd = _module(p["Embed_0"], "embed")
    i = 0
    while f"Block_{i}" in p:
        for flax_name, name in _BLOCK.items():
            sd.update(_module(p[f"Block_{i}"][flax_name], f"blocks.{i}.{name}"))
        i += 1
    sd.update(_module(p["RMSNorm_0"], "norm"))
    return sd


def encoder_state_from_flax(params: Mapping) -> StateDict:
    """``TransformerEncoder`` params -> ``models.encoder.TransformerEncoder``
    state dict (``Dense_0`` is the output projection)."""
    p = _tree(params)
    sd = _trunk(p)
    sd.update(_module(p["Dense_0"], "out"))
    return sd


def moe_state_from_flax(params: Mapping) -> StateDict:
    """``MoETransformerEncoder`` params -> ``models.moe``'s state dict:
    ``MoEBlock_i`` holds the block's norms and projections under the
    encoder Block's flax names and ``MoEFFN_0`` (``router``, and the
    stacked ``w_gate``/``w_up``/``w_out``, the same in both layouts)."""
    p = _tree(params)
    sd = _module(p["Embed_0"], "embed")
    i = 0
    while f"MoEBlock_{i}" in p:
        blk, pre = p[f"MoEBlock_{i}"], f"blocks.{i}."
        for flax_name in ("RMSNorm_0", "Dense_0", "Dense_1", "RMSNorm_1"):
            sd.update(_module(blk[flax_name], pre + _BLOCK[flax_name]))
        ffn = blk["MoEFFN_0"]
        sd.update(_module(ffn["router"], pre + "ffn.router"))
        for w in ("w_gate", "w_up", "w_out"):
            sd[pre + "ffn." + w] = _t(ffn[w])
        i += 1
    sd.update(_module(p["RMSNorm_0"], "norm"))
    sd.update(_module(p["Dense_0"], "out"))
    return sd


def reranker_state_from_flax(params: Mapping) -> StateDict:
    """``CrossEncoderReranker`` params -> the port's: the trunk, the head
    (``Dense_0``, with a bias) and, with match features, ``match_proj``."""
    p = _tree(params)
    sd = _trunk(p)
    sd.update(_module(p["Dense_0"], "head"))
    if "match_proj" in p:
        sd.update(_module(p["match_proj"], "match_proj"))
    return sd


def qwen3_state_from_flax(params: Mapping) -> StateDict:
    """``Qwen3Encoder`` params -> ``models.qwen3.Qwen3Encoder`` state dict
    (HuggingFace's names)."""
    p = _tree(params)
    sd = _module(p["embed"], "embed_tokens")
    sd.update(_module(p["final_norm"], "norm", "weight"))
    i = 0
    while f"layer_{i}" in p:
        for flax_name, name in _QWEN3_LAYER.items():
            sd.update(_module(p[f"layer_{i}"][flax_name],
                              f"layers.{i}.{name}", "weight"))
        i += 1
    return sd


def adamw_state_from_optax(opt_state, to_state_dict=encoder_state_from_flax
                           ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An ``optax.adamw`` state (its ``ScaleByAdamState(count, mu, nu)``,
    ``jax.device_get`` of it) as AdamW's per-parameter state under the
    port's names: ``step`` the count, ``exp_avg`` and ``exp_avg_sq`` the
    moments, converted (flax kernels transposed) by ``to_state_dict``, the
    converter of the matching params (``train.load_adamw_state`` sets
    them on an optimizer)."""

    def find(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s
        if isinstance(s, (tuple, list)):
            for x in s:
                hit = find(x)
                if hit is not None:
                    return hit
        return None

    adam = find(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the state")
    mu, nu = to_state_dict(adam.mu), to_state_dict(adam.nu)
    step = int(np.asarray(adam.count))
    return {name: {"step": step, "exp_avg": mu[name],
                   "exp_avg_sq": nu[name]} for name in mu}


def decoder_state_dict(params: Mapping) -> StateDict:
    """The JAX package's ``DecoderLM`` params -> ``models.decoder.DecoderLM``
    state dict. Its tree (``embed``, ``layer_i/{input_norm, q_proj, ...,
    down_proj}``, ``final_norm``) is the Qwen3 encoder's, and so are the
    port's names (HuggingFace's); the tied head has no weight of its
    own."""
    return qwen3_state_from_flax(params)


def load_decoder_state(cfg, state_dict: Mapping, device: DeviceLike = "cuda",
                       param_dtype: torch.dtype = torch.float32):
    """A ``DecoderLM`` on ``device`` holding ``state_dict`` (the port's
    names, or a HuggingFace ``Qwen3ForCausalLM``'s: ``lm_head`` is dropped,
    the head is tied to the embedding) stored as ``param_dtype``."""
    from a_nice_rag_tpu_torch.models.decoder import DecoderLM
    from a_nice_rag_tpu_torch.models.qwen3 import convert_hf_qwen3

    dev = resolve_device(device)
    with torch.device("meta"):
        model = DecoderLM(cfg)
    model.load_state_dict({k: v.to(dev, param_dtype) for k, v in
                           convert_hf_qwen3(state_dict, cfg).items()},
                          assign=True)
    return model.eval()


def load_decoder_checkpoint_dir(
    path: str, dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = "cuda", param_dtype: Optional[torch.dtype] = None,
) -> Tuple[object, object]:
    """A ``Qwen3ForCausalLM`` checkpoint directory (``config.json`` plus
    ``*.safetensors``) as (cfg with compute dtype ``dtype``, the
    ``DecoderLM`` on ``device`` with the head tied to the embedding),
    without transformers. Weights are stored as ``param_dtype``
    (``dtype`` unless given)."""
    from a_nice_rag_tpu_torch.models.qwen3 import (
        Qwen3Config,
        read_checkpoint_dir,
    )

    hf_cfg, state_dict = read_checkpoint_dir(path)
    cfg = Qwen3Config.from_hf(hf_cfg, dtype=dtype)
    return cfg, load_decoder_state(cfg, state_dict, device,
                                   param_dtype or dtype)
