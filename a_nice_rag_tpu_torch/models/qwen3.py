"""Qwen3 encoder + HuggingFace weight import (the port of the JAX
package's ``models/qwen3.py``).

The reference serves precomputed ``Qwen3-Embedding-0.6B`` vectors as one
of its four dense retrieval models (SURVEY.md §2.1; reference
src/query_rag_retrieval.py:38-111). This module runs that model family on
the card: the Qwen3 decoder stack (GQA, decoupled head_dim, per-head q/k
RMSNorm, rope_theta from config, SwiGLU MLP, causal attention) with
last-token pooling and L2 normalization as the Qwen3-Embedding models use
them.

The numerics are the JAX module's: projections in ``cfg.dtype`` from
weights cast at use, RMSNorm in float32 (the scale applied before the
cast back), RoPE angles in float32, attention scores accumulated in
float32 and masked with -1e30, softmax in float32, pooling in float32.
The module's parameter names are HuggingFace's (``embed_tokens``,
``layers.N.self_attn.q_proj``, ...), so a ``Qwen3Model`` state dict loads
as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device
from a_nice_rag_tpu_torch.models.encoder import (
    _rope,
    dense,
    masked_mean,
    materialize,
)

POOLS = ("last", "mean", "none")


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @classmethod
    def from_hf(cls, hf_config, dtype=torch.float32) -> "Qwen3Config":
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            head_dim=getattr(hf_config, "head_dim", None)
            or hf_config.hidden_size // hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            rope_theta=hf_config.rope_theta,
            rms_eps=hf_config.rms_norm_eps,
            dtype=dtype,
        )


class _RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: Qwen3Config):
        super().__init__()
        hd, d = cfg.head_dim, cfg.hidden_size
        self.q_proj = nn.Linear(d, cfg.num_heads * hd, bias=False)
        self.k_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * hd, d, bias=False)
        self.q_norm = _RMSNorm(hd, cfg.rms_eps)
        self.k_norm = _RMSNorm(hd, cfg.rms_eps)


class _MLP(nn.Module):
    def __init__(self, cfg: Qwen3Config):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, f, bias=False)
        self.up_proj = nn.Linear(d, f, bias=False)
        self.down_proj = nn.Linear(f, d, bias=False)


class _Qwen3Block(nn.Module):
    def __init__(self, cfg: Qwen3Config):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = _Attention(cfg)
        self.post_attention_layernorm = _RMSNorm(cfg.hidden_size,
                                                 cfg.rms_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x, keep, positions):
        """``keep``: [B, S(q), S(k)] causal & padding mask."""
        cfg, a, m = self.cfg, self.self_attn, self.mlp
        hd, nh, nkv, dt = (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                           cfg.dtype)
        b, s, _ = x.shape
        h = self.input_layernorm(x)
        q = dense(a.q_proj, h, dt).reshape(b, s, nh, hd)
        k = dense(a.k_proj, h, dt).reshape(b, s, nkv, hd)
        v = dense(a.v_proj, h, dt).reshape(b, s, nkv, hd)
        # Qwen3's per-head RMSNorm on q/k, applied BEFORE RoPE.
        q = _rope(a.q_norm(q), positions, cfg.rope_theta)
        k = _rope(a.k_norm(k), positions, cfg.rope_theta)
        # GQA: every kv head serves nh // nkv query heads. The group axis
        # folds into the query side, so k/v are never repeated.
        qg = q.reshape(b, s, nkv, nh // nkv, hd)
        attn = torch.einsum("bsnrd,bknd->bnrsk", qg.float(), k.float()) \
            / math.sqrt(hd)
        attn = torch.where(keep[:, None, None], attn, -1e30)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.einsum("bnrsk,bknd->bsnrd", attn, v).reshape(
            b, s, nh * hd)
        x = x + dense(a.o_proj, out, dt)
        h = self.post_attention_layernorm(x)
        act = F.silu(dense(m.gate_proj, h, dt)) * dense(m.up_proj, h, dt)
        return x + dense(m.down_proj, act, dt)


class Qwen3Encoder(nn.Module):
    """Qwen3 decoder stack as an embedding encoder.

    pool: "last" (Qwen3-Embedding convention: the final non-padded
    token's hidden state), "mean" (masked mean), or "none" (full
    [B, S, H] hidden states in ``cfg.dtype``). normalize L2-normalizes
    pooled outputs. Token ids below 0 are padding unless ``mask`` is
    given."""

    def __init__(self, cfg: Qwen3Config, pool: str = "last",
                 normalize: bool = True):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
        self.cfg, self.pool, self.normalize = cfg, pool, normalize
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            _Qwen3Block(cfg) for _ in range(cfg.num_layers))
        self.norm = _RMSNorm(cfg.hidden_size, cfg.rms_eps)

    def forward(self, token_ids, mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        mask = token_ids >= 0 if mask is None else mask.bool()
        token_ids = token_ids.clamp(min=0)
        x = F.embedding(token_ids, self.embed_tokens.weight).to(cfg.dtype)
        # Mask-aware positions: left- and right-padding both get
        # contiguous positions over the real tokens.
        positions = (torch.cumsum(mask.int(), dim=-1) - 1).clamp(min=0)
        s = token_ids.shape[1]
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=token_ids.device).tril()
        keep = causal[None] & mask[:, None, :]
        for layer in self.layers:
            x = layer(x, keep, positions)
        x = self.norm(x)
        if self.pool == "none":
            return x
        if self.pool == "mean":
            pooled = masked_mean(x, mask)
        else:  # the last non-padded token (left- or right-padding)
            last_col = s - 1 - torch.argmax(mask.flip(-1).int(), dim=-1)
            pooled = x.float()[torch.arange(x.shape[0],
                                            device=x.device), last_col]
        if self.normalize:
            pooled = pooled / torch.linalg.norm(
                pooled, dim=-1, keepdim=True).clamp(min=1e-6)
        return pooled


def init_qwen3(cfg: Qwen3Config, seed: int = 0, device: DeviceLike = "cuda",
               param_dtype: torch.dtype = torch.float32,
               pool: str = "last") -> Qwen3Encoder:
    """A ``Qwen3Encoder`` with seeded random weights on ``device`` (the
    card unless asked otherwise), stored as ``param_dtype``: every
    projection and the embedding normal(0, 0.02), HuggingFace's
    ``initializer_range``; norms one."""
    return materialize(lambda: Qwen3Encoder(cfg, pool), device,
                       seed, lambda shape: 0.02, param_dtype)


def _state_keys(cfg: Qwen3Config):
    with torch.device("meta"):
        return list(Qwen3Encoder(cfg).state_dict())


def convert_hf_qwen3(state_dict: Dict[str, Any],
                     cfg: Qwen3Config) -> Dict[str, torch.Tensor]:
    """Map a HuggingFace ``Qwen3Model`` (keys ``layers.N...``) or
    ``Qwen3ForCausalLM`` (keys ``model.layers.N...``) state dict to this
    module's state dict: the same names without the prefix (torch Linear
    weights are [out, in] on both sides). Numpy arrays are taken too;
    ``lm_head`` and other keys the encoder has no use for are dropped."""
    out = {}
    for key in _state_keys(cfg):
        for prefix in ("", "model."):
            if prefix + key in state_dict:
                out[key] = torch.as_tensor(state_dict[prefix + key])
                break
        else:
            raise KeyError(key)
    return out


def load_qwen3_state(cfg: Qwen3Config, state_dict,
                     device: DeviceLike = "cuda",
                     pool: str = "last") -> Qwen3Encoder:
    """A ``Qwen3Encoder`` on ``device`` holding ``state_dict`` (this
    module's names, or a HuggingFace model's: see ``convert_hf_qwen3``)
    as float32 master weights, as the JAX package keeps them."""
    dev = resolve_device(device)
    with torch.device("meta"):
        enc = Qwen3Encoder(cfg, pool)
    enc.load_state_dict({k: v.to(dev, torch.float32) for k, v in
                         convert_hf_qwen3(state_dict, cfg).items()},
                        assign=True)
    return enc.eval()


def load_qwen3_checkpoint_dir(
    path: str,
    dtype: torch.dtype = torch.bfloat16,
    pool: str = "last",
    device: DeviceLike = "cuda",
) -> Tuple[Qwen3Config, Qwen3Encoder]:
    """Load a Qwen3 checkpoint directory without transformers.

    ``path`` is a HF-format directory: ``config.json`` plus one or more
    ``*.safetensors`` weight files (a sharded checkpoint's shards are all
    read). Returns (cfg with compute dtype ``dtype``, the encoder on
    ``device`` with the checkpoint's weights as float32).
    """
    hf_cfg, state_dict = read_checkpoint_dir(path)
    cfg = Qwen3Config.from_hf(hf_cfg, dtype=dtype)
    return cfg, load_qwen3_state(cfg, state_dict, device, pool)


def read_checkpoint_dir(path: str):
    """A HF-format directory's ``config.json`` (as a namespace) and the
    tensors of all its ``*.safetensors`` shards, on the CPU."""
    import glob
    import json
    import os
    from types import SimpleNamespace

    from safetensors.torch import load_file

    with open(os.path.join(path, "config.json"), "r", encoding="utf-8") as f:
        hf_cfg = SimpleNamespace(**json.load(f))
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    state_dict: Dict[str, torch.Tensor] = {}
    for shard in shards:
        state_dict.update(load_file(shard))
    return hf_cfg, state_dict


def load_hf_qwen3_encoder(
    name: str = "Qwen/Qwen3-Embedding-0.6B",
    dtype: torch.dtype = torch.bfloat16,
    pool: str = "last",
    device: DeviceLike = "cuda",
) -> Tuple[Any, Qwen3Encoder]:
    """Load a cached HF Qwen3 checkpoint for on-device inference: returns
    (tokenizer, encoder). Requires the model in the local HF cache
    (hermetic environments cannot download)."""
    from transformers import AutoConfig, AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
    hf_cfg = AutoConfig.from_pretrained(name, local_files_only=True)
    model = AutoModel.from_pretrained(name, local_files_only=True)
    cfg = Qwen3Config.from_hf(hf_cfg, dtype=dtype)
    return tok, load_qwen3_state(cfg, model.state_dict(), device, pool)
