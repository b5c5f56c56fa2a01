"""Transformer embedding encoder (the port of the JAX package's
``models/encoder.py``).

A compact Qwen3-embedding-style architecture: token embedding, rotary
position encoding, pre-RMSNorm attention/SwiGLU blocks, masked mean
pooling, and L2 normalization, so its outputs plug directly into the
dense index (unit-norm dot product = cosine).

The numerics follow the JAX module step by step. Master weights stay
float32 and each projection casts its input and weight to
``cfg.dtype`` (bfloat16 by default) as flax's ``Dense(dtype=...)`` does;
the residual stream is ``cfg.dtype``; an RMSNorm returns float32 (its
``cfg.dtype`` product times the float32 scale, as JAX promotes it);
attention scores accumulate in float32, masked with -1e30 (so a row with
no valid key gets a uniform softmax and an empty text a zero embedding,
never NaN), and the softmax runs in float32; pooling and the output
projection run in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 512
    out_dim: int = 256
    dtype: torch.dtype = torch.bfloat16


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """flax ``Dense(dtype=dtype)``: input, weight and bias cast to the
    compute dtype, the stored weights left as they are."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the last dim, HF's rotate_half
    convention (the two halves): angles and products in float32 (x
    promotes), the result cast back to x's dtype. x: [B, S, H, D],
    positions [B, S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rms_norm(x, scale):
    """The encoder's RMSNorm of x with a float32 ``scale``."""
    var = x.float().square().mean(-1, keepdim=True)
    # x * rsqrt promotes to float32, is cast back to x's dtype, and the
    # float32 scale promotes the product again: float32 out.
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, self.scale)


def split_heads(cfg, qkv, positions):
    """A qkv projection [B, S, 3 dim] as rotated q, k and v [B, S, H, D]."""
    head_dim = cfg.dim // cfg.n_heads
    q, k, v = qkv.chunk(3, dim=-1)
    b, s, _ = q.shape
    q = _rope(q.reshape(b, s, cfg.n_heads, head_dim), positions)
    k = _rope(k.reshape(b, s, cfg.n_heads, head_dim), positions)
    return q, k, v.reshape(b, s, cfg.n_heads, head_dim)


def attend(cfg, q, k, v, mask):
    """Softmax attention of q [B, Sq, H, D] over k, v [B, Sk, H, D] with
    the keys masked by ``mask`` [B, Sk]: [B, Sq, H D] in ``cfg.dtype``."""
    b, s = q.shape[:2]
    attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    attn = torch.where(mask[:, None, None, :], attn, -1e30)
    attn = torch.softmax(attn, dim=-1).to(cfg.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, s, cfg.dim)


def attention_sublayer(cfg: EncoderConfig, norm: RMSNorm, qkv: nn.Linear,
                       proj: nn.Linear, x, mask, positions):
    """Pre-norm multi-head attention + residual (shared by the encoder's
    Block and the cross-encoder's)."""
    q, k, v = split_heads(cfg, dense(qkv, norm(x), cfg.dtype), positions)
    return x + dense(proj, attend(cfg, q, k, v, mask), cfg.dtype)


def masked_mean(x, mask):
    """Mean of x (in float32) over the valid positions; zero for a row
    with none."""
    w = mask.float()[:, :, None]
    return (x.float() * w).sum(1) / w.sum(1).clamp(min=1.0)


def unit_rows(o):
    """Rows scaled to unit L2 norm (norms clipped at 1e-6)."""
    return o / torch.linalg.norm(o, dim=-1, keepdim=True).clamp(min=1e-6)


def pooled_projection(norm: RMSNorm, out: nn.Linear, x, mask):
    """Final RMSNorm + masked mean pool + float32 projection + L2
    normalize."""
    return unit_rows(dense(out, masked_mean(norm(x), mask), torch.float32))


class Block(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d, f = cfg.dim, cfg.mlp_ratio * cfg.dim
        self.cfg = cfg
        self.attn_norm = RMSNorm(d)
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.proj = nn.Linear(d, d, bias=False)
        self.mlp_norm = RMSNorm(d)
        self.gate = nn.Linear(d, f, bias=False)
        self.up = nn.Linear(d, f, bias=False)
        self.down = nn.Linear(f, d, bias=False)

    def forward(self, x, mask, positions):
        dt = self.cfg.dtype
        x = attention_sublayer(self.cfg, self.attn_norm, self.qkv,
                               self.proj, x, mask, positions)
        h = self.mlp_norm(x)
        h = F.silu(dense(self.gate, h, dt)) * dense(self.up, h, dt)
        return x + dense(self.down, h, dt)


def positions_of(mask):
    """Positions over the valid tokens: cumsum(mask) - 1."""
    return torch.cumsum(mask.int(), dim=-1) - 1


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim)
        self.out = nn.Linear(cfg.dim, cfg.out_dim, bias=False)

    def forward(self, token_ids, mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = token_ids > 0
        x = F.embedding(token_ids, self.embed.weight).to(self.cfg.dtype)
        positions = positions_of(mask)
        for blk in self.blocks:
            x = blk(x, mask, positions)
        return pooled_projection(self.norm, self.out, x, mask)


def materialize(make, device: DeviceLike, seed: int, std_of,
                param_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None):
    """Build ``make()`` on the meta device, allocate it on ``device`` and
    fill it from a seeded generator on that device: norms with ones,
    biases with zeros, every other weight normal with standard deviation
    ``std_of(shape)``. The global RNG is untouched."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=dev).to(param_dtype)
    g = generator or torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std_of(p.shape), generator=g)
    return model.eval()


def flax_like_std(shape) -> float:
    """The scales of flax's initializers: an embedding 1/sqrt(dim), a
    Dense kernel 1/sqrt(fan_in) (lecun normal; normal here, not
    truncated)."""
    return 1.0 / math.sqrt(shape[1])


def init_encoder(cfg: EncoderConfig, seed: int = 0,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None
                 ) -> TransformerEncoder:
    """A ``TransformerEncoder`` with seeded random float32 weights on
    ``device`` (the card unless asked otherwise). The draws differ from
    flax's ``PRNGKey`` init; the JAX package's weights come across
    through ``models.convert``."""
    return materialize(lambda: TransformerEncoder(cfg), device, seed,
                       flax_like_std, generator=generator)


def load_hf_encoder(name: str = "Qwen/Qwen3-Embedding-0.6B",
                    device: DeviceLike = "cuda"):
    """Load a HuggingFace Qwen3 embedding model for on-device inference:
    (tokenizer, ``models.qwen3.Qwen3Encoder`` with the checkpoint's
    weights). Requires the model files in the local HF cache (hermetic
    environments cannot download); raises with guidance otherwise."""
    resolve_device(device)
    try:
        from a_nice_rag_tpu_torch.models.qwen3 import load_hf_qwen3_encoder

        return load_hf_qwen3_encoder(name, device=device)
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            f"HF model {name} is not in the local cache; pre-download it "
            "or use the native TransformerEncoder with trained weights"
        ) from e
