"""The Qwen3 dense decoder (tied embeddings), as the port serves it:
``models/decoder.py`` ``DecoderLM`` behind ``serving/genserver.py``.

A configuration's ``lm`` holds the published ``config.json`` keys
(``hidden_size``, ``num_hidden_layers``, ``num_attention_heads``,
``num_key_value_heads``, ``head_dim``, ``intermediate_size``,
``vocab_size``, ``tie_word_embeddings``, ``rope_theta``,
``rms_norm_eps``, ``initializer_range``, ``torch_dtype``).

* :func:`weights`: the state dict under the port's (HuggingFace's)
  names, made on ``device`` from the seed in one call a kind of weight,
  stored as ``torch_dtype``: projections and the embedding normal with
  ``initializer_range``; RMSNorm scales normal around one
  (:data:`NORM_SD`), so that a scale the program leaves out shows.
* :func:`program`: the port's ``DecoderLM`` over that state (the tensors
  themselves, not copies).
* :func:`reference_logprobs`: the plain forward pass in float32, with no
  cache and no batching, teacher-forced over one sequence: each layer
  ``x + attn(norm(x))`` then ``x + mlp(norm(x))``; attention with
  per-head RMSNorm on q and k before RoPE (rotate-half, angles in
  float64), grouped kv heads, causal softmax over q.k / sqrt(head_dim);
  SwiGLU MLP; the final norm and the tied head. It imports nothing of
  the port, computes in blocks of positions, and with ``control`` runs
  one precision below a bfloat16 configuration: every matmul's inputs,
  weights and activations, rounded through ``float8_e4m3fn`` with a
  scale per row of the contracted axis (amax / 448).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark.harness.gen import make_generator

# Spread of the RMSNorm scales drawn around one (checkpoints' scales are
# not all one; the port's and HuggingFace's initializers set ones).
NORM_SD = 0.1
# Positions a block of the reference's attention and head computes at once.
BLOCK = 512
FP8_MAX = 448.0


def _dims(lm: dict):
    return (lm["num_hidden_layers"], lm["hidden_size"],
            lm["num_attention_heads"], lm["num_key_value_heads"],
            lm["head_dim"], lm["intermediate_size"], lm["vocab_size"])


def weights(lm: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict, from the seed, on ``device``: the same seed and
    device give the same tensors bit for bit."""
    if not lm["tie_word_embeddings"]:
        raise ValueError("qwen3_dense serves tied embeddings only")
    layers, d, nh, nkv, hd, f, v = _dims(lm)
    dt = getattr(torch, lm["torch_dtype"])
    g = make_generator(device, seed, "weights")
    std = lm["initializer_range"]

    def normal(*shape, mean=0.0, sd=std):
        x = torch.randn(shape, generator=g, device=device, dtype=dt)
        return x.mul_(sd).add_(mean)

    state = {"embed_tokens.weight": normal(v, d),
             "norm.weight": normal(d, mean=1.0, sd=NORM_SD)}
    kinds = {
        "self_attn.q_proj.weight": (nh * hd, d),
        "self_attn.k_proj.weight": (nkv * hd, d),
        "self_attn.v_proj.weight": (nkv * hd, d),
        "self_attn.o_proj.weight": (d, nh * hd),
        "mlp.gate_proj.weight": (f, d),
        "mlp.up_proj.weight": (f, d),
        "mlp.down_proj.weight": (d, f),
    }
    norms = {"input_layernorm.weight": d, "post_attention_layernorm.weight": d,
             "self_attn.q_norm.weight": hd, "self_attn.k_norm.weight": hd}
    stacked = {k: normal(layers, *shape) for k, shape in kinds.items()}
    stacked.update({k: normal(layers, n, mean=1.0, sd=NORM_SD)
                    for k, n in norms.items()})
    for i in range(layers):
        for k, w in stacked.items():
            state[f"layers.{i}.{k}"] = w[i]
    return state


def program(lm: dict, state: Dict[str, torch.Tensor], device,
            dtype: str):
    """The port's ``DecoderLM`` computing in ``dtype`` over ``state``."""
    from a_nice_rag_tpu_torch.models.decoder import DecoderLM
    from a_nice_rag_tpu_torch.models.qwen3 import Qwen3Config

    layers, d, nh, nkv, hd, f, v = _dims(lm)
    cfg = Qwen3Config(vocab_size=v, hidden_size=d, num_layers=layers,
                      num_heads=nh, num_kv_heads=nkv, head_dim=hd,
                      intermediate_size=f, rope_theta=float(lm["rope_theta"]),
                      rms_eps=float(lm["rms_norm_eps"]),
                      dtype=getattr(torch, dtype))
    # Built on the device and then given the state: on the meta device
    # the modules' initialisers would import torch._dynamo (seconds).
    with torch.device(device):
        model = DecoderLM(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    if model.device != torch.device(device):
        raise ValueError(f"state on {model.device}, asked for {device}")
    return model.eval()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8_e4m3fn, a scale a row of the last
    axis, back in float32."""
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [S, H, hd]; cos, sin [S, hd / 2]: HuggingFace's rotate_half."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


@torch.no_grad()
def reference_logprobs(lm: dict, state: Dict[str, torch.Tensor],
                       ids: torch.Tensor, control: bool = False,
                       last: Optional[int] = None) -> torch.Tensor:
    """float32 log-softmax [rows, vocab] of a teacher-forced forward over
    ``ids`` [S] (on the state's device): the rows of the last ``last``
    positions (all S by default); row j is the distribution of the token
    after position S - rows + j."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, d, nh, nkv, hd, f, v = _dims(lm)
    eps = float(lm["rms_norm_eps"])
    rnd = _fp8 if control else (lambda t: t)

    def w(name):
        return rnd(state[name].float())

    def mm(x, name):
        return rnd(x) @ w(name).T

    s_len = ids.shape[0]
    rows = s_len if last is None else int(last)
    dev = ids.device
    half = hd // 2
    inv = 1.0 / (float(lm["rope_theta"]) ** (
        torch.arange(half, dtype=torch.float64, device=dev) / half))
    ang = torch.arange(s_len, dtype=torch.float64, device=dev)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x = state["embed_tokens.weight"][ids].float()
    for i in range(layers):
        p = f"layers.{i}."
        h = _rms(x, state[p + "input_layernorm.weight"], eps)
        q = mm(h, p + "self_attn.q_proj.weight").view(s_len, nh, hd)
        k = mm(h, p + "self_attn.k_proj.weight").view(s_len, nkv, hd)
        vv = mm(h, p + "self_attn.v_proj.weight").view(s_len, nkv, hd)
        q = _rope(_rms(q, state[p + "self_attn.q_norm.weight"], eps), cos,
                  sin)
        k = _rope(_rms(k, state[p + "self_attn.k_norm.weight"], eps), cos,
                  sin)
        out = torch.empty(s_len, nh * hd, device=dev)
        kr, vt = rnd(k), rnd(vv.permute(1, 2, 0)).permute(2, 0, 1)
        for a in range(0, s_len, BLOCK):
            b = min(a + BLOCK, s_len)
            qb = rnd(q[a:b]).view(b - a, nkv, nh // nkv, hd)
            sc = torch.einsum("bnrd,knd->nrbk", qb, kr[:b]) / math.sqrt(hd)
            causal = torch.arange(b, device=dev)[None, :] \
                <= torch.arange(a, b, device=dev)[:, None]
            sc = sc.masked_fill(~causal, -math.inf)
            pr = rnd(torch.softmax(sc, dim=-1))
            out[a:b] = torch.einsum("nrbk,knd->bnrd", pr, vt[:b]).reshape(
                b - a, nh * hd)
        x = x + mm(out, p + "self_attn.o_proj.weight")
        h = _rms(x, state[p + "post_attention_layernorm.weight"], eps)
        act = torch.nn.functional.silu(mm(h, p + "mlp.gate_proj.weight")) \
            * mm(h, p + "mlp.up_proj.weight")
        x = x + mm(act, p + "mlp.down_proj.weight")
    x = rnd(_rms(x[s_len - rows:], state["norm.weight"], eps))
    head = w("embed_tokens.weight")
    out = torch.empty(rows, v, device=dev)
    for a in range(0, rows, BLOCK):
        out[a:a + BLOCK] = torch.log_softmax(x[a:a + BLOCK] @ head.T, dim=-1)
    return out
