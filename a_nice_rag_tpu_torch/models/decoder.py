"""Decoder-only LM with KV-cache autoregressive decoding (the port of the
JAX package's ``models/decoder.py``).

The reference routes ALL generation to SaaS chat APIs
(reference src/query_rag.py:434-513); this module closes that hop the way
models/embedder.py did for query embedding: a Qwen3-architecture causal
LM (the blocks of models/qwen3.py under HuggingFace's parameter names, so
a ``Qwen3ForCausalLM`` checkpoint with tied embeddings loads as it is)
with

* one forward for prefill and per-token decode: every call writes its
  keys/values into a fixed-size cache at ``cache_len`` and attends over
  the whole cache row with a causal mask;
* a byte-level reversible tokenizer (no external vocab files);
* ``generate_stream`` (greedy or temperature / top-k / top-p sampling),
  ``generate_batch`` over ragged prompts and ``generate_text_stream``
  yielding UTF-8-safe text deltas for the RAG streaming contract.

The numerics are the JAX module's: projections in ``cfg.dtype``, RMSNorm
and RoPE in float32, attention scores accumulated in float32, divided by
sqrt(head_dim), masked with -1e30 and softmaxed in float32, the tied
logits ``x @ embed.T`` in ``cfg.dtype`` then float32. A cache write
clamps its start to ``[0, Smax - s]`` as ``lax.dynamic_update_slice``
does. Sampling draws Gumbel noise from a ``torch.Generator`` (or takes
the noise as a tensor): ``argmax(logits + gumbel)`` is
``jax.random.categorical``, so under the JAX package's own draws the
port chooses the same tokens; its own streams differ from the JAX
package's sampled streams, its greedy streams do not.

A decode chunk enqueues its ``chunk`` steps with no host read: tokens,
positions and the finished flags stay on the device, and the caller
downloads the ``[chunk, B]`` block once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Generator, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from a_nice_rag_tpu_torch.device import DeviceLike
from a_nice_rag_tpu_torch.models.encoder import (
    _rope,
    dense,
    flax_like_std,
    materialize,
)
from a_nice_rag_tpu_torch.models.qwen3 import (
    Qwen3Config,
    _MLP,
    _Attention,
    _RMSNorm,
)

BOS, EOS, PAD = 256, 257, 258
BYTE_VOCAB = 259
# A sampling decision's randomness: a generator to draw Gumbel noise from,
# or the noise itself ([B, V] float32).
Key = Union[torch.Generator, torch.Tensor]


class ByteTokenizer:
    """Reversible byte-level tokenizer: ids 0-255 are raw bytes, plus
    BOS/EOS/PAD specials. Streaming-safe decode via ``ByteDecoder``."""

    vocab_size = BYTE_VOCAB
    bos_id, eos_id, pad_id = BOS, EOS, PAD

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([BOS] if add_bos else []) + ids

    def decode(self, ids) -> str:
        data = bytes(int(i) for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def stream_decoder(self) -> "ByteDecoder":
        """Incremental decoder for this vocabulary (duck-typed with
        models/hf_tokenizer.HFTokenizer.stream_decoder)."""
        return ByteDecoder()


class ByteDecoder:
    """Incremental UTF-8 decoder: feed token ids, get back only the
    text that is complete so far (multi-byte codepoints buffer until
    their continuation bytes arrive)."""

    def __init__(self):
        self._buf = b""

    def feed(self, token_id: int) -> str:
        if not (0 <= token_id < 256):
            return ""
        self._buf += bytes([token_id])
        try:
            out = self._buf.decode("utf-8")
            self._buf = b""
            return out
        except UnicodeDecodeError:
            if len(self._buf) >= 4:  # invalid sequence, flush lossily
                out = self._buf.decode("utf-8", errors="replace")
                self._buf = b""
                return out
            return ""

    def flush(self) -> str:
        out = self._buf.decode("utf-8", errors="replace")
        self._buf = b""
        return out


def write_cache(cache: torch.Tensor, upd: torch.Tensor, cache_len) -> None:
    """Write ``upd`` [B, s, ...] into ``cache`` [B, Smax, ...] at
    ``cache_len`` (an int, or a [B] tensor of per-row offsets), in place.
    The start clamps to ``[0, Smax - s]`` as ``lax.dynamic_update_slice``
    clamps it: a frozen row pinned near the end of its row writes inside
    it, never past it."""
    b, s = upd.shape[:2]
    hi = cache.shape[1] - s
    upd = upd.to(cache.dtype)
    if isinstance(cache_len, int):
        start = min(max(cache_len, 0), hi)
        cache[:, start:start + s] = upd
        return
    start = cache_len.clamp(0, hi)
    cols = start[:, None] + torch.arange(s, device=cache.device)[None, :]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, s)
    cache[rows, cols] = upd


class _CachedBlock(nn.Module):
    """Qwen3 block over a KV cache window.

    ``x`` holds s new tokens at absolute positions
    ``cache_len .. cache_len+s-1``; their keys/values are written into the
    [B, Smax, nkv, hd] caches in place and attention runs over the whole
    cache row with a causal mask. With ``cache_len=0`` and ``s=Smax`` this
    is exactly the full causal forward of models/qwen3._Qwen3Block.

    ``cache_len`` may be an int (all rows at the same offset — the single
    stream) or a [B] tensor (each row at its own offset — the batched /
    continuous-batching path)."""

    def __init__(self, cfg: Qwen3Config):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = _RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = _Attention(cfg)
        self.post_attention_layernorm = _RMSNorm(cfg.hidden_size,
                                                 cfg.rms_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x, kcache, vcache, cache_len):
        x = x + self.attend(x, kcache, vcache, cache_len)
        return x + self.mlp_out(x)

    def attend(self, x, kcache, vcache, cache_len):
        """The attention sublayer's output before the residual add (a
        tensor-parallel slot's partial sum, parallel/lm.py)."""
        cfg, a = self.cfg, self.self_attn
        hd, nh, nkv, dt = (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                           cfg.dtype)
        b, s, _ = x.shape
        smax = kcache.shape[1]
        steps = torch.arange(s, device=x.device)
        if isinstance(cache_len, int):
            q_pos = (cache_len + steps)[None, :]  # [1, s]
        else:
            q_pos = cache_len[:, None] + steps[None, :]  # [B, s]
        positions = q_pos.expand(b, s)

        h = self.input_layernorm(x)
        q = dense(a.q_proj, h, dt).reshape(b, s, nh, hd)
        k = dense(a.k_proj, h, dt).reshape(b, s, nkv, hd)
        v = dense(a.v_proj, h, dt).reshape(b, s, nkv, hd)
        q = _rope(a.q_norm(q), positions, cfg.rope_theta)
        k = _rope(a.k_norm(k), positions, cfg.rope_theta)
        write_cache(kcache, k, cache_len)
        write_cache(vcache, v, cache_len)
        # Grouped-query attention without repeating the cache: the group
        # axis folds into the query, so each step contracts against the
        # stored [B, Smax, nkv, hd] layout directly.
        qg = q.reshape(b, s, nkv, nh // nkv, hd)
        attn = torch.einsum("bsnrd,bknd->bnrsk", qg.float(),
                            kcache.float()) / math.sqrt(hd)
        key_pos = torch.arange(smax, device=x.device)
        # The query at absolute position cache_len + qi sees keys <= it.
        keep = key_pos[None, None, :] <= q_pos[:, :, None]  # [B|1, s, Smax]
        attn = torch.where(keep[:, None, None], attn, -1e30)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.einsum("bnrsk,bknd->bsnrd", attn, vcache).reshape(
            b, s, nh * hd)
        return dense(a.o_proj, out, dt)

    def mlp_out(self, x):
        """The MLP sublayer's output before the residual add."""
        m, dt = self.mlp, self.cfg.dtype
        h = self.post_attention_layernorm(x)
        act = F.silu(dense(m.gate_proj, h, dt)) * dense(m.up_proj, h, dt)
        return dense(m.down_proj, act, dt)


class DecoderLM(nn.Module):
    """Causal LM head over the cached Qwen3 stack (tied embeddings)."""

    def __init__(self, cfg: Qwen3Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            _CachedBlock(cfg) for _ in range(cfg.num_layers))
        self.norm = _RMSNorm(cfg.hidden_size, cfg.rms_eps)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def init_caches(self, batch: int, max_len: int):
        """Zeroed per-layer caches on the model's device."""
        return init_caches(self.cfg, batch, max_len, self.device)

    def forward(self, token_ids, kcaches, vcaches, cache_len):
        """token_ids [B, s]; kcaches/vcaches lists of per-layer
        [B, Smax, nkv, hd], written in place; cache_len an int or [B].
        Returns (logits [B, s, V] float32, kcaches, vcaches)."""
        dt = self.cfg.dtype
        w = self.embed_tokens.weight
        x = F.embedding(token_ids.clamp(min=0), w).to(dt)
        for layer, kc, vc in zip(self.layers, kcaches, vcaches):
            x = layer(x, kc, vc, cache_len)
        x = self.norm(x)
        logits = F.linear(x.to(dt), w.to(dt)).float()
        return logits, kcaches, vcaches


def small_lm_config(**overrides) -> Qwen3Config:
    base = dict(
        vocab_size=BYTE_VOCAB, hidden_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        rms_eps=1e-6, rope_theta=10000.0, dtype=torch.float32,
    )
    base.update(overrides)
    fields = {f.name for f in dataclasses.fields(Qwen3Config)}
    return Qwen3Config(**{k: v for k, v in base.items() if k in fields})


def init_caches(cfg: Qwen3Config, batch: int, max_len: int,
                device: DeviceLike = "cuda"):
    """Zeroed per-layer [batch, max_len, nkv, hd] caches in ``cfg.dtype``
    (zeros, never uninitialized memory: a masked key still meets a zero
    attention weight, and 0 * NaN would not be zero)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    k = [torch.zeros(shape, dtype=cfg.dtype, device=device)
         for _ in range(cfg.num_layers)]
    v = [torch.zeros(shape, dtype=cfg.dtype, device=device)
         for _ in range(cfg.num_layers)]
    return k, v


def init_decoder(cfg: Qwen3Config, seed: int = 0,
                 device: DeviceLike = "cuda",
                 param_dtype: torch.dtype = torch.float32) -> DecoderLM:
    """A ``DecoderLM`` with seeded random weights on ``device`` (the card
    unless asked otherwise), stored as ``param_dtype``, at flax's scales
    (embedding 1/sqrt(hidden), projections 1/sqrt(fan_in); norms one).
    The draws differ from flax's; the JAX package's weights come across
    through ``models.convert.decoder_state_dict``."""
    return materialize(lambda: DecoderLM(cfg), device, seed, flax_like_std,
                       param_dtype)


def lm_logits(model: DecoderLM, token_ids: torch.Tensor) -> torch.Tensor:
    """Full causal forward: cache sized to the sequence, cache_len 0 —
    the same computation the decode path splits into prefill + steps."""
    b, s = token_ids.shape
    kc, vc = init_caches(model.cfg, b, s, token_ids.device)
    with torch.no_grad():
        logits, _, _ = model(token_ids, kc, vc, 0)
    return logits


def gumbel(key: Key, shape, device) -> torch.Tensor:
    """Gumbel(0, 1) noise of ``shape``: drawn from ``key`` when it is a
    generator (on ``device``), or ``key`` itself when it is the noise."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.float32).reshape(shape)
    u = torch.rand(shape, generator=key, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical``: argmax of the logits plus Gumbel
    noise, over the last axis."""
    return torch.argmax(logits + gumbel(key, logits.shape, logits.device),
                        dim=-1)


def _nucleus_cutoff(srt: torch.Tensor, top_p) -> torch.Tensor:
    """[B, 1] smallest logit of the smallest prefix of the descending
    ``srt`` whose mass reaches ``top_p`` (the first always survives: the
    cumulative mass is shifted right by one position)."""
    cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    keep = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]],
                     dim=-1) < top_p
    return torch.where(keep, srt, math.inf).min(-1, keepdim=True).values


def truncated_logits(last: torch.Tensor, temperature: float,
                     top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Temperature-scaled [B, V] logits with top-k / nucleus tokens
    masked to -inf; softmax of the result is the exact sampling
    distribution (shared by sample_logits and speculative verify)."""
    logits = last / temperature
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -math.inf, logits)
    if top_p and 0.0 < top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        logits = torch.where(logits < _nucleus_cutoff(srt, top_p),
                             -math.inf, logits)
    return logits


def sample_logits(last: torch.Tensor, key: Key, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """One sampling decision over [B, V] logits: greedy at
    ``temperature == 0`` (``key`` unused); otherwise temperature scaling
    with optional top-k and/or top-p truncation."""
    if temperature <= 0:
        return torch.argmax(last, dim=-1)
    return categorical(key, truncated_logits(last, temperature, top_k,
                                             top_p))


def truncated_logits_dynamic(last: torch.Tensor, temperature: torch.Tensor,
                             top_k: torch.Tensor, top_p: torch.Tensor
                             ) -> torch.Tensor:
    """Per-row sampling knobs: ``temperature``/``top_k``/``top_p`` are
    [B] tensors, so one call serves every mix of per-request settings.
    Row semantics match ``truncated_logits`` exactly: ``top_k[b] == 0``
    disables top-k, ``top_p[b]`` outside (0, 1) disables nucleus; rows
    with ``temperature[b] <= 0`` are the caller's problem
    (``sample_logits_dynamic`` routes them to argmax)."""
    v = last.shape[-1]
    logits = last / temperature.clamp(min=1e-6)[:, None]
    k = top_k.long()
    use_k = (k > 0) & (k < v)
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth = srt.gather(-1, (k - 1).clamp(0, v - 1)[:, None])
    kth = torch.where(use_k[:, None], kth, -math.inf)
    logits = torch.where(logits < kth, -math.inf, logits)
    # Nucleus over the post-top-k distribution, as the static order has
    # it (top-k first, then the cumulative-mass cutoff).
    srt = torch.where(srt < kth, -math.inf, srt)
    cutoff = _nucleus_cutoff(srt, top_p[:, None])
    use_p = (top_p > 0.0) & (top_p < 1.0)
    cutoff = torch.where(use_p[:, None], cutoff, -math.inf)
    return torch.where(logits < cutoff, -math.inf, logits)


def sample_logits_dynamic(last: torch.Tensor, key: Key,
                          temperature: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor,
                          sampled: Optional[bool] = None) -> torch.Tensor:
    """Per-row sampling with [B] knobs: greedy rows (``temperature[b] <=
    0``) take the argmax; the truncation and the draw are skipped when
    ``sampled`` is False — the caller says whether any row samples from
    the knobs it holds on the host (None reads ``temperature``, a host
    sync). For rows whose knobs equal a static setting, the decision is
    ``sample_logits``' under the same noise."""
    greedy = torch.argmax(last, dim=-1)
    if sampled is None:
        sampled = bool((temperature > 0).any())
    if not sampled:
        return greedy
    drawn = categorical(key, truncated_logits_dynamic(
        last, temperature, top_k, top_p))
    return torch.where(temperature <= 0.0, greedy, drawn)


def _advance(nxt, done, pos, eos_id: int):
    """A step's bookkeeping: a finished row emits ``eos_id`` and keeps its
    position (its cache writes pin to one dead slot)."""
    nxt = torch.where(done, eos_id, nxt)
    pos = torch.where(done, pos, pos + 1)
    return nxt, pos, done | (nxt == eos_id)


def _decode_programs(model: DecoderLM, temperature: float, top_k: int,
                     top_p: float, eos_id: int, chunk: int):
    """(prefill, step, chunk_steps, prefill_batch) for one sampling and
    chunk setting. Each draws one noise block a sampled decision from the
    generator it is handed, in order, so a chunk of steps draws what the
    same steps one at a time draw."""

    def prefill(ids, kc, vc, key):
        logits, kc, vc = model(ids, kc, vc, 0)
        tok = sample_logits(logits[:, -1], key, temperature, top_k, top_p)
        return tok, kc, vc

    def prefill_batch(ids, lens, kc, vc, key):
        logits, kc, vc = model(ids, kc, vc, 0)
        rows = torch.arange(ids.shape[0], device=ids.device)
        last = logits[rows, lens - 1]  # [B, V]
        tok = sample_logits(last, key, temperature, top_k, top_p)
        return tok, kc, vc

    def step(tok, kc, vc, pos, key):
        logits, kc, vc = model(tok, kc, vc, pos)
        nxt = sample_logits(logits[:, -1], key, temperature, top_k, top_p)
        return nxt, kc, vc

    def chunk_steps(tok, kc, vc, pos, key, done):
        """``chunk`` cached steps, enqueued without a host read. A
        finished row (EOS seen) freezes: it emits ``eos_id`` and stops
        advancing its ``pos`` ([B] per-row offsets)."""
        toks = []
        for _ in range(chunk):
            logits, kc, vc = model(tok[:, None], kc, vc, pos)
            nxt = sample_logits(logits[:, -1], key, temperature, top_k,
                                top_p)
            tok, pos, done = _advance(nxt, done, pos, eos_id)
            toks.append(tok)
        return torch.stack(toks), tok, kc, vc, pos, key, done

    return prefill, step, chunk_steps, prefill_batch


def _decode_programs_dynamic(model: DecoderLM, eos_id: int, chunk: int,
                             lp_k: int = 0):
    """``chunk_steps`` with per-row sampling knobs ([B] tensors), so one
    function serves every mix of per-request settings in a
    continuous-batching server. ``sampled`` says (from the host's knobs)
    whether any row samples. Returns per step the token and its
    log-probability under the model's RAW distribution (pre-temperature
    and truncation — the model-confidence convention), and with ``lp_k >
    0`` the top-``lp_k`` alternatives ([chunk, S, lp_k] log-probabilities
    and ids — the OpenAI ``top_logprobs`` surface)."""

    def chunk_steps(tok, kc, vc, pos, key, done, temp, tk, tp,
                    sampled=None):
        ys = [[], []] + ([[], []] if lp_k else [])
        for _ in range(chunk):
            logits, kc, vc = model(tok[:, None], kc, vc, pos)
            last = logits[:, -1]
            nxt = sample_logits_dynamic(last, key, temp, tk, tp, sampled)
            lsm = torch.log_softmax(last, dim=-1)
            ys[1].append(lsm.gather(-1, nxt[:, None])[:, 0])
            if lp_k:
                tlv, tli = torch.topk(lsm, lp_k, dim=-1)
                ys[2].append(tlv)
                ys[3].append(tli)
            tok, pos, done = _advance(nxt, done, pos, eos_id)
            ys[0].append(tok)
        return tuple(torch.stack(y) for y in ys) + (tok, kc, vc, pos, key,
                                                    done)

    return chunk_steps


def _decode_programs_constrained(model: DecoderLM, eos_id: int,
                                 chunk: int, lp_k: int = 0):
    """The dynamic ``chunk_steps`` with GUIDED decoding: per-slot DFA
    constraints (models/constrain.py) applied as logit masks inside the
    chunk, with the automaton state carried on the device.

    ``tables`` is the stacked dense next-state tensor ``int32
    [n_constraints, max_states, vocab]`` (id 0 = the identity constraint),
    ``cid``/``cstate`` the per-row constraint id and DFA state. Each step
    gathers one table row per slot, masks disallowed tokens to -inf
    BEFORE sampling (so greedy/top-k/top-p all operate on the allowed
    set), samples, and advances the state through the same row — no host
    read mid-chunk. The EOS column encodes acceptance (table[s, eos] == s
    iff accepting), so a constrained row can only end at a complete
    sentence; reported log-probabilities stay raw (pre-mask)."""

    def chunk_steps(tok, kc, vc, pos, key, done, temp, tk, tp, cid,
                    cstate, tables, sampled=None):
        nc, sm, v = tables.shape
        flat = tables.reshape(nc * sm, v)
        ys = [[], []] + ([[], []] if lp_k else [])
        for _ in range(chunk):
            logits, kc, vc = model(tok[:, None], kc, vc, pos)
            last = logits[:, -1]
            row = flat[cid * sm + cstate]  # [S, V]
            masked = torch.where(row >= 0, last, -math.inf)
            nxt = sample_logits_dynamic(masked, key, temp, tk, tp, sampled)
            lsm = torch.log_softmax(last, dim=-1)
            ys[1].append(lsm.gather(-1, nxt[:, None])[:, 0])
            if lp_k:
                tlv, tli = torch.topk(lsm, lp_k, dim=-1)
                ys[2].append(tlv)
                ys[3].append(tli)
            nxt = torch.where(done, eos_id, nxt)
            # A negative id indexes from the end, as jnp's gather does.
            nstate = row.gather(-1, (nxt % v)[:, None])[:, 0].long()
            # A row finishing THIS step sampled EOS at an accepting state
            # (row[eos] = state >= 0); frozen rows keep theirs.
            cstate = torch.where(done, cstate, nstate.clamp(min=0))
            pos = torch.where(done, pos, pos + 1)
            done = done | (nxt == eos_id)
            tok = nxt
            ys[0].append(tok)
        return tuple(torch.stack(y) for y in ys) + (tok, kc, vc, pos, key,
                                                    done, cstate)

    return chunk_steps


@torch.no_grad()
def generate_stream(
    model: DecoderLM,
    prompt_ids: List[int],
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    seed: int = 0,
    eos_id: int = EOS,
    max_len: Optional[int] = None,
    chunk: int = 1,
) -> Iterator[int]:
    """Yield generated token ids one at a time (greedy when
    ``temperature == 0``; temperature/top-k/top-p otherwise). Prefill runs
    once over the prompt; each later token is one cached step.

    ``chunk > 1`` enqueues ``chunk`` cached steps (sampling included) with
    no host read and downloads the token block once, so host round-trips
    drop by that factor. Token-for-token identical to ``chunk=1``; text
    still streams, in blocks of up to ``chunk`` tokens."""
    dev = model.device
    n_chunks = -(-max_new_tokens // chunk) if chunk > 1 else 0
    smax = max_len or (len(prompt_ids) + max(max_new_tokens,
                                             n_chunks * chunk))
    assert len(prompt_ids) + max_new_tokens <= smax + 1
    kc, vc = init_caches(model.cfg, 1, smax, dev)
    ids = torch.tensor([list(prompt_ids)], dtype=torch.long, device=dev)
    prefill, step, chunk_steps, _ = _decode_programs(
        model, temperature, top_k, top_p, eos_id, chunk)
    key = torch.Generator(device=dev).manual_seed(seed)
    tok, kc, vc = prefill(ids, kc, vc, key)
    pos = len(prompt_ids)

    if chunk > 1:
        t = int(tok[0])
        if t == eos_id:
            return
        yield t
        emitted = 1
        done = torch.zeros(1, dtype=torch.bool, device=dev)
        pos_dev = torch.full((1,), pos, dtype=torch.long, device=dev)
        while emitted < max_new_tokens:
            toks, tok, kc, vc, pos_dev, key, done = chunk_steps(
                tok, kc, vc, pos_dev, key, done)
            for t in toks[:, 0].tolist():
                if t == eos_id or emitted >= max_new_tokens:
                    return
                yield t
                emitted += 1
        return

    for _ in range(max_new_tokens):
        t = int(tok[0])
        if t == eos_id or pos >= smax:
            return
        yield t
        tok, kc, vc = step(tok[:, None], kc, vc, pos, key)
        pos += 1


@torch.no_grad()
def generate_batch(
    model: DecoderLM,
    prompts: List[List[int]],
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    seed: int = 0,
    eos_id: int = EOS,
    max_len: Optional[int] = None,
    chunk: int = 8,
) -> List[List[int]]:
    """Generate continuations for B ragged prompts in one batch. Prompts
    are right-padded to a common prefill width (padded tail keys are
    never attended: each row's decode overwrites slot ``len_i + t`` at
    step t before any query position can see it), and decode runs with
    per-row cache offsets so every row advances through its own sequence,
    ``chunk`` steps a host read. Each row stops at its own EOS; returns
    one token list per prompt."""
    dev = model.device
    bsz = len(prompts)
    lens = np.asarray([len(p) for p in prompts], np.int64)
    pmax = int(lens.max())
    n_chunks = -(-max_new_tokens // chunk)
    smax = max_len or (pmax + n_chunks * chunk)
    padded = np.full((bsz, pmax), PAD, np.int64)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p

    kc, vc = init_caches(model.cfg, bsz, smax, dev)
    _, _, chunk_steps, prefill_batch = _decode_programs(
        model, temperature, top_k, top_p, eos_id, chunk)
    key = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.as_tensor(lens, device=dev)
    tok, kc, vc = prefill_batch(torch.as_tensor(padded, device=dev), pos,
                                kc, vc, key)
    done = tok == eos_id
    blocks = [tok[None]]  # prefill's sample is token 0
    while True:
        if (len(blocks) - 1) * chunk + 1 >= max_new_tokens:
            break
        if len(blocks) > 1 and bool(done.all()):
            break
        toks, tok, kc, vc, pos, key, done = chunk_steps(
            tok, kc, vc, pos, key, done)
        blocks.append(toks)  # [chunk, B]
    stream = torch.cat(blocks).cpu().numpy()  # [T, B]
    out: List[List[int]] = []
    for i in range(bsz):
        row: List[int] = []
        for t in stream[:, i].tolist():
            if t == eos_id or len(row) >= max_new_tokens:
                break
            row.append(t)
        out.append(row)
    return out


def generate_text_stream(
    model: DecoderLM, prompt: str, tokenizer: Optional[ByteTokenizer] = None,
    **kwargs,
) -> Generator[str, None, None]:
    """Text-level streaming: UTF-8-safe deltas from the token stream."""
    tok = tokenizer or ByteTokenizer()
    dec = (tok.stream_decoder() if hasattr(tok, "stream_decoder")
           else ByteDecoder())
    for t in generate_stream(model, tok.encode(prompt), **kwargs):
        piece = dec.feed(t)
        if piece:
            yield piece
    tail = dec.flush()
    if tail:
        yield tail
