"""Speculative decoding: draft-proposes, target-verifies, greedy-exact (the
port of the JAX package's ``models/speculative.py``).

Autoregressive decode is memory-bound — every step streams the target
model's weights for ONE token of progress. Speculative decoding
(Leviathan et al., 2023) lets a small draft model propose ``gamma``
tokens autoregressively, then the target model scores all of them in a
SINGLE forward pass (s = gamma+1 positions — the same weight stream buys
up to gamma+1 tokens). The accepted prefix is exactly what plain greedy
decoding of the target would have produced, so greedy output is
identical to the target-only stream; only the latency changes.

A round enqueues the draft's gamma steps, the target's verify forward
over the proposal window and the accept/correct logic (cumulative-product
prefix match, no data-dependent shapes) with no host read; the caller
downloads the round's tokens and counts once. Both models' KV caches ride
the per-offset write/attend machinery of models/decoder._CachedBlock;
rejected positions' cache rows are overwritten before any later query
position can attend them.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Union

import torch

from a_nice_rag_tpu_torch.models.decoder import (
    EOS,
    DecoderLM,
    Key,
    categorical,
    init_caches,
    truncated_logits,
)

# spec_accept's randomness: a generator, or the JAX package's own draws
# (uniforms [..., gamma], replacement Gumbel noise [..., gamma, V], bonus
# Gumbel noise [..., 1, V]).
AcceptKey = Union[torch.Generator, Sequence[torch.Tensor]]


def spec_accept(ds, qs, ps, bonus_logits, key: AcceptKey):
    """Rejection-accept core of sampled speculative decoding (Leviathan
    et al. 2023, app. A): accept draft token ``ds[i]`` (drawn from q_i)
    with prob min(1, p_i(ds_i)/q_i(ds_i)); at the first rejection sample
    the replacement from norm(relu(p_i - q_i)); on full acceptance sample
    the bonus token from p_{gamma+1}. The emitted sequence is distributed
    EXACTLY as target-only sampling.

    ds [..., gamma] proposals; qs/ps [..., gamma, V] draft/target probs;
    bonus_logits [..., 1, V] target logits past the last proposal; leading
    axes are independent rows. Returns (out [..., gamma+1], m): out[:m]
    are the emitted tokens."""
    gamma = ds.shape[-1]
    dev = ds.device
    if isinstance(key, torch.Generator):
        us = torch.rand(ds.shape, generator=key, device=dev)
        k_rep = k_bonus = key
    else:
        us, k_rep, k_bonus = (torch.as_tensor(x, device=dev) for x in key)
    p_d = ps.gather(-1, ds[..., None])[..., 0]
    q_d = qs.gather(-1, ds[..., None])[..., 0]
    acc = (us * q_d < p_d).long()  # u < p/q, division-free
    n_acc = torch.cumprod(acc, dim=-1).sum(-1)
    # Residual distribution at every candidate rejection point; where
    # p <= q everywhere (p == q) the residual is empty — fall back to p
    # itself (that branch is only selected with probability 0).
    res = (ps - qs).clamp(min=0.0)
    res_sum = res.sum(-1, keepdim=True)
    res = torch.where(res_sum > 0, res / res_sum.clamp(min=1e-30), ps)
    rep = categorical(k_rep, torch.log(res + 1e-30))  # [..., gamma]
    bonus = categorical(k_bonus, bonus_logits)  # [..., 1]
    cand = torch.cat([rep, bonus], dim=-1)
    ds_pad = torch.cat([ds, ds[..., -1:]], dim=-1)
    idx = torch.arange(gamma + 1, device=dev)
    out = torch.where(idx < n_acc[..., None], ds_pad, cand)
    return out, n_acc + 1


def _propose(draft: DecoderLM, tok, dkc, dvc, pos, key: Key, gamma: int,
             greedy: bool, temperature: float, top_k: int, top_p: float):
    """The draft's ``gamma`` steps from ``tok`` [S] at ``pos`` ([S], or an
    int for one stream): proposals [S, gamma] and, when sampled, their
    probabilities [S, gamma, V]."""
    ds, qs = [], []
    for i in range(gamma):
        p = pos + i
        logits, dkc, dvc = draft(tok[:, None], dkc, dvc, p)
        last = logits[:, -1]
        if greedy:
            tok = torch.argmax(last, dim=-1)
        else:
            ml = truncated_logits(last, temperature, top_k, top_p)
            tok = categorical(key, ml)
            qs.append(torch.softmax(ml, dim=-1))
        ds.append(tok)
    return torch.stack(ds, 1), (torch.stack(qs, 1) if qs else None)


def _verify(target: DecoderLM, tok, ds, qs, tkc, tvc, pos, key: Key,
            greedy: bool, temperature: float, top_k: int, top_p: float):
    """The target's forward over [tok, ds] and the accept logic: (out
    [S, gamma+1], m [S]) where row s emitted out[s, :m[s]]."""
    gamma = ds.shape[1]
    seq = torch.cat([tok[:, None], ds], dim=1)  # [S, gamma+1]
    tlogits, tkc, tvc = target(seq, tkc, tvc, pos)
    if greedy:
        gs = torch.argmax(tlogits, dim=-1)  # [S, gamma+1]
        match = (ds == gs[:, :gamma]).long()
        n_acc = torch.cumprod(match, dim=1).sum(1)
        ds_pad = torch.cat([ds, ds[:, -1:]], dim=1)
        idx = torch.arange(gamma + 1, device=ds.device)
        return torch.where(idx[None] < n_acc[:, None], ds_pad, gs), n_acc + 1
    s_rows, _, v = tlogits.shape
    mlt = truncated_logits(tlogits.reshape(-1, v), temperature, top_k,
                           top_p).reshape(s_rows, gamma + 1, v)
    ps = torch.softmax(mlt[:, :gamma], dim=-1)
    return spec_accept(ds, qs, ps, mlt[:, gamma:], key)


def spec_round(target: DecoderLM, draft: DecoderLM, gamma: int, tok, tkc,
               tvc, dkc, dvc, pos, key: Key, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0):
    """One speculation round for every row at its own offset (``pos``
    [S]): (out [S, gamma+1], m [S], the new last token [S]). Greedy rows
    reproduce plain target-greedy token for token; sampled rows are
    distributed exactly as plain target sampling."""
    greedy = temperature <= 0
    ds, qs = _propose(draft, tok, dkc, dvc, pos, key, gamma, greedy,
                      temperature, top_k, top_p)
    out, m = _verify(target, tok, ds, qs, tkc, tvc, pos, key, greedy,
                     temperature, top_k, top_p)
    rows = torch.arange(out.shape[0], device=out.device)
    return out, m, out[rows, m - 1]


@torch.no_grad()
def speculative_generate_stream(
    target: DecoderLM,
    draft: DecoderLM,
    prompt_ids: List[int],
    max_new_tokens: int = 64,
    gamma: int = 4,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    seed: int = 0,
    eos_id: int = EOS,
    max_len: Optional[int] = None,
    rounds: int = 1,
    stats: Optional[dict] = None,
) -> Iterator[int]:
    """Streaming generation with the draft model absorbing most of the
    sequential work; one host read per ``rounds`` rounds yields
    1..rounds*(gamma+1) tokens. Greedy (``temperature <= 0``) is
    token-for-token ``generate_stream(target, ...)``; sampled mode is
    distributed exactly as plain target sampling (rejection scheme — the
    draft changes latency, never the distribution). Pass ``stats={}`` to
    receive ``rounds``/``accepted`` counters (mean tokens/round =
    accepted/rounds). Tokens decoded past an in-block EOS are
    discarded."""
    dev = target.device
    n_prompt = len(prompt_ids)
    block = rounds * (gamma + 1)
    smax = max_len or (n_prompt + max_new_tokens + block)
    assert n_prompt + max_new_tokens + block <= smax + block
    tkc, tvc = init_caches(target.cfg, 1, smax, dev)
    dkc, dvc = init_caches(draft.cfg, 1, smax, dev)
    ids = torch.tensor([list(prompt_ids)], dtype=torch.long, device=dev)
    key = torch.Generator(device=dev).manual_seed(seed)
    tlogits, tkc, tvc = target(ids, tkc, tvc, 0)
    draft(ids, dkc, dvc, 0)
    if temperature <= 0:
        tok = torch.argmax(tlogits[:, -1], dim=-1)
    else:
        tok = categorical(key, truncated_logits(tlogits[:, -1], temperature,
                                                top_k, top_p))
    t = int(tok[0])
    if t == eos_id:
        return
    yield t
    emitted = 1
    pos = n_prompt
    pos_dev = torch.full((1,), pos, dtype=torch.long, device=dev)
    n_rounds = accepted = 0
    while emitted < max_new_tokens:
        if pos + block > smax:
            break  # cache exhausted (caller sized max_len too small)
        outs, ms = [], []
        for _ in range(rounds):
            out, m, tok = spec_round(target, draft, gamma, tok, tkc, tvc,
                                     dkc, dvc, pos_dev, key, temperature,
                                     top_k, top_p)
            pos_dev = pos_dev + m
            outs.append(out[0])
            ms.append(m)
        host = torch.cat([torch.stack(outs).flatten(),
                          torch.cat(ms)]).tolist()
        outs_h, ms_h = host[:-rounds], host[-rounds:]
        pos += sum(ms_h)
        for r, m in enumerate(ms_h):
            n_rounds += 1
            accepted += m
            for t in outs_h[r * (gamma + 1):r * (gamma + 1) + m]:
                if t == eos_id or emitted >= max_new_tokens:
                    if stats is not None:
                        stats.update(rounds=n_rounds, accepted=accepted)
                    return
                yield t
                emitted += 1
    if stats is not None:
        stats.update(rounds=n_rounds, accepted=accepted)
