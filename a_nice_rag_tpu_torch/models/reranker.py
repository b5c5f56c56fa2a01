"""On-device cross-encoder reranker (the port of the JAX package's
``models/reranker.py``).

Replaces the external rerank API (reference src/search_engine.py:161-203)
with a local cross-encoder: the shared transformer backbone runs over
[query ; SEP ; document] and a scalar head produces a relevance score.
``OnDeviceReranker`` adapts it to the retrieval.rerank.Reranker protocol
(attaches ``rerank_score``, sorts descending, truncates to top_k).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from a_nice_rag_tpu_torch.device import DeviceLike
from a_nice_rag_tpu_torch.models.encoder import (
    Block,
    EncoderConfig,
    RMSNorm,
    dense,
    flax_like_std,
    masked_mean,
    materialize,
    positions_of,
)
from a_nice_rag_tpu_torch.models.tokenizer import HashingTokenizer


class CrossEncoderReranker(nn.Module):
    """Relevance logits [B] (float32) of [query ; SEP ; document] rows.

    ``use_match_features``: cross-segment lexical interaction features
    (DRMM/KNRM-style): for every token, whether and how often its id
    occurs in the OTHER segment of the pair, projected into the embedding
    stream (``match_proj``, with a bias). A small from-scratch
    transformer learns token-identity copy detection poorly; the explicit
    interaction generalizes by construction."""

    def __init__(self, cfg: EncoderConfig, use_match_features: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_match_features = use_match_features
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim)
        if use_match_features:
            self.match_proj = nn.Linear(3, cfg.dim)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim)
        self.head = nn.Linear(cfg.dim, 1)

    def match_features(self, token_ids, mask):
        """[B, S, 3]: match any, log1p(match count), segment."""
        is_sep = token_ids == self.cfg.vocab_size - 1
        # False = query segment, True = document segment (the SEP itself
        # lands in the document segment; ``valid`` excludes it).
        seg = torch.cumsum(is_sep.int(), dim=1) > 0
        valid = mask & ~is_sep
        m = ((token_ids[:, :, None] == token_ids[:, None, :])
             & (seg[:, :, None] != seg[:, None, :])
             & valid[:, :, None] & valid[:, None, :])
        return torch.stack([m.any(dim=2).float(),
                            torch.log1p(m.float().sum(dim=2)),
                            seg.float()], dim=-1)

    def forward(self, token_ids):
        cfg = self.cfg
        mask = token_ids > 0
        x = F.embedding(token_ids, self.embed.weight).to(cfg.dtype)
        if self.use_match_features:
            feats = self.match_features(token_ids, mask).to(cfg.dtype)
            x = x + dense(self.match_proj, feats, cfg.dtype)
        positions = positions_of(mask)
        for blk in self.blocks:
            x = blk(x, mask, positions)
        pooled = masked_mean(self.norm(x), mask)
        return dense(self.head, pooled, torch.float32)[:, 0]


def init_reranker(cfg: EncoderConfig, seed: int = 0,
                  device: DeviceLike = "cuda",
                  use_match_features: bool = False) -> CrossEncoderReranker:
    """A ``CrossEncoderReranker`` with seeded random float32 weights on
    ``device`` (flax's scales; not its draws)."""
    return materialize(
        lambda: CrossEncoderReranker(cfg, use_match_features), device, seed,
        flax_like_std)


def score_pairs(model: CrossEncoderReranker, ids: np.ndarray):
    """The model's float32 logits of encoded pairs, on its device."""
    dev = model.embed.weight.device
    # inference_mode is thread-local: each caller's thread enters it.
    with torch.inference_mode():
        return model(torch.as_tensor(ids, device=dev)).float()


class OnDeviceReranker:
    """retrieval.rerank.Reranker protocol over the cross-encoder, run on
    ``device`` (the card unless asked otherwise)."""

    def __init__(
        self,
        cfg: Optional[EncoderConfig] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        tokenizer: Optional[HashingTokenizer] = None,
        seed: int = 0,
        use_match_features: bool = False,
        device: DeviceLike = "cuda",
    ):
        self.cfg = cfg or EncoderConfig(n_layers=2)
        self.model = init_reranker(self.cfg, seed, device,
                                   use_match_features)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.tokenizer = tokenizer or HashingTokenizer(
            vocab_size=self.cfg.vocab_size
        )

    def score(self, queries: List[str], documents: List[str]) -> np.ndarray:
        ids = self.tokenizer.encode_pairs(queries, documents)
        return score_pairs(self.model, ids).cpu().numpy()

    def rerank(
        self,
        query_text: str,
        documents: List[Dict],
        model: str = "on-device",
        top_k: Optional[int] = None,
    ) -> List[Dict]:
        texts = [d.get("document", "") for d in documents]
        scores = self.score([query_text] * len(texts), texts)
        order = np.argsort(scores)[::-1]
        out = [
            {**documents[i], "rerank_score": float(scores[i])} for i in order
        ]
        return out[:top_k] if top_k else out
