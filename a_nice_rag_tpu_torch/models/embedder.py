"""On-device embedder: the retrieval.embed.Embedder protocol over the
encoder (the port of the JAX package's ``models/embedder.py``), closing
the loop for a fully local pipeline: ingestion, query embedding,
retrieval and rerank with no SaaS call."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import DeviceLike
from a_nice_rag_tpu_torch.models.encoder import EncoderConfig, init_encoder
from a_nice_rag_tpu_torch.models.tokenizer import HashingTokenizer


class OnDeviceEmbedder:
    """``embed_queries`` / ``embed_documents``: texts -> [B, out_dim]
    float32 numpy rows, the encoder run on ``device`` (the card unless
    asked otherwise). ``state_dict`` replaces the seeded random weights
    (``models.convert.encoder_state_from_flax`` brings the JAX package's
    across). Safe to call from several threads: the module holds no state
    that a forward changes."""

    def __init__(
        self,
        cfg: Optional[EncoderConfig] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        tokenizer: Optional[HashingTokenizer] = None,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        self.cfg = cfg or EncoderConfig(n_layers=2)
        self.model = init_encoder(self.cfg, seed, device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.device = self.model.embed.weight.device
        self.tokenizer = tokenizer or HashingTokenizer(
            vocab_size=self.cfg.vocab_size
        )

    def _embed(self, texts: Sequence[str]) -> np.ndarray:
        ids = self.tokenizer.encode_batch(list(texts))
        # inference_mode is thread-local: the serving threads each enter it.
        with torch.inference_mode():
            out = self.model(torch.as_tensor(ids, device=self.device))
            return out.cpu().numpy()

    embed_queries = _embed
    embed_documents = _embed
