"""Encoder training loop (the port of the JAX package's
``models/trainer.py``): epochs over (query, document) pairs with periodic
checkpoints, resume, and retrieval-recall evaluation.

Wraps models/train.py's step into the loop a user runs: shuffled
in-batch-negative batches (``np.random.default_rng(seed).permutation``,
so the batch order is the JAX package's), loss tracking, recall@1 on the
first ``eval_fraction`` of the pairs, and resume from the latest
checkpoint, the optimizer state included.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import DeviceLike
from a_nice_rag_tpu_torch.models.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from a_nice_rag_tpu_torch.models.encoder import EncoderConfig, init_encoder
from a_nice_rag_tpu_torch.models.tokenizer import HashingTokenizer
from a_nice_rag_tpu_torch.models.train import make_train_step

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]  # the trained state dict
    losses: List[float]
    eval_recall: List[Tuple[int, float]]
    steps: int


@torch.no_grad()
def _recall_at_k(model, tok, queries, documents, k=1) -> float:
    from a_nice_rag_tpu_torch.ops.dense import dense_top_k

    dev = model.embed.weight.device
    d = model(torch.as_tensor(tok.encode_batch(documents), device=dev))
    q = model(torch.as_tensor(tok.encode_batch(queries), device=dev))
    _, idx = dense_top_k(d, q, k)
    hits = (idx.cpu().numpy() == np.arange(len(queries))[:, None]).any(1)
    return float(hits.mean())


def train_encoder(
    queries: Sequence[str],
    documents: Sequence[str],
    cfg: Optional[EncoderConfig] = None,
    batch_size: int = 32,
    epochs: int = 3,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    eval_every: int = 50,
    eval_fraction: float = 0.1,
    tokenizer: Optional[HashingTokenizer] = None,
    init: Optional[Dict[str, torch.Tensor]] = None,
    device: DeviceLike = "cuda",
) -> TrainResult:
    """Contrastive training over aligned (query, document) pairs on
    ``device`` (the card unless asked otherwise).

    ``init`` (a state dict) replaces the seeded initial weights, e.g. the
    JAX package's through ``models.convert``. Resumes from
    ``checkpoint_dir``'s latest step when present; a checkpoint is saved
    every ``checkpoint_every`` steps and at the end.
    """
    if len(queries) != len(documents):
        raise ValueError(f"{len(queries)} queries for {len(documents)} "
                         "documents")
    cfg = cfg or EncoderConfig()
    tok = tokenizer or HashingTokenizer(vocab_size=cfg.vocab_size)
    model = init_encoder(cfg, seed, device)
    if init is not None:
        model.load_state_dict(init)
    dev = model.embed.weight.device
    step_fn, optimizer = make_train_step(model)

    start_step = 0
    if checkpoint_dir and latest_step(checkpoint_dir) is not None:
        start_step, params, opt_state = restore_checkpoint(
            checkpoint_dir, template=model.state_dict())
        model.load_state_dict(params)
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
        logger.info("resumed from step %d", start_step)

    rng = np.random.default_rng(seed)
    n = len(queries)
    n_eval = max(1, int(n * eval_fraction))
    eval_q, eval_d = list(queries[:n_eval]), list(documents[:n_eval])

    def ids(texts):
        return torch.as_tensor(tok.encode_batch(texts), device=dev)

    losses: List[float] = []
    recalls: List[Tuple[int, float]] = []
    step = start_step
    for _ in range(epochs):
        order = rng.permutation(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            sel = order[lo:lo + batch_size]
            loss = step_fn(ids([queries[i] for i in sel]),
                           ids([documents[i] for i in sel]))
            losses.append(float(loss))
            step += 1
            if eval_every and step % eval_every == 0:
                r = _recall_at_k(model, tok, eval_q, eval_d)
                recalls.append((step, r))
                logger.info("step %d loss %.4f recall@1 %.3f",
                            step, losses[-1], r)
            if checkpoint_dir and step % checkpoint_every == 0:
                save_checkpoint(checkpoint_dir, step, model.state_dict(),
                                optimizer.state_dict())
    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, step, model.state_dict(),
                        optimizer.state_dict())
    recalls.append((step, _recall_at_k(model, tok, eval_q, eval_d)))
    return TrainResult(params=model.state_dict(), losses=losses,
                       eval_recall=recalls, steps=step)
