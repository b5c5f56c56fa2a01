"""The port's training loop (a_nice_rag_tpu_torch/models/trainer.py)
against the JAX package's ``train_encoder``, on the CPU.

Both start from the JAX package's initial params (the port's through
``init=``, carried across with ``convert.encoder_state_from_flax``), see
the same batches (``np.random.default_rng(seed).permutation``) and run
float32: the per-step losses agree within 2e-5 absolute and 1e-5
relative (AdamW magnifies the summation-order noise of near-zero
gradients into the parameters, and the logits scale that by
1/temperature = 20), and recall@1 on the held-out pairs is equal.
Resume mirrors tests/test_models.py's: 6 steps with a checkpoint every
3, then one more epoch continues from step 6 to 9, the optimizer state
included, with the JAX package's resumed losses.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from a_nice_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from a_nice_rag_tpu.models.encoder import init_encoder as jax_init
from a_nice_rag_tpu.models.trainer import train_encoder as jax_train
from a_nice_rag_tpu_torch.models.checkpoint import latest_step
from a_nice_rag_tpu_torch.models.convert import encoder_state_from_flax
from a_nice_rag_tpu_torch.models.encoder import EncoderConfig
from a_nice_rag_tpu_torch.models.trainer import TrainResult, train_encoder

SIZES = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=2, max_len=32,
             out_dim=64)
JCFG = JaxConfig(**SIZES, dtype=jnp.float32)
CFG = EncoderConfig(**SIZES, dtype=torch.float32)
QUERIES = [f"question on topic {i} area {i % 4}" for i in range(48)]
DOCS = [f"document covering topic {i} within area {i % 4}" for i in range(48)]
RTOL, ATOL = 1e-5, 2e-5


def _init(seed=0):
    return encoder_state_from_flax(jax.device_get(jax_init(JCFG, seed)[1]))


def test_losses_and_recall_equal_jax():
    kw = dict(batch_size=16, epochs=2, eval_every=3, seed=0)
    want = jax_train(QUERIES, DOCS, cfg=JCFG, **kw)
    got = train_encoder(QUERIES, DOCS, cfg=CFG, init=_init(), device="cpu",
                        **kw)
    assert isinstance(got, TrainResult) and got.steps == want.steps == 6
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL,
                               atol=ATOL)
    assert got.losses[-1] < got.losses[0]
    assert got.eval_recall == want.eval_recall
    assert got.eval_recall[-1][1] > 0.5
    for k, v in encoder_state_from_flax(jax.device_get(want.params)).items():
        torch.testing.assert_close(got.params[k], v, rtol=0, atol=ATOL)


def test_resume_continues_from_the_latest_step(tmp_path):
    kw = dict(batch_size=16, eval_every=0, seed=0)
    ckpt, jckpt = str(tmp_path / "enc"), str(tmp_path / "jax")
    r1 = train_encoder(QUERIES, DOCS, cfg=CFG, epochs=2, init=_init(),
                       checkpoint_dir=ckpt, checkpoint_every=3,
                       device="cpu", **kw)
    assert r1.steps == 6 and latest_step(ckpt) == 6
    assert sorted(int(d) for d in os.listdir(ckpt)) == [3, 6]
    r2 = train_encoder(QUERIES, DOCS, cfg=CFG, epochs=1, init=_init(5),
                       checkpoint_dir=ckpt, checkpoint_every=100,
                       device="cpu", **kw)
    assert r2.steps == 9 and latest_step(ckpt) == 9
    assert len(r2.losses) == 3 and r2.losses[-1] < r1.losses[0]
    jax_train(QUERIES, DOCS, cfg=JCFG, epochs=2, checkpoint_dir=jckpt,
              checkpoint_every=3, **kw)
    want = jax_train(QUERIES, DOCS, cfg=JCFG, epochs=1, checkpoint_dir=jckpt,
                     checkpoint_every=100, **kw)
    assert want.steps == 9
    np.testing.assert_allclose(r2.losses, want.losses, rtol=RTOL, atol=ATOL)
