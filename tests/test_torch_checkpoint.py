"""The port's checkpoints (a_nice_rag_tpu_torch/models/checkpoint.py), on
the CPU.

Mirrors tests/test_models.py's round trip (steps 0 and 10, the latest
restored, no optimizer state) and holds the template check to the JAX
package's: a leaf-count or shape mismatch raises ``ValueError``, never a
silent truncation. A save over an existing step replaces it whole, and
the optimizer state restores to the same next step. Last, a checkpoint
the JAX package wrote with orbax is carried across (its
``restore_checkpoint`` gives numpy arrays; ``models.convert`` turns them
into the port's state dict), saved in the port's format and served:
``OnDeviceEmbedder`` on it gives the JAX embedder's vectors within 1e-5
(float32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.models.checkpoint import (
    restore_checkpoint as jax_restore,
)
from a_nice_rag_tpu.models.checkpoint import save_checkpoint as jax_save
from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder as JaxEmbedder
from a_nice_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from a_nice_rag_tpu_torch.models import EncoderConfig, OnDeviceEmbedder
from a_nice_rag_tpu_torch.models.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from a_nice_rag_tpu_torch.models.convert import encoder_state_from_flax
from a_nice_rag_tpu_torch.models.encoder import init_encoder
from a_nice_rag_tpu_torch.models.train import make_train_step

SIZES = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=2, max_len=32,
             out_dim=64)
CFG = EncoderConfig(**SIZES, dtype=torch.float32)
TEXTS = ["hello world", "hypertension in adults", "",
         "first-line treatment for type 2 diabetes"]


def _equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_checkpoint_roundtrip(tmp_path):
    enc = init_encoder(CFG, seed=5, device="cpu")
    path = str(tmp_path / "ckpt")
    assert latest_step(path) is None
    save_checkpoint(path, 0, enc.state_dict())
    save_checkpoint(path, 10, enc.state_dict())
    assert latest_step(path) == 10
    step, restored, opt = restore_checkpoint(path)
    assert step == 10 and opt is None
    _equal(restored, enc.state_dict())
    assert restore_checkpoint(path, step=0)[0] == 0
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))


@pytest.mark.parametrize("change", ["fewer", "more", "renamed", "shape"])
def test_template_mismatch_raises(tmp_path, change):
    enc = init_encoder(CFG, device="cpu")
    sd = enc.state_dict()
    template = dict(sd)
    if change == "fewer":
        template.pop("out.weight")
    elif change == "more":
        template["extra.weight"] = torch.zeros(3)
    elif change == "renamed":  # same count and shapes, another name
        template["out.kernel"] = template.pop("out.weight")
    else:
        template["out.weight"] = torch.zeros(32, 64)
    save_checkpoint(str(tmp_path), 1, sd)
    with pytest.raises(ValueError, match="leaves" if change != "shape"
                       else "shape"):
        restore_checkpoint(str(tmp_path), template=template)


def test_template_matches_by_name_not_order(tmp_path):
    """A checkpoint whose names come in another order (same-shaped
    leaves swapped in position) restores each tensor to its own name."""
    sd = init_encoder(CFG, seed=4, device="cpu").state_dict()
    save_checkpoint(str(tmp_path), 1, dict(reversed(list(sd.items()))))
    _, got, _ = restore_checkpoint(str(tmp_path), template=sd)
    _equal(got, sd)


def test_template_casts_to_its_dtype(tmp_path):
    sd = init_encoder(CFG, device="cpu").state_dict()
    save_checkpoint(str(tmp_path), 2, sd)
    template = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    _, got, _ = restore_checkpoint(str(tmp_path), template=template)
    assert all(v.dtype == torch.bfloat16 for v in got.values())


def test_save_replaces_a_step_whole(tmp_path):
    a = init_encoder(CFG, seed=1, device="cpu").state_dict()
    b = init_encoder(CFG, seed=2, device="cpu").state_dict()
    save_checkpoint(str(tmp_path), 4, a)
    save_checkpoint(str(tmp_path), 4, b)
    _equal(restore_checkpoint(str(tmp_path))[1], b)
    assert sorted(os.listdir(tmp_path)) == ["4"]  # no temporary left


def test_optimizer_state_resumes_the_same_step(tmp_path):
    rng = np.random.default_rng(0)
    q, d = (torch.as_tensor(rng.integers(1, 1024, (8, 16)))
            for _ in range(2))
    enc = init_encoder(CFG, seed=3, device="cpu")
    step, opt = make_train_step(enc)
    step(q, d)
    save_checkpoint(str(tmp_path), 1, enc.state_dict(), opt.state_dict())
    want = float(step(q, d))
    fresh = init_encoder(CFG, seed=9, device="cpu")
    step2, opt2 = make_train_step(fresh)
    _, params, opt_state = restore_checkpoint(
        str(tmp_path), template=fresh.state_dict())
    fresh.load_state_dict(params)
    opt2.load_state_dict(opt_state)
    assert float(step2(q, d)) == want
    _equal(fresh.state_dict(), enc.state_dict())


def test_jax_orbax_checkpoint_carried_across_and_served(tmp_path):
    jcfg = JaxConfig(**SIZES, dtype=jnp.float32)
    jemb = JaxEmbedder(jcfg, seed=7)
    jax_save(str(tmp_path / "orbax"), 3, jemb.params)
    step, params, _ = jax_restore(str(tmp_path / "orbax"))
    sd = encoder_state_from_flax(jax.device_get(params))
    save_checkpoint(str(tmp_path / "port"), step, sd)
    emb = OnDeviceEmbedder(CFG, device="cpu")
    got_step, restored, _ = restore_checkpoint(
        str(tmp_path / "port"), template=emb.model.state_dict())
    emb.model.load_state_dict(restored)
    assert got_step == 3
    np.testing.assert_allclose(emb.embed_queries(TEXTS),
                               np.asarray(jemb.embed_queries(TEXTS)),
                               rtol=0, atol=1e-5)
