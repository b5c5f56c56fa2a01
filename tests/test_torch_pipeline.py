"""The port's GPipe pipeline (a_nice_rag_tpu_torch/models/pipeline.py) on a
dp x pp = 2 x 4 mesh of 8 CPU slots, against the one-slot encoder and
the JAX package's pipeline on 8 virtual devices.

Mirrors tests/test_pipeline_parallel.py's 5 cases. The pipelined forward
runs each block as the one-slot encoder does, in the same order, so it
equals the port's one-slot forward exactly; against the JAX package's
pipelined forward it is within 1e-5 in float32 and 2e-2 in bf16 (unit
vectors; bf16 block compute, the JAX test's bound). Training's first
loss equals the one-slot step's within 1e-5 relative and three steps'
parameters within 2e-5 (AdamW magnifies summation-order noise of
near-zero gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from a_nice_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from a_nice_rag_tpu.models.encoder import init_encoder as jax_init
from a_nice_rag_tpu.models.pipeline import (
    make_pipeline_forward as jax_forward,
)
from a_nice_rag_tpu.models.pipeline import (
    split_pipeline_params as jax_split,
)
from a_nice_rag_tpu_torch.models.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from a_nice_rag_tpu_torch.models.convert import encoder_state_from_flax
from a_nice_rag_tpu_torch.models.encoder import EncoderConfig, init_encoder
from a_nice_rag_tpu_torch.models.pipeline import (
    make_pipeline_forward,
    make_pipeline_train_step,
    merge_pipeline_params,
    pipeline_parts,
    split_pipeline_params,
)
from a_nice_rag_tpu_torch.models.train import make_train_step
from a_nice_rag_tpu_torch.parallel import make_mesh

SIZES = dict(vocab_size=512, dim=64, n_layers=4, n_heads=2, max_len=32,
             out_dim=64)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _setup(dtype="f32"):
    jdt, tdt, _ = DTYPES[dtype]
    model, params = jax_init(JaxConfig(**SIZES, dtype=jdt), seed=0)
    cfg = EncoderConfig(**SIZES, dtype=tdt)
    enc = init_encoder(cfg, device="cpu")
    enc.load_state_dict(encoder_state_from_flax(jax.device_get(params)))
    return model, params, cfg, enc


def _mesh():
    return make_mesh((2, 4), ("dp", "pp"), devices=["cpu"] * 8)


def _toks(seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 512, size=(8, 16))
    t[::3, 12:] = 0  # padded rows
    return t


def test_param_split_merge_roundtrip():
    _, _, _, enc = _setup()
    sd = enc.state_dict()
    head, blocks, tail = split_pipeline_params(sd, 4)
    assert blocks["qkv.weight"].shape == (4, 1, 192, 64)
    merged = merge_pipeline_params(head, blocks, tail)
    assert list(merged) == list(sd)
    for k in sd:
        assert torch.equal(merged[k], sd[k])
    with pytest.raises(ValueError, match="3 stages"):
        split_pipeline_params(sd, 3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pipelined_forward_matches_single_device(dtype):
    model, params, cfg, enc = _setup(dtype)
    toks = _toks()
    fwd = make_pipeline_forward(cfg, _mesh(), n_micro=2)
    with torch.no_grad():
        got = fwd(*split_pipeline_params(enc.state_dict(), 4),
                  torch.as_tensor(toks))
        ref = enc(torch.as_tensor(toks))
    assert torch.equal(got, ref)
    jmesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("dp", "pp"))
    with jmesh:
        want = np.asarray(jax_forward(JaxConfig(**SIZES, dtype=DTYPES[
            dtype][0]), jmesh, 2)(*jax_split(params, 4),
                                 jnp.asarray(toks.astype(np.int32))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=DTYPES[dtype][2])


def test_pipeline_training_matches_and_converges():
    _, params, cfg, enc = _setup()
    q, d = (torch.as_tensor(_toks(s)) for s in (1, 2))
    sd = enc.state_dict()
    one = init_encoder(cfg, device="cpu")
    one.load_state_dict(sd)
    step1, _ = make_train_step(one)
    want = [float(step1(q, d)) for _ in range(3)]
    step, pipe, opt, layout = make_pipeline_train_step(cfg, sd, _mesh(),
                                                       n_micro=2)
    assert layout == ("dp", None)
    losses = [float(step(q, d)) for _ in range(3)]
    assert losses[0] == pytest.approx(want[0], rel=1e-5)
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=2e-5)
    merged = merge_pipeline_params(*pipeline_parts(pipe.state_dict()))
    for k, v in one.state_dict().items():
        torch.testing.assert_close(merged[k], v, rtol=0, atol=2e-5)
    losses += [float(step(q, d)) for _ in range(2)]
    assert losses[-1] < losses[0]
    for idx in pipe.index:  # stage s holds only its blocks
        assert pipe.params[idx]["blocks.qkv.weight"].shape == (1, 1, 192, 64)
        assert opt.state[pipe.params[idx]["blocks.qkv.weight"]][
            "exp_avg"].shape == (1, 1, 192, 64)


@pytest.mark.parametrize("n_micro", [4, 1])
def test_bubble_schedule_odd_micro(n_micro):
    """n_micro other than n_stages (4 and 1 per dp group of 4 rows) still
    gives exact outputs."""
    _, _, cfg, enc = _setup()
    toks = torch.as_tensor(_toks(3))
    fwd = make_pipeline_forward(cfg, _mesh(), n_micro=n_micro)
    with torch.no_grad():
        got = fwd(*split_pipeline_params(enc.state_dict(), 4), toks)
        assert torch.equal(got, enc(toks))


def test_odd_micro_over_a_three_row_group():
    """3 microbatches of one row over dp x pp = 2 x 2 (6 rows)."""
    _, _, cfg, enc = _setup()
    mesh = make_mesh((2, 2), ("dp", "pp"), devices=["cpu"] * 4)
    toks = torch.as_tensor(_toks(4)[:6])
    fwd = make_pipeline_forward(cfg, mesh, n_micro=3)
    with torch.no_grad():
        got = fwd(*split_pipeline_params(enc.state_dict(), 2), toks)
        assert torch.equal(got, enc(toks))
    with pytest.raises(ValueError, match="microbatches"):
        make_pipeline_forward(cfg, mesh, n_micro=2)(
            *split_pipeline_params(enc.state_dict(), 2), toks)


def test_pipeline_params_checkpoint_roundtrip(tmp_path):
    """A pipeline's flat state round-trips through the checkpoint layer
    and merges back into a working encoder."""
    _, _, cfg, enc = _setup()
    _, pipe, _, _ = make_pipeline_train_step(cfg, enc.state_dict(), _mesh())
    flat = pipe.state_dict()
    save_checkpoint(str(tmp_path / "ck"), 3, flat)
    step, restored, _ = restore_checkpoint(str(tmp_path / "ck"),
                                           template=flat)
    assert step == 3
    for k in flat:
        assert torch.equal(flat[k], restored[k])
    fresh = init_encoder(cfg, seed=4, device="cpu")
    fresh.load_state_dict(merge_pipeline_params(*pipeline_parts(restored)))
    toks = torch.as_tensor(_toks())
    with torch.no_grad():
        assert torch.equal(fresh(toks), enc(toks))
