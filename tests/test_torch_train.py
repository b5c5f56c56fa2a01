"""The port's contrastive training (a_nice_rag_tpu_torch/models/train.py)
against the JAX package's, on the CPU.

Same seeded numpy inputs, the JAX package's initial params carried
across with ``convert.encoder_state_from_flax`` and its optax state with
``convert.adamw_state_from_optax``: the loss, three AdamW steps (losses
and parameters) and the tensor-parallel layout rule agree. The sharded
steps run on an 8-slot ``["cpu"] * 8`` mesh against the one-slot step,
as tests/test_models.py and tests/test_moe_expert_parallel.py hold the
JAX package's against one device.

Tolerances (float32): the first loss within 1e-5 relative; later losses
within 2e-5 absolute, since they read parameters that already differ and
the logits scale them by 1/temperature = 20. The parameters within 2e-5
absolute after three steps: AdamW's first steps move every weight by
about lr = 1e-3 times m/sqrt(v), a ratio that magnifies the
summation-order noise of a gradient near zero, so the parameters agree
about 50 times more loosely than the gradients (1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from a_nice_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from a_nice_rag_tpu.models.encoder import init_encoder as jax_init
from a_nice_rag_tpu.models.train import contrastive_loss as jax_loss
from a_nice_rag_tpu.models.train import make_train_step as jax_step
from a_nice_rag_tpu.models.train import param_shardings
from a_nice_rag_tpu_torch.models.convert import (
    adamw_state_from_optax,
    encoder_state_from_flax,
)
from a_nice_rag_tpu_torch.models.encoder import EncoderConfig, init_encoder
from a_nice_rag_tpu_torch.models.train import (
    contrastive_loss,
    load_adamw_state,
    make_sharded_train_step,
    make_train_step,
    param_layout,
)
from a_nice_rag_tpu_torch.parallel import make_mesh

KW = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=2, max_len=32,
          out_dim=64)
CFG = EncoderConfig(**KW, dtype=torch.float32)
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-5, 2e-5, 2e-5


def _jax(seed=2):
    return jax_init(JaxConfig(**KW, dtype=jnp.float32), seed=seed)


def _port(params):
    m = init_encoder(CFG, device="cpu")
    m.load_state_dict(encoder_state_from_flax(jax.device_get(params)))
    return m


def _batch(seed=0, b=8, s=16, vocab=1024):
    rng = np.random.default_rng(seed)
    q = rng.integers(1, vocab, (b, s)).astype(np.int32)
    d = rng.integers(1, vocab, (b, s)).astype(np.int32)
    q[:, 11:] = 0  # padded queries
    return q, d


def _t(a):
    return torch.as_tensor(a).long()


def _close_state(got, want, atol=PARAM_ATOL):
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=atol,
                                   msg=k)


@pytest.mark.parametrize("temperature", [0.05, 1.0])
def test_contrastive_loss_equals_jax(temperature):
    rng = np.random.default_rng(3)
    q, d = rng.normal(size=(2, 16, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = float(jax_loss(jnp.asarray(q), jnp.asarray(d), temperature))
    got = float(contrastive_loss(torch.as_tensor(q), torch.as_tensor(d),
                                 temperature))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


@pytest.mark.parametrize("warm", [False, True])
def test_three_steps_equal_jax(warm):
    """Three steps from the JAX package's params and optax state (fresh,
    or after one JAX step: the moments and count carried across)."""
    model, params = _jax()
    step, opt = jax_step(model)
    state = opt.init(params)
    q, d = _batch()
    if warm:
        params, state, _ = step(params, state, jnp.asarray(d),
                                jnp.asarray(q))
    port = _port(params)
    tstep, topt = make_train_step(port)
    if warm:
        load_adamw_state(topt, port,
                         adamw_state_from_optax(jax.device_get(state)))
    want, got = [], []
    for _ in range(3):
        params, state, loss = step(params, state, jnp.asarray(q),
                                   jnp.asarray(d))
        want.append(float(loss))
        got.append(float(tstep(_t(q), _t(d))))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert got[0] == pytest.approx(want[0], rel=LOSS_RTOL)
    assert got[-1] < got[0]
    _close_state(port.state_dict(),
                 encoder_state_from_flax(jax.device_get(params)))


def test_optimizer_is_optax_adamw():
    _, topt = make_train_step(_port(_jax()[1]))
    g = topt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (
        1e-3, (0.9, 0.999), 1e-8, 1e-4)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_layout_rule_equals_jax_on_flax_orientation(tp):
    """Every parameter's split is the JAX package's PartitionSpec read on
    the transposed kernel: square matrices (proj, and out at out_dim ==
    dim) split their flax row axis, which is torch dim 1."""
    model, params = _jax()
    jmesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))
    specs = jax.device_get(param_shardings(params, jmesh))
    # Each leaf's split axis on the flax array (-1: replicated), carried
    # to the port's names as a one-element array.
    want = encoder_state_from_flax(jax.tree.map(
        lambda sh: np.array([float(tuple(sh.spec).index("tp"))
                             if "tp" in tuple(sh.spec) else -1.0]), specs))
    port = _port(params)
    mesh = make_mesh((1, tp), ("dp", "tp"), devices=["cpu"] * tp)
    got = param_layout(port, mesh)
    for name, p in port.named_parameters():
        flax_dim = float(want[name].reshape(-1)[0])
        if flax_dim < 0:
            assert got[name] is None, name
        elif name == "embed.weight":
            assert got[name] == int(flax_dim), name
        else:  # an nn.Linear weight: the kernel transposed
            assert got[name] == 1 - int(flax_dim), name
    if tp > 1:
        assert got["blocks.0.proj.weight"] == 1  # square: flax rows
        assert got["out.weight"] == 1
        assert got["blocks.0.qkv.weight"] == 0
        assert got["blocks.0.down.weight"] == 1
        assert got["embed.weight"] == 0


def test_contrastive_training_reduces_loss():
    port = init_encoder(CFG, seed=1, device="cpu")
    q, d = _batch(4)
    step, _ = make_train_step(port)
    losses = [float(step(_t(q), _t(d))) for _ in range(12)]
    assert losses[-1] < losses[0] * 0.8, losses


@pytest.mark.parametrize("shape,axes,sp_axis", [
    ((4, 2), ("dp", "tp"), None),
    ((2, 2, 2), ("dp", "tp", "sp"), "sp"),
    ((1, 8), ("dp", "tp"), None),
])
def test_sharded_train_step_matches_single_slot(shape, axes, sp_axis):
    """dp x tp (x sp) over 8 slots of the CPU: each slot holds only its
    shard of every split matrix and of its AdamW moments; the losses and
    the updated parameters equal the one-slot step's."""
    _, params = _jax()
    q, d = _batch(1)
    one = _port(params)
    step1, _ = make_train_step(one)
    want = [float(step1(_t(q), _t(d))) for _ in range(3)]
    port = _port(params)
    mesh = make_mesh(shape, axes, devices=["cpu"] * 8)
    step, slots, opt, layout = make_sharded_train_step(
        port, None, mesh, sp_axis=sp_axis)
    assert layout == ("dp", sp_axis)
    got = [float(step(_t(q), _t(d))) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert got[0] == pytest.approx(want[0], rel=LOSS_RTOL)
    _close_state(slots.state_dict(), one.state_dict())
    split = param_layout(port, mesh)
    tp = mesh.shape["tp"]
    for idx in slots.index:
        for name, p in slots.params[idx].items():
            full = one.state_dict()[name].shape
            dim = split[name]
            want_shape = list(full)
            if dim is not None:
                want_shape[dim] //= tp
            assert list(p.shape) == want_shape, (idx, name)
            st = opt.state[p]
            assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape


def test_sharded_step_rejects_an_indivisible_batch():
    mesh = make_mesh((4, 2), ("dp", "tp"), devices=["cpu"] * 8)
    step, *_ = make_sharded_train_step(_port(_jax()[1]), None, mesh)
    q, d = _batch(b=6)
    with pytest.raises(ValueError, match="does not split"):
        step(_t(q), _t(d))
    mesh = make_mesh((2, 2, 2), ("dp", "tp", "sp"), devices=["cpu"] * 8)
    step, *_ = make_sharded_train_step(_port(_jax()[1]), None, mesh,
                                       sp_axis="sp")
    q, d = _batch(s=15)
    with pytest.raises(ValueError, match="sp=2"):
        step(_t(q), _t(d))


def test_sequence_parallel_training_equals_jax_one_device():
    """tests/test_moe_expert_parallel.py's sequence-parallel case: 4
    steps over dp x tp x sp = 2 x 2 x 2 from the JAX package's params,
    the losses equal to its one-device step's. (The JAX package's own sp
    step disagrees with its one-device step on the CPU: its first loss is
    0.99 where the one-device loss is 5.38; ROADMAP queue 3.)"""
    kw = dict(vocab_size=256, dim=64, n_layers=2, n_heads=2, max_len=32,
              out_dim=64)
    model, params = jax_init(JaxConfig(**kw, dtype=jnp.float32), seed=0)
    jstep, opt = jax_step(model)
    state = opt.init(params)
    port = init_encoder(EncoderConfig(**kw, dtype=torch.float32),
                        device="cpu")
    port.load_state_dict(encoder_state_from_flax(jax.device_get(params)))
    mesh = make_mesh((2, 2, 2), ("dp", "tp", "sp"), devices=["cpu"] * 8)
    step, *_ = make_sharded_train_step(port, None, mesh, sp_axis="sp")
    q, d = _batch(5, b=4, vocab=256)
    want, got = [], []
    for _ in range(4):
        params, state, loss = jstep(params, state, jnp.asarray(q),
                                    jnp.asarray(d))
        want.append(float(loss))
        got.append(float(step(_t(q), _t(d))))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert np.isfinite(got).all() and got[-1] < got[0]
