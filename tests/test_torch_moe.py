"""The port's mixture-of-experts encoder (a_nice_rag_tpu_torch/models/moe.py)
against the JAX package's, on the CPU.

From the same params (carried across with ``convert.moe_state_from_flax``)
and tokens, the embeddings and the load-balance aux loss agree: within
1e-5 in float32; in bf16 the embeddings within 2e-3 and the aux loss
within 1e-3 (bf16 dispatch and expert products; the router is float32 in
both). Mirrors tests/test_moe_expert_parallel.py: a balanced aux loss,
capacity overflow falling back to the residual stream (and matching the
JAX package's), and expert-parallel training over dp x ep = 2 x 4 slots:
each slot holds E/ep experts, and the losses equal the one-slot step's
and the JAX package's within 2e-5 absolute (AdamW magnifies the
summation-order noise of near-zero gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from a_nice_rag_tpu.models.moe import MoEEncoderConfig as JaxConfig
from a_nice_rag_tpu.models.moe import init_moe_encoder as jax_init
from a_nice_rag_tpu.models.moe import make_moe_train_step as jax_step
from a_nice_rag_tpu_torch.models.convert import moe_state_from_flax
from a_nice_rag_tpu_torch.models.moe import (
    MoEEncoderConfig,
    MoEFFN,
    init_moe_encoder,
    make_moe_train_step,
    moe_param_shardings,
    route,
)
from a_nice_rag_tpu_torch.models.train import adamw, contrastive_loss
from a_nice_rag_tpu_torch.parallel import make_mesh

SIZES = dict(vocab_size=256, dim=64, n_layers=2, n_heads=2, max_len=32,
             out_dim=64, n_experts=4)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-3, 1e-3)}


def _pair(dtype="f32", seed=0):
    jdt, tdt = DTYPES[dtype][:2]
    model, params = jax_init(JaxConfig(**SIZES, dtype=jdt), seed=seed)
    port = init_moe_encoder(MoEEncoderConfig(**SIZES, dtype=tdt),
                            device="cpu")
    port.load_state_dict(moe_state_from_flax(jax.device_get(params)))
    return model, params, port


def _toks(seed=0, b=8):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 256, size=(b, 16)).astype(np.int32)
    t[1::2, 10:] = 0  # padding is neither routed nor counted
    return t


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_forward_and_aux_equal_jax(dtype):
    model, params, port = _pair(dtype)
    toks = _toks()
    want, want_aux = model.apply(params, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = port(torch.as_tensor(toks).long())
    _, _, atol, aux_atol = DTYPES[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)
    assert float(aux) == pytest.approx(float(want_aux), abs=aux_atol)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    assert 0.5 < float(aux) < 4.0  # ~1 balanced, >> 1 collapsed


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_capacity_overflow_drops_to_residual_as_jax(dtype):
    """All-identical tokens route to one expert, which overflows its
    capacity (max(1, int(1.25 * 16 / 4)) = 5): the overflow rows dispatch
    nowhere (the one-hot of slot ``cap`` dropped) and the output matches
    the JAX package's."""
    model, params, port = _pair(dtype)
    toks = np.full((4, 16), 7, np.int32)
    want, want_aux = model.apply(params, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = port(torch.as_tensor(toks).long())
        x = port.embed.weight[7].expand(4, 16, -1).float()
        dispatch, combine, stats = route(port.cfg, x, torch.ones(4, 16,
                                                               dtype=bool),
                                         port.blocks[0].ffn.router.weight)
    assert dispatch.shape == (4, 16, 4, 5)
    assert dispatch.sum((2, 3)).tolist() == [[1.0] * 5 + [0.0] * 11] * 4
    assert torch.isfinite(got).all()
    _, _, atol, aux_atol = DTYPES[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)
    assert float(aux) == pytest.approx(float(want_aux), abs=aux_atol)


def test_router_ties_take_the_first_expert():
    cfg = MoEEncoderConfig(**SIZES, dtype=torch.float32)
    x = torch.ones(1, 3, 64)
    dispatch, _, stats = route(cfg, x, torch.ones(1, 3, dtype=bool),
                               torch.zeros(4, 64))
    # All three route to expert 0 on the tie; its capacity,
    # max(1, int(1.25 * 3 / 4)) = 1, keeps the first.
    assert stats.tolist()[:4] == [3.0, 0.0, 0.0, 0.0]
    assert dispatch[0, :, 0, 0].tolist() == [1.0, 0.0, 0.0]


def test_moe_ffn_module_equals_jax():
    from a_nice_rag_tpu.models.moe import MoEFFN as JaxFFN

    jcfg = JaxConfig(**SIZES, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    valid = np.ones((2, 16), bool)
    valid[1, 9:] = False
    jffn = JaxFFN(jcfg)
    jp = jffn.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(valid))
    want, want_aux = jffn.apply(jp, jnp.asarray(x), jnp.asarray(valid))
    ffn = MoEFFN(MoEEncoderConfig(**SIZES, dtype=torch.float32))
    p = jax.device_get(jp)["params"]
    ffn.load_state_dict({
        "router.weight": torch.as_tensor(np.asarray(p["router"]["kernel"]).T),
        **{w: torch.as_tensor(np.asarray(p[w]))
           for w in ("w_gate", "w_up", "w_out")}})
    with torch.no_grad():
        got, aux = ffn(torch.as_tensor(x), torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-5)


def test_expert_parallel_training_matches_and_converges():
    model, params, port = _pair()
    q, d = (_toks(s) for s in (1, 2))
    tq, td = torch.as_tensor(q).long(), torch.as_tensor(d).long()
    one = _pair()[2]
    opt1 = adamw(one.parameters())
    want = []
    for _ in range(3):
        opt1.zero_grad()
        (qe, qa), (de, da) = one(tq), one(td)
        loss = contrastive_loss(qe, de)
        (loss + 0.01 * (qa + da)).backward()
        opt1.step()
        want.append(float(loss))
    mesh = make_mesh((2, 4), ("dp", "ep"), devices=["cpu"] * 8)
    step, slots, opt, layout = make_moe_train_step(port, None, mesh)
    assert layout == ("dp", None)
    got = [float(step(tq, td)) for _ in range(6)]
    np.testing.assert_allclose(got[:3], want, rtol=1e-5, atol=2e-5)
    assert got[-1] < got[0]
    jmesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("dp", "ep"))
    jstep, jp, jo, bs = jax_step(model, params, jmesh)
    jl = []
    for _ in range(3):
        jp, jo, loss = jstep(jp, jo, jax.device_put(jnp.asarray(q), bs),
                             jax.device_put(jnp.asarray(d), bs))
        jl.append(float(loss))
    np.testing.assert_allclose(got[:3], jl, rtol=1e-5, atol=2e-5)
    for idx in slots.index:  # each slot holds its E / ep = 1 experts
        for w in ("w_gate", "w_up", "w_out"):
            p = slots.params[idx][f"blocks.0.ffn.{w}"]
            assert p.shape[0] == 1
            assert opt.state[p]["exp_avg_sq"].shape == p.shape
        assert slots.params[idx]["embed.weight"].shape == (256, 64)


@pytest.mark.parametrize("ep,experts", [(4, 4), (2, 4), (4, 2)])
def test_ep_layout(ep, experts):
    """The stacked experts split over ep when E divides by it; every
    other parameter is replicated."""
    port = init_moe_encoder(MoEEncoderConfig(**dict(SIZES, n_experts=experts),
                                             dtype=torch.float32),
                            device="cpu")
    mesh = make_mesh((1, ep), ("dp", "ep"), devices=["cpu"] * ep)
    got = moe_param_shardings(port, mesh)
    for name, dim in got.items():
        if name.split(".")[-1] in ("w_gate", "w_up", "w_out"):
            assert dim == (0 if experts % ep == 0 else None), name
        else:
            assert dim is None, name
