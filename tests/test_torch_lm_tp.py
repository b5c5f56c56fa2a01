"""The port's tensor-parallel generation (a_nice_rag_tpu_torch/parallel/lm.py
and ``GenerationServer(mesh=)``) against the JAX package's, on the CPU.

Mirrors tests/test_genserver_tp.py case by case: the port's server on a
2-slot ``["cpu"] * 2`` tp mesh and the JAX package's on 2 virtual CPU
devices, from the same weights (2 layers, hidden 128, float32; params
carried across with ``decoder_state_dict``), emit the same greedy streams
token for token, under staggered admission, speculative decoding, and
chunked prefill with a cached prefix; both equal the one-slot servers'.
The TP forward sums its partials in another order than the one-slot
forward, so logits agree within 1e-5 (float32) and greedy choices
exactly. Plus the Megatron split of each named weight and of the caches.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from a_nice_rag_tpu.models.decoder import init_decoder as jax_init
from a_nice_rag_tpu.models.decoder import small_lm_config as jax_config
from a_nice_rag_tpu.serving.genserver import _END as JAX_END
from a_nice_rag_tpu.serving.genserver import (
    GenerationServer as JaxGenerationServer,
)
from a_nice_rag_tpu_torch.models.convert import (
    decoder_state_dict,
    load_decoder_state,
)
from a_nice_rag_tpu_torch.models.decoder import (
    init_caches,
    init_decoder,
    lm_logits,
    small_lm_config,
)
from a_nice_rag_tpu_torch.parallel import make_mesh
from a_nice_rag_tpu_torch.parallel.lm import (
    lm_cache_sharding,
    lm_param_split,
    shard_lm_caches,
    shard_lm_params,
    validate_tp_config,
)
from a_nice_rag_tpu_torch.serving.genserver import _END, GenerationServer

DRAFT = dict(num_layers=1, hidden_size=64, intermediate_size=128)


@functools.lru_cache(maxsize=None)
def _pair(seed=0, draft=False):
    cfg = jax_config(**DRAFT) if draft else jax_config()
    model, params = jax_init(cfg, seed=seed)
    port = load_decoder_state(
        small_lm_config(**DRAFT) if draft else small_lm_config(),
        decoder_state_dict(jax.device_get(params)), device="cpu")
    return model, params, port


def _jax_mesh(tp=2):
    return Mesh(np.array(jax.devices()[:tp]), ("tp",))


def _mesh(tp=2):
    return make_mesh((tp,), ("tp",), devices=["cpu"] * tp)


def _collect(req, end):
    out = []
    while True:
        item = req.out.get_nowait()
        if item is end:
            return out
        out.append(item)


PROMPTS = [
    list(range(10, 26)),
    [256, 40, 41, 42, 43],
    list(range(60, 71)),
]
BUDGETS = [11, 7, 14]


def _run_staggered(srv, end):
    r0 = srv.submit(PROMPTS[0], BUDGETS[0])
    srv.tick()
    srv.tick()
    rest = [srv.submit(p, b) for p, b in zip(PROMPTS[1:], BUDGETS[1:])]
    srv.drain()
    return [_collect(r, end) for r in [r0, *rest]]


def test_tp_streams_match_single_device():
    model, params, port = _pair()
    want = _run_staggered(JaxGenerationServer(
        model, params, slots=2, max_len=64, chunk=4, mesh=_jax_mesh()),
        JAX_END)
    plain = GenerationServer(port, slots=2, max_len=64, chunk=4)
    tp = GenerationServer(port, slots=2, max_len=64, chunk=4, mesh=_mesh())
    assert tp.stats()["tensor_parallel"] == 2
    assert _run_staggered(tp, _END) == want
    assert _run_staggered(plain, _END) == want


def test_tp_speculative_decode_exact():
    model, params, port = _pair()
    dmodel, dparams, dport = _pair(3, True)
    want = _run_staggered(JaxGenerationServer(
        model, params, slots=2, max_len=64, draft_model=dmodel,
        draft_params=dparams, gamma=3, mesh=_jax_mesh()), JAX_END)
    tp = GenerationServer(port, slots=2, max_len=64, draft_model=dport,
                          gamma=3, mesh=_mesh())
    assert tp.draft.tp == 2 and len(tp._dkc) == 2
    assert _run_staggered(tp, _END) == want
    plain = GenerationServer(port, slots=2, max_len=64, chunk=4)
    assert _run_staggered(plain, _END) == want


def test_tp_chunked_prefill_and_prefix_cache_exact():
    model, params, port = _pair()
    prefix = list(range(100, 117))
    prompts = [prefix + [5, 6, 7], list(range(30, 55)), [256, 9, 8]]

    def run(srv, end):
        reqs = [srv.submit(p, 9) for p in prompts]
        srv.drain()
        return [_collect(r, end) for r in reqs]

    jtp = JaxGenerationServer(model, params, slots=3, max_len=64, chunk=4,
                              prefill_chunk=8, mesh=_jax_mesh())
    jtp.cache_prefix(prefix)
    want = run(jtp, JAX_END)
    tp = GenerationServer(port, slots=3, max_len=64, chunk=4,
                          prefill_chunk=8, mesh=_mesh())
    tp.cache_prefix(prefix)
    assert run(tp, _END) == want
    assert tp.prefix_hits == 1 == jtp.prefix_hits
    plain = GenerationServer(port, slots=3, max_len=64, chunk=4)
    assert run(plain, _END) == want


def test_tp_rejects_indivisible_config():
    cfg = small_lm_config(num_heads=4, num_kv_heads=1, intermediate_size=128)
    model = init_decoder(cfg, device="cpu")
    with pytest.raises(ValueError, match="num_kv_heads"):
        GenerationServer(model, slots=1, max_len=32, mesh=_mesh(2))
    with pytest.raises(ValueError, match="no axis 'tp'"):
        GenerationServer(_pair()[2], slots=1, max_len=32,
                         mesh=make_mesh((2,), ("dp",), devices=["cpu"] * 2))


@pytest.mark.parametrize("name,dim", [
    ("layers.0.self_attn.q_proj.weight", 0),
    ("layers.0.self_attn.k_proj.weight", 0),
    ("layers.0.self_attn.v_proj.weight", 0),
    ("layers.1.mlp.gate_proj.weight", 0),
    ("layers.1.mlp.up_proj.weight", 0),
    ("layers.0.self_attn.o_proj.weight", 1),
    ("layers.1.mlp.down_proj.weight", 1),
    ("layers.0.self_attn.q_norm.weight", None),
    ("layers.0.self_attn.k_norm.weight", None),
    ("layers.0.input_layernorm.weight", None),
    ("layers.0.post_attention_layernorm.weight", None),
    ("embed_tokens.weight", None),
    ("norm.weight", None),
])
def test_megatron_split_of_each_named_weight(name, dim):
    """The flax [in, out] pspecs transposed: P(None, "tp") is torch dim 0,
    P("tp", None) torch dim 1; every shard holds its slice of the full
    weight, and a replicated one the whole of it."""
    _, params, port = _pair()
    assert lm_param_split(name) == dim
    assert name in port.state_dict()
    tp = shard_lm_params(port, _mesh(2))
    full = port.state_dict()[name]
    got = [s.state_dict()[name] for s in tp.shards]
    if dim is None:
        for g in got:
            assert torch.equal(g, full)
    else:
        assert all(g.shape[dim] == full.shape[dim] // 2 for g in got)
        assert torch.equal(torch.cat(got, dim), full)


def test_gqa_heads_align_and_logits_match():
    """Slot i's q heads [i nh/tp, ...) read its kv heads [i nkv/tp, ...):
    the TP prefill logits equal the one-slot forward's (float32, summed
    in another order) and the caches hold each slot's kv heads."""
    port = _pair()[2]
    cfg = port.cfg
    mesh = _mesh(2)
    validate_tp_config(cfg, mesh)
    tp = shard_lm_params(port, mesh)
    assert tp.local_cfg.num_heads == cfg.num_heads // 2
    assert tp.local_cfg.num_kv_heads == cfg.num_kv_heads // 2
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 9)))
    want = lm_logits(port, ids)
    kc, vc = init_caches(cfg, 2, 9, "cpu")
    with torch.no_grad():
        port(ids, kc, vc, 0)
    skc, svc = tp.init_caches(2, 9)
    with torch.no_grad():
        got, _, _ = tp(ids, skc, svc, 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    wkc, wvc = shard_lm_caches(kc, vc, mesh)
    devices, dim = lm_cache_sharding(mesh)
    assert dim == 2 and len(devices) == 2
    assert len(skc) == cfg.num_layers * 2
    for a, b in zip(skc + svc, wkc + wvc):
        assert a.shape == b.shape == (2, 9, cfg.num_kv_heads // 2,
                                      cfg.head_dim)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_multi_card_probe_tp_parts_on_cpu_slots():
    """probes.multi_card's tensor-parallel parts at a tiny size on CPU
    slots (on the card they lay the decoder and the encoder's steps over
    distinct cards): both meshes give the same streams, losses and
    weights."""
    from a_nice_rag_tpu_torch.bench import GenConfig
    from a_nice_rag_tpu_torch.models.encoder import EncoderConfig
    from a_nice_rag_tpu_torch.probes import multi_card

    lm = GenConfig(vocab=512, hidden=64, layers=2, heads=4, kv_heads=2,
                   head_dim=16, mlp=128, dtype=torch.float32)
    enc = EncoderConfig(vocab_size=512, dim=32, n_layers=1, n_heads=2,
                        out_dim=32, dtype=torch.float32)
    out = multi_card.run_tp(["cpu"] * 2, "cpu", lm, enc, slots=4, chunk=4,
                            new_tokens=8, batch=4, seq=16)
    assert out["tp_decode"]["streams_equal"]
    for name in ("cards", "slots"):
        assert out["tp_decode"][name]["tokens"] == 4 * 8
        assert out["dp_tp_step"][name]["step_ms"] > 0
    assert out["dp_tp_step"]["equal"] and out["dp_tp_step"]["mesh"] == [1, 2]
    assert out["dp_tp_step"]["weights_max_abs_diff"] == 0.0
