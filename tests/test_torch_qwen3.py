"""The port's Qwen3 encoder against the JAX package's and against
transformers' Qwen3Model, on the CPU.

Mirrors tests/test_qwen3_parity.py: a locally built random-init Qwen3Model
with the whole architecture exercised (GQA with num_kv_heads < num_heads,
a head_dim decoupled from hidden_size / num_heads, per-head q/k RMSNorm,
rope_theta 1e6, SwiGLU, causal attention), batches with left and right
padding, all three pools, the "model."-prefixed state dict, and the
safetensors checkpoint loader on single and sharded files. float32 within
1e-4 on the real tokens; bfloat16 against flax by cosine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.models.qwen3 import Qwen3Config as JaxConfig
from a_nice_rag_tpu.models.qwen3 import Qwen3Encoder as JaxEncoder
from a_nice_rag_tpu.models.qwen3 import convert_hf_qwen3 as jax_convert
from a_nice_rag_tpu_torch.models.convert import qwen3_state_from_flax
from a_nice_rag_tpu_torch.models.qwen3 import (
    Qwen3Config,
    Qwen3Encoder,
    convert_hf_qwen3,
    init_qwen3,
    load_qwen3_checkpoint_dir,
)

transformers = pytest.importorskip("transformers")

ATOL = 1e-4
SIZES = dict(vocab_size=211, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             head_dim=24,  # decoupled: 4 * 24 != 64
             intermediate_size=112, rope_theta=1_000_000.0,
             rms_norm_eps=1e-6)


def _tiny_hf_model(seed=0):
    from transformers import Qwen3Config as HFConfig
    from transformers import Qwen3Model

    torch.manual_seed(seed)
    hf_cfg = HFConfig(attention_dropout=0.0, **SIZES)
    return hf_cfg, Qwen3Model(hf_cfg).eval()


def _batch(seed=1):
    """Rows 0 and 2 left-padded, row 1 right-padded, row 3 whole."""
    rng = np.random.default_rng(seed)
    b, s = 4, 10
    ids = rng.integers(1, 200, size=(b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    mask[0, :3] = 0
    mask[1, 6:] = 0
    mask[2, :5] = 0
    ids = np.where(mask > 0, ids, 0)
    positions = np.maximum(np.cumsum(mask, axis=-1) - 1, 0)
    return ids, mask, positions


def _hf_hidden(model, ids, mask, positions):
    with torch.no_grad():
        return model(input_ids=torch.tensor(ids),
                     attention_mask=torch.tensor(mask),
                     position_ids=torch.tensor(positions)
                     ).last_hidden_state.numpy()


def _port(model, hf_cfg, pool="none", dtype=torch.float32, **kw):
    cfg = Qwen3Config.from_hf(hf_cfg, dtype=dtype)
    enc = init_qwen3(cfg, device="cpu", pool=pool, **kw)
    enc.load_state_dict(convert_hf_qwen3(model.state_dict(), cfg))
    return enc


def _run(enc, ids, mask):
    with torch.no_grad():
        return enc(torch.tensor(ids), torch.tensor(mask)).float().numpy()


def _jax(model, hf_cfg, ids, mask, pool="none", dtype=jnp.float32):
    cfg = JaxConfig.from_hf(hf_cfg, dtype=dtype)
    params = jax_convert(model.state_dict(), cfg)
    out = JaxEncoder(cfg, pool=pool).apply(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, bool))
    return np.asarray(out.astype(jnp.float32)), params


def test_hidden_states_match_torch():
    hf_cfg, model = _tiny_hf_model()
    ids, mask, positions = _batch()
    want = _hf_hidden(model, ids, mask, positions)
    got = _run(_port(model, hf_cfg), ids, mask)
    live = mask.astype(bool)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=ATOL)


def test_last_token_embedding_matches_torch_pooling():
    hf_cfg, model = _tiny_hf_model(seed=3)
    ids, mask, positions = _batch(seed=4)
    h = _hf_hidden(model, ids, mask, positions)
    last = np.array([np.nonzero(m)[0][-1] for m in mask])
    ref = h[np.arange(h.shape[0]), last]
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    got = _run(_port(model, hf_cfg, pool="last"), ids, mask)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("pool", ["last", "mean", "none"])
def test_pools_match_flax(pool):
    """The port against the JAX package's Qwen3Encoder on the same
    converted weights, through both converters (HF -> port, and flax ->
    port)."""
    hf_cfg, model = _tiny_hf_model(seed=2)
    ids, mask, _ = _batch(seed=5)
    want, params = _jax(model, hf_cfg, ids, mask, pool)
    got = _run(_port(model, hf_cfg, pool), ids, mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    cfg = Qwen3Config.from_hf(hf_cfg)
    enc = init_qwen3(cfg, device="cpu", pool=pool)
    enc.load_state_dict(qwen3_state_from_flax(jax.device_get(params)),
                        strict=True)
    np.testing.assert_allclose(_run(enc, ids, mask), want, rtol=0,
                               atol=ATOL)


def test_bf16_matches_flax():
    """cfg.dtype bfloat16 (weights float32, cast at use) against the JAX
    module at bfloat16: last-token embeddings, cosine >= 0.999."""
    hf_cfg, model = _tiny_hf_model(seed=4)
    ids, mask, _ = _batch(seed=6)
    want, _ = _jax(model, hf_cfg, ids, mask, "last", jnp.bfloat16)
    got = _run(_port(model, hf_cfg, "last", torch.bfloat16), ids, mask)
    assert ((got * want).sum(-1) >= 0.999).all()


def test_negative_ids_are_padding_without_a_mask():
    """No mask: ids below 0 are padding (clamped to 0 for the lookup),
    which equals passing the mask."""
    hf_cfg, model = _tiny_hf_model(seed=8)
    ids, mask, _ = _batch(seed=7)
    enc = _port(model, hf_cfg, "last")
    with torch.no_grad():
        got = enc(torch.tensor(np.where(mask > 0, ids, -1))).numpy()
    np.testing.assert_array_equal(got, _run(enc, ids, mask))


def test_causal_lm_prefixed_state_dict():
    """The converter takes Qwen3ForCausalLM-style 'model.'-prefixed keys
    and drops the LM head."""
    hf_cfg, model = _tiny_hf_model(seed=7)
    sd = {f"model.{k}": v for k, v in model.state_dict().items()}
    sd["lm_head.weight"] = torch.zeros(211, 64)
    cfg = Qwen3Config.from_hf(hf_cfg)
    out = convert_hf_qwen3(sd, cfg)
    assert out["embed_tokens.weight"].shape == (211, 64)
    assert "lm_head.weight" not in out
    with pytest.raises(KeyError):
        convert_hf_qwen3({"model.norm.weight": torch.ones(64)}, cfg)


def test_gqa_and_head_dim_shapes():
    hf_cfg, model = _tiny_hf_model()
    cfg = Qwen3Config.from_hf(hf_cfg)
    assert cfg.head_dim == 24 and cfg.num_kv_heads == 2
    sd = convert_hf_qwen3(model.state_dict(), cfg)
    assert sd["layers.0.self_attn.q_proj.weight"].shape == (96, 64)
    assert sd["layers.0.self_attn.k_proj.weight"].shape == (48, 64)
    assert sd["layers.0.self_attn.q_norm.weight"].shape == (24,)
    with pytest.raises(ValueError, match="pool"):
        Qwen3Encoder(cfg, pool="first")


def test_checkpoint_dir_loader_matches_torch(tmp_path):
    """load_qwen3_checkpoint_dir: safetensors -> the encoder without
    transformers, equal to the HF forward."""
    pytest.importorskip("safetensors")
    hf_cfg, model = _tiny_hf_model(seed=5)
    ckpt = tmp_path / "qwen3-tiny"
    model.save_pretrained(ckpt, safe_serialization=True)
    assert list(ckpt.glob("*.safetensors"))
    cfg, enc = load_qwen3_checkpoint_dir(str(ckpt), dtype=torch.float32,
                                         pool="none", device="cpu")
    assert cfg.num_layers == hf_cfg.num_hidden_layers
    assert enc.embed_tokens.weight.dtype == torch.float32
    ids, mask, positions = _batch(seed=9)
    want = _hf_hidden(model, ids, mask, positions)
    live = mask.astype(bool)
    np.testing.assert_allclose(_run(enc, ids, mask)[live], want[live],
                               rtol=0, atol=ATOL)


def test_checkpoint_dir_loader_sharded(tmp_path):
    """A sharded save (several safetensors files) loads identically."""
    pytest.importorskip("safetensors")
    hf_cfg, model = _tiny_hf_model(seed=6)
    one, many = tmp_path / "one", tmp_path / "many"
    model.save_pretrained(one, safe_serialization=True)
    model.save_pretrained(many, safe_serialization=True,
                          max_shard_size="100KB")
    assert len(list(many.glob("*.safetensors"))) > 1
    _, e1 = load_qwen3_checkpoint_dir(str(one), dtype=torch.float32,
                                      device="cpu")
    _, e2 = load_qwen3_checkpoint_dir(str(many), dtype=torch.float32,
                                      device="cpu")
    s1, s2 = e1.state_dict(), e2.state_dict()
    assert list(s1) == list(s2)
    for key in s1:
        assert torch.equal(s1[key], s2[key]), key
    with pytest.raises(FileNotFoundError):
        load_qwen3_checkpoint_dir(str(tmp_path), device="cpu")
