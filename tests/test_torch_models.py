"""The port's models (encoder, embedder, cross-encoder reranker, hashing
tokenizer) against the JAX package's, on the CPU.

Mirrors the inference cases of tests/test_models.py (the forward's unit
norm, the tokenizer, the embedder and reranker protocols); the training
and checkpoint cases wait for the port's training (ROADMAP item 9). Every
comparison runs the JAX module and the port's on the same params, carried
across by models.convert, on the same token ids: float32 within 1e-5,
bfloat16 with cosine >= 0.999 and abs <= 2e-2 (the two packages' bf16
elementwise ops round at different steps).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.models import EncoderConfig as JaxConfig
from a_nice_rag_tpu.models import HashingTokenizer as JaxTokenizer
from a_nice_rag_tpu.models import OnDeviceEmbedder as JaxEmbedder
from a_nice_rag_tpu.models import OnDeviceReranker as JaxReranker
from a_nice_rag_tpu.models import init_encoder as jax_init_encoder
from a_nice_rag_tpu.models.reranker import CrossEncoderReranker as JaxCE
from a_nice_rag_tpu_torch.models import (
    EncoderConfig,
    HashingTokenizer,
    MoEEncoderConfig,
    OnDeviceEmbedder,
    OnDeviceReranker,
    init_encoder,
    init_moe_encoder,
    init_reranker,
    load_hf_encoder,
    train_cross_encoder_reranker,
    train_nli_scorer,
)
from a_nice_rag_tpu_torch.models import qwen3 as port_qwen3
from a_nice_rag_tpu_torch.models.trainer import train_encoder
from a_nice_rag_tpu_torch.models.convert import (
    encoder_state_from_flax,
    reranker_state_from_flax,
)

SIZES = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=2, max_len=32,
             out_dim=64)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_ATOL = 1e-5
BF16_COS, BF16_ATOL = 0.999, 2e-2
TEXTS = ["hello world", "hypertension in adults", "",
         "Offer lifestyle advice to adults with hypertension; measure "
         "blood pressure in both arms at diagnosis (2 readings).",
         "stage 2 hypertension"]
DOCS = [{"id": str(i), "document": d} for i, d in enumerate([
    "blood pressure in adults with hypertension",
    "asthma action plans for children",
    "statins for the primary prevention of cardiovascular disease",
    "", "hypertension hypertension hypertension"])]


def _configs(dtype="f32", **kw):
    jdt, tdt = DTYPES[dtype]
    sizes = dict(SIZES, **kw)
    return JaxConfig(dtype=jdt, **sizes), EncoderConfig(dtype=tdt, **sizes)


def _ids(texts=TEXTS, max_len=16):
    return JaxTokenizer(vocab_size=SIZES["vocab_size"],
                        max_len=max_len).encode_batch(texts)


def _encoders(dtype="f32", seed=3, **kw):
    jcfg, cfg = _configs(dtype, **kw)
    model, params = jax_init_encoder(jcfg, seed)
    enc = init_encoder(cfg, device="cpu")
    enc.load_state_dict(encoder_state_from_flax(jax.device_get(params)))
    return (lambda ids: np.asarray(model.apply(params, jnp.asarray(ids))),
            lambda ids: enc(torch.as_tensor(ids)).detach().numpy(), params)


def _close_bf16(got, want):
    cos = (got * want).sum(-1) / np.maximum(
        np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1), 1e-12)
    live = np.linalg.norm(want, axis=-1) > 0
    assert cos[live].min() >= BF16_COS, cos
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("n_heads,mlp_ratio", [(2, 4), (4, 2)])
def test_encoder_f32_matches_jax(n_heads, mlp_ratio):
    jax_fn, port_fn, _ = _encoders(n_heads=n_heads, mlp_ratio=mlp_ratio)
    ids = _ids()
    np.testing.assert_allclose(port_fn(ids), jax_fn(ids), rtol=0,
                               atol=F32_ATOL)


def test_encoder_bf16_matches_jax():
    jax_fn, port_fn, _ = _encoders("bf16")
    ids = _ids()
    _close_bf16(port_fn(ids), jax_fn(ids))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_empty_text_embeds_to_zeros(dtype):
    """An all-padding row: a uniform softmax over masked keys (-1e30, not
    -inf), a zero pooled vector, a zero embedding; never NaN."""
    jax_fn, port_fn, _ = _encoders(dtype)
    ids = _ids(["", "one word"])
    got, want = port_fn(ids), jax_fn(ids)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], np.zeros(SIZES["out_dim"]))
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_allclose(np.linalg.norm(got[1]), 1.0, rtol=1e-5)


def test_encoder_forward_unit_norm_and_deterministic():
    enc = init_encoder(_configs()[1], seed=0, device="cpu")
    ids = torch.as_tensor(HashingTokenizer(1024, 16).encode_batch(
        ["hello world", "hypertension in adults"]))
    out = enc(ids).detach().numpy()
    assert out.shape == (2, 64)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(out, enc(ids).detach().numpy())
    again = init_encoder(_configs()[1], seed=0, device="cpu")
    np.testing.assert_array_equal(out, again(ids).detach().numpy())


@pytest.mark.parametrize("vocab,max_len", [(512, 8), (32768, 128),
                                           (1024, 7)])
def test_tokenizer_equals_jax(vocab, max_len):
    jt, pt = JaxTokenizer(vocab, max_len), HashingTokenizer(vocab, max_len)
    texts = TEXTS + ["x" * 300, " ".join(str(i) for i in range(200))]
    np.testing.assert_array_equal(pt.encode_batch(texts),
                                  jt.encode_batch(texts))
    docs = [d["document"] for d in DOCS] + texts[:2]
    pairs = pt.encode_pairs(texts, docs)
    np.testing.assert_array_equal(pairs, jt.encode_pairs(texts, docs))
    assert pairs.dtype == np.int32
    assert ((pairs == vocab - 1).sum(1) >= 1).all()  # a SEP in each row
    for t in texts:
        assert pt.encode(t) == jt.encode(t)


def test_hashing_tokenizer_deterministic_and_padded():
    tok = HashingTokenizer(vocab_size=512, max_len=8)
    assert tok.encode("stage 2 hypertension") == \
        tok.encode("stage 2 hypertension")
    batch = tok.encode_batch(["one", "a much longer sentence with words"])
    assert batch.shape == (2, 8) and batch[0, 1] == 0  # padding
    assert (tok.encode_pairs(["q"], ["d"])[0] == 511).sum() == 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_on_device_embedder_matches_jax(dtype):
    jcfg, cfg = _configs(dtype)
    jemb = JaxEmbedder(jcfg, seed=5)
    emb = OnDeviceEmbedder(cfg, state_dict=encoder_state_from_flax(
        jax.device_get(jemb.params)), device="cpu")
    got = emb.embed_queries(TEXTS)
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), 64)
    want = np.asarray(jemb.embed_queries(TEXTS))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        _close_bf16(got, want)
    np.testing.assert_array_equal(emb.embed_documents(TEXTS), got)


def test_on_device_embedder_from_threads():
    """embed_queries from 8 threads at once (the HTTP handlers' pattern)
    gives each thread the serial rows."""
    import sys

    emb = OnDeviceEmbedder(_configs()[1], device="cpu")
    want = {t: emb.embed_queries([t]) for t in TEXTS}
    got, errors = {}, []

    def work(i):
        try:
            for j in range(10):
                t = TEXTS[(i + j) % len(TEXTS)]
                got.setdefault((i, j), (t, emb.embed_queries([t])))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 80
    for t, vec in got.values():
        np.testing.assert_array_equal(vec, want[t])


@pytest.mark.parametrize("match", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_encoder_matches_jax(match, dtype):
    jcfg, cfg = _configs(dtype)
    tok = JaxTokenizer(SIZES["vocab_size"], 32)
    queries = ["hypertension adults", "asthma", "", "statins disease"] * 2
    docs = [d["document"] for d in DOCS][:4] * 2
    ids = tok.encode_pairs(queries, docs)
    model = JaxCE(jcfg, use_match_features=match)
    params = model.init(jax.random.PRNGKey(7), jnp.asarray(ids[:1]))
    want = np.asarray(model.apply(params, jnp.asarray(ids)))
    ce = init_reranker(cfg, device="cpu", use_match_features=match)
    ce.load_state_dict(reranker_state_from_flax(jax.device_get(params)))
    got = ce(torch.as_tensor(ids)).detach().numpy()
    assert got.shape == (8,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_ATOL if dtype == "f32" else BF16_ATOL)


def test_match_features_equal_jax():
    """The three features, token by token, on pairs with repeats across
    the SEP."""
    _, cfg = _configs()
    ce = init_reranker(cfg, device="cpu", use_match_features=True)
    ids = JaxTokenizer(1024, 16).encode_pairs(
        ["a b a c", "x"], ["a a d b", "y x x"])
    t = torch.as_tensor(ids)
    feats = ce.match_features(t, t > 0).numpy()
    # "a b a c" ; SEP ; "a a d b": each "a" matches twice, "b" once.
    np.testing.assert_allclose(feats[0, :4, 0], [1, 1, 1, 0])
    np.testing.assert_allclose(feats[0, :4, 1], np.log1p([2, 1, 2, 0]),
                               rtol=1e-6)
    np.testing.assert_array_equal(feats[0, :, 2], [0] * 4 + [1] * 12)


@pytest.mark.parametrize("match", [False, True])
def test_on_device_reranker_matches_jax(match):
    jcfg, cfg = _configs()
    jrr = JaxReranker(jcfg, seed=2, use_match_features=match)
    rr = OnDeviceReranker(cfg, state_dict=reranker_state_from_flax(
        jax.device_get(jrr.params)), use_match_features=match,
        device="cpu")
    q = ["blood pressure"] * len(DOCS)
    d = [x["document"] for x in DOCS]
    np.testing.assert_allclose(rr.score(q, d), np.asarray(jrr.score(q, d)),
                               rtol=0, atol=F32_ATOL)
    want = jrr.rerank("blood pressure", DOCS, top_k=3)
    got = rr.rerank("blood pressure", DOCS, top_k=3)
    assert [x["id"] for x in got] == [x["id"] for x in want]
    np.testing.assert_allclose([x["rerank_score"] for x in got],
                               [x["rerank_score"] for x in want], atol=1e-5)


def test_on_device_embedder_and_reranker():
    _, cfg = _configs()
    vecs = OnDeviceEmbedder(cfg, device="cpu").embed_queries(
        ["question one", "question two"])
    assert vecs.shape == (2, 64)
    rr = OnDeviceReranker(cfg, device="cpu")
    docs = [{"id": "a", "document": "text a"},
            {"id": "b", "document": "text b"}]
    out = rr.rerank("some query", docs, top_k=1)
    assert len(out) == 1 and "rerank_score" in out[0]
    out2 = rr.rerank("some query", docs)
    scores = [x["rerank_score"] for x in out2]
    assert scores == sorted(scores, reverse=True) and len(out2) == 2
    assert {x["id"] for x in out2} == {"a", "b"}


def test_convert_fills_every_parameter():
    """A strict load of each converted tree: no name missing or left over,
    every shape the port's."""
    jcfg, cfg = _configs(n_layers=3)
    _, params = jax_init_encoder(jcfg, 1)
    init_encoder(cfg, device="cpu").load_state_dict(
        encoder_state_from_flax(jax.device_get(params)), strict=True)
    sd = reranker_state_from_flax(
        JaxCE(jcfg, use_match_features=True).init(
            jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32)))
    ce = init_reranker(cfg, device="cpu", use_match_features=True)
    ce.load_state_dict(sd, strict=True)
    assert sd["match_proj.weight"].shape == (64, 3)
    assert sd["head.weight"].shape == (1, 64) and "head.bias" in sd


@pytest.mark.parametrize("make", [
    lambda: OnDeviceEmbedder(),
    lambda: OnDeviceReranker(),
    lambda: init_encoder(EncoderConfig()),
    lambda: init_moe_encoder(MoEEncoderConfig()),
    lambda: train_encoder(["q"], ["d"], batch_size=1),
    lambda: train_cross_encoder_reranker(["q"], [["a", "b"]]),
    lambda: train_nli_scorer(["p"], ["h"], np.ones(1)),
])
def test_entry_points_default_to_the_card(make, monkeypatch):
    """No device argument means the card; without one they raise rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_load_hf_encoder_not_cached(monkeypatch):
    def not_cached(name, device):
        raise OSError(f"{name} is not in the local cache")

    monkeypatch.setattr(port_qwen3, "load_hf_qwen3_encoder", not_cached)
    with pytest.raises(RuntimeError, match="not in the local cache"):
        load_hf_encoder("Qwen/Qwen3-Embedding-0.6B", device="cpu")
