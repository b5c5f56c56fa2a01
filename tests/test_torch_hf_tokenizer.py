"""The port's copy of the HF tokenizer.json byte maps
(a_nice_rag_tpu_torch/models/hf_tokenizer.py) against the JAX package's,
and guided decoding lowered onto a multi-byte vocabulary in the port's
GenerationServer.

Mirrors tests/test_hf_tokenizer.py. The byte maps and the encodings equal
the JAX package's; the server's text stream through an ``HFTokenizer``
equals the JAX package's greedy ids decoded (its weights carried across
with ``decoder_state_dict``). Tests that need the ``tokenizers`` runtime
skip where it is absent; the byte maps never need it.
"""

import json

import jax
import pytest

from a_nice_rag_tpu.models import hf_tokenizer as jh
from a_nice_rag_tpu_torch.models import hf_tokenizer as th
from a_nice_rag_tpu_torch.models.constrain import (
    Constraint,
    compile_constraint,
    json_dfa,
)

B2U = th.bytes_to_unicode()
VOCAB = {10: b'{"', 11: b'a"', 12: b": ", 13: b"1", 14: b"23", 15: b"}",
         16: b'"yes"', 17: b" ", 18: b"\xc3\xa9", 19: b'":'}
TEXTS = ["offer antibiotics for sepsis", "café-au-lait — 500 mg",
         "{\"dose\": 500, \"ok\": true}", "中文 \U0001f600 tail"]


def _tok_str(data: bytes) -> str:
    return "".join(B2U[b] for b in data)


def _fixture(vocab_bytes, specials=()):
    """Minimal ByteLevel-BPE tokenizer.json."""
    vocab = {_tok_str(b): i for i, b in vocab_bytes.items()}
    for tid, name in specials:
        vocab[name] = tid
    return {"pre_tokenizer": {"type": "ByteLevel"},
            "decoder": {"type": "ByteLevel"},
            "added_tokens": [{"id": t, "content": n} for t, n in specials],
            "model": {"type": "BPE", "vocab": vocab}}


def _port_lm(vocab_size=None, seed=0):
    from a_nice_rag_tpu.models.decoder import init_decoder, small_lm_config
    from a_nice_rag_tpu_torch.models import decoder as td
    from a_nice_rag_tpu_torch.models.convert import (
        decoder_state_dict,
        load_decoder_state,
    )

    kw = {} if vocab_size is None else dict(vocab_size=vocab_size)
    model, params = init_decoder(small_lm_config(**kw), seed=seed)
    port = load_decoder_state(td.small_lm_config(**kw),
                              decoder_state_dict(jax.device_get(params)),
                              device="cpu")
    return model, params, port


def _train(path, corpus, vocab_size, specials):
    from tokenizers import (
        Tokenizer,
        decoders,
        models,
        pre_tokenizers,
        trainers,
    )

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=specials,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    tok.save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def trained_tok_path(tmp_path_factory):
    pytest.importorskip("tokenizers")
    corpus = [
        "NICE recommends offering antibiotics for suspected sepsis.",
        "The committee agreed the evidence on café-au-lait spots.",
        "metformin 500 mg twice daily with meals — see section 1.3",
        "{\"dose\": 500, \"unit\": \"mg\", \"ok\": true}",
        "中文文本 and emoji \U0001f600 mixed content",
    ] * 50
    return _train(tmp_path_factory.mktemp("hftok") / "tokenizer.json",
                  corpus, 420, ["<|endoftext|>", "<|im_end|>"])


def _marker_tok(tmp_path):
    return _train(tmp_path / "tokenizer.json",
                  ["offer antibiotics for sepsis"] * 30, 300,
                  ["<|endoftext|>", "<|im_start|>", "<|im_end|>"])


def test_byte_map_roundtrip_equals_jax():
    tok = _fixture(VOCAB, specials=[(500, "<|im_end|>")])
    tb, specials = th.hf_token_bytes(tok)
    assert (tb, specials) == jh.hf_token_bytes(tok)
    assert tb == VOCAB and 500 in specials and 500 not in tb


def test_non_byte_level_rejected():
    with pytest.raises(NotImplementedError):
        th.hf_token_bytes({"pre_tokenizer": {"type": "Metaspace"},
                           "decoder": {"type": "Metaspace"},
                           "model": {"type": "BPE", "vocab": {}}})


def test_load_from_dir(tmp_path):
    (tmp_path / "tokenizer.json").write_text(json.dumps(_fixture(VOCAB)))
    tb, _ = th.load_token_bytes(str(tmp_path))
    assert tb[10] == b'{"' and tb == jh.load_token_bytes(str(tmp_path))[0]


def test_multibyte_guided_generation():
    """A model over a BPE-piece vocabulary, JSON-object constrained in the
    port's server: the concatenated bytes of the emitted ids are always a
    live prefix of strict JSON, and parse on a natural stop."""
    from a_nice_rag_tpu_torch.serving.genserver import GenerationServer

    eos = 257
    dfa = json_dfa(top_level="object")
    _, _, port = _port_lm()
    con = compile_constraint(dfa, port.cfg.vocab_size, eos,
                             token_bytes=VOCAB, name="json_object")
    assert isinstance(con, Constraint)
    srv = GenerationServer(port, slots=2, max_len=96, chunk=4, eos_id=eos,
                           constraints={"json_object": con})
    try:
        for i in range(3):
            out = srv.complete([100 + i, 101], 16, constraint="json_object",
                               temperature=1.0)
            data = b"".join(VOCAB[t] for t in out["tokens"])
            s = 0
            for b in data:
                s = int(dfa.next[s, b])
                assert s >= 0, (out["tokens"], data)
            if out["finish_reason"] == "stop":
                json.loads(data.decode())
    finally:
        srv.stop()


def test_hf_tokenizer_encode_matches_runtime_and_jax(trained_tok_path):
    from tokenizers import Tokenizer

    hf = th.HFTokenizer(trained_tok_path)
    jhf = jh.HFTokenizer(trained_tok_path)
    rt = Tokenizer.from_file(trained_tok_path)
    for text in TEXTS:
        ids = hf.encode(text)
        assert ids == list(rt.encode(text, add_special_tokens=False).ids)
        assert ids == jhf.encode(text)
        assert hf.decode(ids) == text
    assert len(hf.encode(TEXTS[0])) < len(TEXTS[0].encode("utf-8"))
    assert hf.vocab_size == rt.get_vocab_size(with_added_tokens=True)
    assert hf.token_bytes == jhf.token_bytes


def test_hf_stream_decoder_incremental_equals_full(trained_tok_path):
    hf = th.HFTokenizer(trained_tok_path)
    for text in TEXTS:
        dec = hf.stream_decoder()
        got = "".join(filter(None, (dec.feed(i) for i in hf.encode(text))))
        assert got + dec.flush() == text
    dec = hf.stream_decoder()
    assert all(dec.feed(s) == "" for s in hf.specials)


def test_genserver_streams_text_through_hf_tokenizer(trained_tok_path):
    """stream_text(tokenizer=HFTokenizer) encodes the prompt with the
    checkpoint vocabulary and decodes the emitted ids through the byte
    map: the JAX package's greedy ids for the same weights, decoded."""
    from a_nice_rag_tpu.models.decoder import generate_stream
    from a_nice_rag_tpu_torch.serving.genserver import GenerationServer

    hf = th.HFTokenizer(trained_tok_path)
    model, params, port = _port_lm(vocab_size=hf.vocab_size)
    srv = GenerationServer(port, slots=2, max_len=128, chunk=4, eos_id=0)
    try:
        prompt = "offer antibiotics for sepsis"
        text = "".join(srv.stream_text(prompt, max_new_tokens=10,
                                       tokenizer=hf))
        ids = list(generate_stream(model, params, hf.encode(prompt),
                                   max_new_tokens=10, eos_id=0))
        assert text == hf.decode(ids)
    finally:
        srv.stop()


def test_chatml_rendering_lowers_onto_special_ids(tmp_path):
    pytest.importorskip("tokenizers")
    from a_nice_rag_tpu_torch.models.decoder import ByteTokenizer
    from a_nice_rag_tpu_torch.serving.http_api import render_chat_messages

    hf = th.HFTokenizer(_marker_tok(tmp_path))
    assert th.supports_chatml(hf)
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "sepsis?"}]
    rendered = render_chat_messages(msgs, tokenizer=hf)
    assert rendered == th.render_chatml(msgs) == jh.render_chatml(msgs)
    ids = hf.encode(rendered)
    im_s, im_e = hf.token_to_id("<|im_start|>"), hf.token_to_id("<|im_end|>")
    assert ids.count(im_s) == 3 and ids.count(im_e) == 2
    last_s = len(ids) - 1 - ids[::-1].index(im_s)
    last_e = len(ids) - 1 - ids[::-1].index(im_e)
    assert ids[0] == im_s and last_s > last_e
    assert not th.supports_chatml(ByteTokenizer())
    plain = render_chat_messages(msgs, tokenizer=ByteTokenizer())
    assert plain.endswith("assistant: ") and "<|im_start|>" not in plain


def test_supports_chatml_prefers_declared_chat_template(tmp_path):
    pytest.importorskip("tokenizers")
    _marker_tok(tmp_path)
    assert th.supports_chatml(th.HFTokenizer(str(tmp_path)))
    cfg_p = tmp_path / "tokenizer_config.json"
    cfg_p.write_text(json.dumps({"model_max_length": 1024}))
    hf = th.HFTokenizer(str(tmp_path))
    assert hf.chat_template is None and not th.supports_chatml(hf)
    cfg_p.write_text(json.dumps(
        {"chat_template": "{% for m in messages %}<|im_start|>"
                          "{{ m.role }}\n{{ m.content }}<|im_end|>\n"
                          "{% endfor %}"}))
    assert th.supports_chatml(th.HFTokenizer(str(tmp_path)))
    cfg_p.write_text(json.dumps(
        {"chat_template": "{% for m in messages %}[INST] {{ m.content }}"
                          " [/INST]{% endfor %}"}))
    hf = th.HFTokenizer(str(tmp_path))
    assert not th.supports_chatml(hf)
    hf.force_chatml = True
    assert th.supports_chatml(hf)


def test_local_client_truncation_preserves_chatml_ids(tmp_path,
                                                      monkeypatch):
    """LocalTpuLLMClient truncates long prompts at the id level: the ids
    handed to the decoder are exactly the tail of the full encoding and
    keep the open-assistant <|im_start|> marker."""
    pytest.importorskip("tokenizers")
    from a_nice_rag_tpu_torch.models import decoder as decoder_mod
    from a_nice_rag_tpu_torch.rag.providers import LocalTpuLLMClient

    _marker_tok(tmp_path)
    (tmp_path / "tokenizer_config.json").write_text(
        json.dumps({"chat_template": "<|im_start|>chatml"}))
    hf = th.HFTokenizer(str(tmp_path))
    captured = {}

    def fake_generate_stream(model, prompt_ids, **kw):
        captured["ids"] = list(prompt_ids)
        return iter([])

    monkeypatch.setattr(decoder_mod, "generate_stream",
                        fake_generate_stream)
    client = LocalTpuLLMClient(None, tokenizer=hf, max_prompt_tokens=24)
    msgs = [{"role": "user", "content": "offer antibiotics for sepsis " * 40}]
    list(client.stream_chat("local", msgs))
    ids = captured["ids"]
    assert len(ids) <= 24
    im_s, im_e = hf.token_to_id("<|im_start|>"), hf.token_to_id("<|im_end|>")
    last_s = len(ids) - 1 - ids[::-1].index(im_s)
    assert im_e not in ids or last_s > len(ids) - 1 - ids[::-1].index(im_e)
    assert ids == hf.encode(th.render_chatml(msgs))[-len(ids):]
