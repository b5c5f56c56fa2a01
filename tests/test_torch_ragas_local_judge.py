"""The guided local judge (evals/ragas/llm.py ``LocalGuidedJudgeLLM``) of
the port against the JAX package's, on the CPU.

Both judges sit on their package's continuous-batching
``GenerationServer`` over the same 2-layer decoder (``small_lm_config``,
float32; the JAX params carried across with ``decoder_state_dict``).
Decoding is greedy: ``default_temperature=0.0`` turns the prompts' 1e-8
into argmax (a positive temperature samples, and each package draws its
own noise). Every schema-guided verdict string, every constraint name
the judges register and every score must be equal, NaN at the same
places; truncation raises ``LLMDidNotFinishException`` in both. Mirrors
tests/test_ragas_local_judge.py.

The framework's two other on-device pieces are held the same way:
``EmbedderJudgeEmbeddings`` over ``OnDeviceEmbedder`` (ResponseRelevancy's
cosines within 1e-5, the encoders' float32 parity) and
``FaithfulnesswithHHEM`` over ``NliScorer.score_batch`` (equal scores), each
on converted JAX params.
"""

import asyncio
import functools
import json
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np
import pydantic
import pytest
import torch

from a_nice_rag_tpu.evals.ragas import EvaluationDataset as JaxDataset
from a_nice_rag_tpu.evals.ragas import FakeJudgeEmbeddings as JaxEmb
from a_nice_rag_tpu.evals.ragas import FakeJudgeLLM as JaxFakeJudge
from a_nice_rag_tpu.evals.ragas import RunConfig as JaxRunConfig
from a_nice_rag_tpu.evals.ragas import evaluate as jax_evaluate
from a_nice_rag_tpu.evals.ragas.llm import (
    LLMDidNotFinishException as JaxDidNotFinish,
)
from a_nice_rag_tpu.evals.ragas.embeddings import (
    EmbedderJudgeEmbeddings as JaxEmbedderEmb,
)
from a_nice_rag_tpu.evals.ragas.llm import LocalGuidedJudgeLLM as JaxJudge
from a_nice_rag_tpu.evals.ragas.metrics import FaithfulnesswithHHEM as JaxHHEM
from a_nice_rag_tpu.evals.ragas.metrics import Faithfulness as JaxFaith
from a_nice_rag_tpu.evals.ragas.metrics import ResponseRelevancy as JaxRel
from a_nice_rag_tpu.evals.ragas.prompt import StructuredPrompt as JaxPrompt
from a_nice_rag_tpu.models import EncoderConfig as JaxEncConfig
from a_nice_rag_tpu.models import HashingTokenizer as JaxTokenizer
from a_nice_rag_tpu.models import OnDeviceEmbedder as JaxEmbedder
from a_nice_rag_tpu.models import nli as jax_nli
from a_nice_rag_tpu.models.decoder import init_decoder as jax_init
from a_nice_rag_tpu.models.reranker import CrossEncoderReranker as JaxCE
from a_nice_rag_tpu.models.decoder import small_lm_config as jax_config
from a_nice_rag_tpu.serving.genserver import GenerationServer as JaxServer
from a_nice_rag_tpu_torch.evals.ragas import (
    EvaluationDataset,
    FakeJudgeEmbeddings,
    FakeJudgeLLM,
    RunConfig,
    evaluate,
)
from a_nice_rag_tpu_torch.evals.ragas.embeddings import (
    EmbedderJudgeEmbeddings,
)
from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel
from a_nice_rag_tpu_torch.evals.ragas.llm import (
    LLMDidNotFinishException,
    LocalGuidedJudgeLLM,
)
from a_nice_rag_tpu_torch.evals.ragas.metrics import (
    Faithfulness,
    FaithfulnesswithHHEM,
    ResponseRelevancy,
)
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt
from a_nice_rag_tpu_torch.models import (
    EncoderConfig,
    HashingTokenizer,
    NliScorer,
    OnDeviceEmbedder,
    init_reranker,
)
from a_nice_rag_tpu_torch.models.convert import (
    decoder_state_dict,
    encoder_state_from_flax,
    load_decoder_state,
    reranker_state_from_flax,
)
from a_nice_rag_tpu_torch.models.decoder import small_lm_config
from a_nice_rag_tpu_torch.serving.genserver import GenerationServer

MAX_LEN = 2304
# Strings capped at 12 bytes and lists at 2 items: NLIOut's longest
# sentence (two verdicts, 9-digit integers) is ~165 bytes.
JUDGE = dict(max_tokens=256, max_string_len=12, max_items=2,
             default_temperature=0.0)

SAMPLES = [
    {"user_input": "How is stage 2 hypertension treated?",
     "response": "Offer drug treatment. Give lifestyle advice.",
     "retrieved_contexts": ["Offer antihypertensive drug treatment to "
                            "adults with stage 2 hypertension."]},
    {"user_input": "Dose of amlodipine?",
     "response": "No relevant NICE guidelines were found.",
     "retrieved_contexts": ["Amlodipine 5 mg once daily (≥ 18 years)."]},
]


@functools.lru_cache(maxsize=None)
def _weights(seed):
    model, params = jax_init(jax_config(), seed=seed)
    state = decoder_state_dict(jax.device_get(params))
    return model, params, state


def _port_server(slots=2, seed=0):
    port = load_decoder_state(small_lm_config(), _weights(seed)[2],
                              device="cpu")
    return GenerationServer(port, slots=slots, max_len=MAX_LEN, chunk=4)


def _servers(slots=2, seed=0):
    model, params, _ = _weights(seed)
    return (JaxServer(model, params, slots=slots, max_len=MAX_LEN, chunk=4),
            _port_server(slots, seed))


def _record(judge):
    texts = []
    one = judge._one

    def recorded(prompt, temperature, constraint):
        out = one(prompt, temperature, constraint)
        texts.append(out)
        return out

    judge._one = recorded
    return texts


def _verdict_prompt(base, prompt_base):
    """tests/test_ragas_local_judge.py's verdict prompt over ``base``
    (pydantic's or the port's): the class names enter the schema."""

    class _In(base):
        question: str
        answer: str

    class _Out(base):
        verdict: Literal[0, 1]
        label: Literal["yes", "no"]

    class _VerdictPrompt(prompt_base):
        instruction = "Judge whether the answer addresses the question."
        input_model = _In
        output_model = _Out

    return _VerdictPrompt()


def test_schema_guided_verdicts_equal_without_repair():
    jax_srv, port_srv = _servers()
    try:
        jp = _verdict_prompt(pydantic.BaseModel, JaxPrompt)
        pp = _verdict_prompt(BaseModel, StructuredPrompt)
        jj = JaxJudge(jax_srv, max_tokens=96, default_temperature=0.0)
        pj = LocalGuidedJudgeLLM(port_srv, max_tokens=96,
                                 default_temperature=0.0)
        jt, pt = _record(jj), _record(pj)
        data = dict(question="q?", answer="a.")
        ref = asyncio.run(jp.generate_multiple(
            jj, jp.input_model(**data), n=2, retries=0))
        got = asyncio.run(pp.generate_multiple(
            pj, pp.input_model(**data), n=2, retries=0))
        assert pt == jt and len(pt) == 2
        assert [g.model_dump() for g in got] == [r.model_dump() for r in ref]
        names = port_srv.stats()["constraints"]
        assert names == jax_srv.stats()["constraints"]
        assert len([n for n in names if n.startswith("schema:")]) == 1
    finally:
        jax_srv.stop()
        port_srv.stop()


def test_evaluate_faithfulness_and_relevancy_equal():
    # Seed 1's weights emit statements, so the NLI prompt (a list of
    # nested verdict objects) is judged too.
    jax_srv, port_srv = _servers(slots=4, seed=1)
    try:
        jj, pj = JaxJudge(jax_srv, **JUDGE), LocalGuidedJudgeLLM(port_srv,
                                                                  **JUDGE)
        jt, pt = _record(jj), _record(pj)
        ref = jax_evaluate(JaxDataset.from_list(SAMPLES),
                           [JaxFaith(), JaxRel()], llm=jj,
                           embeddings=JaxEmb(),
                           run_config=JaxRunConfig(max_retries=0),
                           raise_exceptions=True, show_progress=False)
        got = evaluate(EvaluationDataset.from_list(SAMPLES),
                       [Faithfulness(), ResponseRelevancy()], llm=pj,
                       embeddings=FakeJudgeEmbeddings(),
                       run_config=RunConfig(max_retries=0),
                       raise_exceptions=True, show_progress=False)
        assert sorted(pt) == sorted(jt) and len(pt) == 3 * len(SAMPLES)
        assert (port_srv.stats()["constraints"]
                == jax_srv.stats()["constraints"])
        for name in ("faithfulness", "answer_relevancy"):
            for r, g in zip(ref[name], got[name]):
                assert (g != g and r != r) or abs(g - r) <= 1e-6, (name,
                                                                  r, g)
        assert all(f == f for f in got["faithfulness"])
    finally:
        jax_srv.stop()
        port_srv.stop()


def test_truncation_raises_in_both():
    """A budget too small for any complete sentence surfaces as
    LLMDidNotFinishException, as the REST judges' truncation does."""
    jax_srv, port_srv = _servers()
    try:
        jp = _verdict_prompt(pydantic.BaseModel, JaxPrompt)
        pp = _verdict_prompt(BaseModel, StructuredPrompt)
        with pytest.raises(JaxDidNotFinish):
            asyncio.run(JaxJudge(jax_srv, max_tokens=3).agenerate(
                "judge this", temperature=0.0,
                schema=jp.output_model.model_json_schema()))
        with pytest.raises(LLMDidNotFinishException):
            asyncio.run(LocalGuidedJudgeLLM(port_srv, max_tokens=3).agenerate(
                "judge this", temperature=0.0,
                schema=pp.output_model.model_json_schema()))
    finally:
        jax_srv.stop()
        port_srv.stop()


def test_generic_json_constraint_self_registers():
    port_srv = _port_server()
    try:
        judge = LocalGuidedJudgeLLM(port_srv, constraint="json_object",
                                    max_tokens=64, auto_schema=False)
        text = asyncio.run(judge.agenerate("emit", n=1, temperature=1.0))[0]
        assert text.lstrip(" \t\n\r")[:1] == "{"
        assert "json_object" in port_srv.stats()["constraints"]
    finally:
        port_srv.stop()


ENC = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=2, max_len=128,
           out_dim=64)
DOCS = [
    "Offer lifestyle advice to adults with hypertension. Blood pressure "
    "should be measured in both arms at diagnosis. Treatment with ACE "
    "inhibitors is recommended for adults under 55 years.",
    "Methotrexate is the first-line DMARD for rheumatoid arthritis. "
    "Folic acid supplementation reduces methotrexate toxicity.",
]


def _scripted(prompt):
    if "self-contained statements" in prompt:
        return ('{"statements": ["Treatment with ACE inhibitors is '
                'recommended for adults under 55 years.", "Folic acid '
                'increases methotrexate toxicity.", "Blood pressure should '
                'be measured in both arms at diagnosis."]}')
    return '{"question": "Which drug for hypertension in adults?", ' \
           '"noncommittal": 0}'


def _rows():
    return [{"user_input": q, "response": "r", "retrieved_contexts": DOCS}
            for q in ("How is hypertension treated?", "Dose of folic acid?")]


def test_embedder_judge_embeddings_match():
    jemb = JaxEmbedder(JaxEncConfig(dtype=jnp.float32, **ENC), seed=5)
    emb = OnDeviceEmbedder(EncoderConfig(dtype=torch.float32, **ENC),
                           state_dict=encoder_state_from_flax(
                               jax.device_get(jemb.params)), device="cpu")
    ref = jax_evaluate(JaxDataset.from_list(_rows()), [JaxRel()],
                       llm=JaxFakeJudge(_scripted),
                       embeddings=JaxEmbedderEmb(jemb), show_progress=False)
    got = evaluate(EvaluationDataset.from_list(_rows()), [ResponseRelevancy()],
                   llm=FakeJudgeLLM(_scripted),
                   embeddings=EmbedderJudgeEmbeddings(emb),
                   show_progress=False)
    np.testing.assert_allclose(got["answer_relevancy"],
                               ref["answer_relevancy"], rtol=0, atol=1e-5)
    assert all(-1 <= v <= 1 and v != 0 for v in got["answer_relevancy"])


@pytest.mark.parametrize("per_context", [True, False])
def test_faithfulness_with_hhem_matches(per_context):
    jcfg = JaxEncConfig(dtype=jnp.float32, **ENC)
    model = JaxCE(jcfg, use_match_features=True)
    params = model.init(jax.random.PRNGKey(4), jnp.ones((1, 8), jnp.int32))
    jtok = JaxTokenizer(vocab_size=1024, max_len=128)
    ce = init_reranker(EncoderConfig(dtype=torch.float32, **ENC),
                       device="cpu", use_match_features=True)
    ce.load_state_dict(reranker_state_from_flax(jax.device_get(params)))
    scorer = NliScorer(ce, HashingTokenizer(vocab_size=1024, max_len=128))
    jscorer = jax_nli.NliScorer(model, params, jtok)
    # The threshold sits between the statements' two lowest scores, so
    # the verdicts go both ways and no score lies near it.
    statements = json.loads(_scripted("self-contained statements"))[
        "statements"]
    if per_context:
        per_stmt = scorer.score_batch(
            [c for _ in statements for c in DOCS],
            [t for t in statements for _ in DOCS]).reshape(3, 2).max(1)
    else:
        per_stmt = scorer.score_batch(["\n".join(DOCS)] * 3, statements)
    low = np.sort(per_stmt)
    assert low[1] - low[0] > 1e-4
    threshold = float(low[:2].mean())
    ref = jax_evaluate(
        JaxDataset.from_list(_rows()),
        [JaxHHEM(nli_scorer=jscorer, threshold=threshold,
                 per_context=per_context)],
        llm=JaxFakeJudge(_scripted), show_progress=False)
    got = evaluate(
        EvaluationDataset.from_list(_rows()),
        [FaithfulnesswithHHEM(nli_scorer=scorer, threshold=threshold,
                              per_context=per_context)],
        llm=FakeJudgeLLM(_scripted), show_progress=False)
    assert (got["faithfulness_with_hhem"]
            == ref["faithfulness_with_hhem"])
    assert got["faithfulness_with_hhem"] == [2 / 3, 2 / 3]
