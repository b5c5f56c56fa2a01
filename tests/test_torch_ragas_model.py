"""The port's pydantic-free model base (evals/ragas/_model.py) against
pydantic 2, through the JAX package's judge framework.

* Every ``BaseModel`` subclass of the port's ``evals`` renders the same
  ``json.dumps(model_json_schema())`` as its JAX twin, key order
  included: the string the judge prompt embeds and the guided judge
  compiles into its DFA.
* Every few-shot example of every prompt dumps to the same JSON, and every
  prompt renders the same text for its examples' inputs.
* Hypothesis-generated JSON values, near each model's shape and not, are
  accepted or rejected alike (``model_validate`` and
  ``model_validate_json``), and accepted values dump alike.
* ``MultiTurnSample``'s dict routing (dataset.py's ``field_validator``)
  gives the same typed messages.
* Extra probe models cover what the framework's own classes do not use:
  float, bool, Literal, Any, Optional models and unions.
"""

import importlib
import inspect
import json
import math
import pkgutil
import sys
from typing import Any, Dict, List, Literal, Optional, Union

import pydantic
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import a_nice_rag_tpu.evals as jax_evals
import a_nice_rag_tpu_torch.evals as port_evals
from a_nice_rag_tpu_torch.evals.ragas import _model


def _walk(pkg):
    return [importlib.import_module(m.name) for m in
            pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def _classes(pkg, base):
    out = {}
    for mod in _walk(pkg):
        for name, obj in vars(mod).items():
            if (inspect.isclass(obj) and issubclass(obj, base)
                    and obj is not base and obj.__module__ == mod.__name__):
                out[mod.__name__.split(".evals.", 1)[1] + ":" + name] = obj
    return out


JAX_MODELS = _classes(jax_evals, pydantic.BaseModel)
PORT_MODELS = _classes(port_evals, _model.BaseModel)
MODEL_KEYS = sorted(JAX_MODELS)


def _prompts(root):
    prompt_mod = importlib.import_module(root + ".evals.ragas.prompt")
    evals = importlib.import_module(root + ".evals")
    return _classes(evals, prompt_mod.StructuredPrompt)


JAX_PROMPTS = _prompts("a_nice_rag_tpu")
PORT_PROMPTS = _prompts("a_nice_rag_tpu_torch")


def test_every_model_and_prompt_has_a_twin():
    assert len(JAX_MODELS) == 59
    assert sorted(PORT_MODELS) == MODEL_KEYS
    assert sorted(PORT_PROMPTS) == sorted(JAX_PROMPTS)
    assert len(JAX_PROMPTS) == 26


@pytest.mark.parametrize("key", MODEL_KEYS)
def test_json_schema_equal_byte_for_byte(key):
    ref = json.dumps(JAX_MODELS[key].model_json_schema())
    assert json.dumps(PORT_MODELS[key].model_json_schema()) == ref
    assert json.dumps(PORT_MODELS[key].model_json_schema(),
                      indent=None) == ref


@pytest.mark.parametrize("key", sorted(JAX_PROMPTS))
def test_prompt_examples_and_render_equal(key):
    ref, got = JAX_PROMPTS[key](), PORT_PROMPTS[key]()
    assert len(ref.examples) == len(got.examples)
    for (ri, ro), (gi, go) in zip(ref.examples, got.examples):
        assert gi.model_dump_json() == ri.model_dump_json()
        assert go.model_dump_json() == ro.model_dump_json()
        assert gi.model_dump() == ri.model_dump()
        assert got.render(gi) == ref.render(ri)
    if not ref.examples:
        data = {name: _minimal(f.annotation)
                for name, f in ref.input_model.model_fields.items()}
        assert (got.render(got.input_model(**data))
                == ref.render(ref.input_model(**data)))


def _minimal(tp):
    if tp is str:
        return "≥ 5 µg/kg"
    if tp is int:
        return 1
    origin = getattr(tp, "__origin__", None)
    if origin is list:
        return [_minimal(tp.__args__[0])]
    if origin is dict:
        return {"k": _minimal(tp.__args__[1])}
    return None


# -- hypothesis: accept/reject agreement and equal dumps -------------------

_scalars = (st.none() | st.booleans() | st.integers(-2**70, 2**70)
            | st.floats(allow_nan=False, allow_infinity=False)
            | st.text(max_size=12)
            | st.sampled_from(["1", " 2 ", "1.0", "1_000", "1.5", "yes",
                               "off", "inf", "-0", "", "0x1", "1e3"]))
_json = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(st.text(max_size=6), inner, max_size=4),
    max_leaves=12,
)


def _near(tp, depth=0):
    """Values shaped like ``tp`` most of the time, anything else now
    and then."""
    origin = getattr(tp, "__origin__", None)
    args = getattr(tp, "__args__", ())
    if isinstance(tp, type) and issubclass(tp, pydantic.BaseModel):
        if depth > 3:
            return _json
        return _obj(tp, depth + 1)
    if tp is str:
        shaped = st.text(max_size=20)
    elif tp is int:
        shaped = (st.integers(-2**66, 2**66)
                  | st.floats(-1e20, 1e20).map(float)
                  | st.integers(-99, 99).map(str))
    elif tp is float:
        shaped = (st.floats(allow_nan=False) | st.integers(-2**40, 2**40)
                  | st.sampled_from(["1.5", "1e3", "nan", "1_0.5"]))
    elif tp is bool:
        shaped = (st.booleans() | st.sampled_from([0, 1, 2, "yes", "No",
                                                   "t", 0.0, 1.5]))
    elif origin is list:
        shaped = st.lists(_near(args[0], depth + 1), max_size=4)
    elif origin is dict:
        shaped = st.dictionaries(st.text(max_size=6),
                                 _near(args[1], depth + 1), max_size=3)
    elif origin is Union:
        shaped = st.one_of([_near(a, depth + 1) for a in args])
    elif origin is Literal:
        shaped = st.sampled_from(list(args) + [True, 1.0, "1"])
    elif tp is type(None):
        shaped = st.none()
    else:
        shaped = _json
    return st.one_of(shaped, shaped, shaped, _json)


def _obj(model, depth=0):
    """Dicts with the model's keys: the required ones always (then the
    value is most often valid) or each only now and then."""
    fields = model.model_fields
    near = {name: _near(f.annotation, depth) for name, f in fields.items()}
    required = {n: s for n, s in near.items() if fields[n].is_required()}
    optional = {n: s for n, s in near.items() if n not in required}
    return (st.fixed_dictionaries(required,
                                  optional={**optional, "extra_key": _json})
            | st.fixed_dictionaries({}, optional={**near,
                                                  "extra_key": _json}))


def _outcome(model, value, as_json):
    try:
        obj = (model.model_validate_json(json.dumps(value)) if as_json
               else model.model_validate(value))
    except (pydantic.ValidationError, _model.ValidationError) as e:
        return ("rejected", sorted({err["type"] for err in e.errors()}))
    except TypeError as e:
        # dataset.py's routing validator looks a dict's "type"/"role"
        # up in a dict: an unhashable value raises in both packages.
        return ("raised", type(e).__name__)
    return ("ok", obj.model_dump_json(), _canon(obj.model_dump()))


def _canon(v):
    """model_dump() output comparable across packages (NaN-safe)."""
    if isinstance(v, float):
        return repr(v) if math.isnan(v) else v
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_canon(x) for x in v)
    return v


def _agree(jax_model, port_model, value):
    for as_json in (False, True):
        ref = _outcome(jax_model, value, as_json)
        got = _outcome(port_model, value, as_json)
        assert got == ref, (value, got, ref)


@pytest.mark.parametrize("key", MODEL_KEYS)
def test_hypothesis_values_validate_and_dump_alike(key):
    jax_model, port_model = JAX_MODELS[key], PORT_MODELS[key]

    @settings(max_examples=25, deadline=None, database=None,
              suppress_health_check=list(HealthCheck))
    @given(_obj(jax_model) | _json)
    def check(value):
        _agree(jax_model, port_model, value)

    check()


# -- probe models: what the framework's classes leave uncovered -----------


def _probe_models(BaseModel, Field):
    class Leaf(BaseModel):
        """A leaf.

            Its docstring is cleaned as pydantic cleans it.
        """

        x: int
        w: float = 0.5

    class Other(BaseModel):
        name: str
        flag: bool = False

    class Probe(BaseModel):
        f: float
        b: bool
        lit: Literal["yes", "no"]
        one: Literal["only"] = "only"
        num: Literal[0, 1] = Field(default=0, description="a 0/1 verdict")
        anything: Any = None
        leaf: Optional[Leaf] = None
        leaves: List[Leaf] = Field(default_factory=list)
        either: Union[Leaf, Other, None] = None
        table: Dict[str, List[float]] = {}
        maybe_lit: Optional[Literal["a", "b"]] = None

    return {"Leaf": Leaf, "Other": Other, "Probe": Probe}


JAX_PROBES = _probe_models(pydantic.BaseModel, pydantic.Field)
PORT_PROBES = _probe_models(_model.BaseModel, _model.Field)


@pytest.mark.parametrize("name", sorted(JAX_PROBES))
def test_probe_schema_equal(name):
    assert (json.dumps(PORT_PROBES[name].model_json_schema())
            == json.dumps(JAX_PROBES[name].model_json_schema()))


@pytest.mark.parametrize("name", sorted(JAX_PROBES))
def test_probe_hypothesis_agreement(name):
    jax_model, port_model = JAX_PROBES[name], PORT_PROBES[name]

    @settings(max_examples=60, deadline=None, database=None,
              suppress_health_check=list(HealthCheck))
    @given(_obj(jax_model) | _json)
    def check(value):
        _agree(jax_model, port_model, value)

    check()


@settings(max_examples=300, deadline=None, database=None)
@given(st.floats(allow_nan=True, allow_infinity=True))
def test_float_dump_matches_pydantic(x):
    ref = JAX_PROBES["Leaf"](x=1, w=x).model_dump_json()
    assert PORT_PROBES["Leaf"](x=1, w=x).model_dump_json() == ref


@pytest.mark.parametrize("text", [
    "≥ 140/90 mmHg", "5 µg/kg", "line\nbreak\ttab", "\x00\x1f\x7f",
    'quote " and \\ slash /', "emoji 🩺", "",
])
def test_strings_dump_raw_utf8(text):
    ref = JAX_PROBES["Other"](name=text).model_dump_json()
    got = PORT_PROBES["Other"](name=text).model_dump_json()
    assert got == ref
    if text and ord(max(text)) > 127:
        assert "\\u" not in got


@pytest.mark.parametrize("value,ok", [
    (1, True), ("1", True), (1.0, True), (1.5, False), (True, True),
])
def test_lax_int_coercion(value, ok):
    port = PORT_MODELS["ragas.metrics.faithfulness:StatementVerdict"]
    data = {"statement": "s", "reason": "r", "verdict": value}
    if ok:
        assert port.model_validate(data).verdict == 1
    else:
        with pytest.raises(_model.ValidationError) as e:
            port.model_validate(data)
        assert isinstance(e.value, ValueError)
        assert e.value.errors()[0]["type"] == "int_from_float"
    with pytest.raises(_model.ValidationError):
        port.model_validate({"statement": 1, "reason": "r", "verdict": 1})
    assert PORT_PROBES["Leaf"](x=1, w=2).w == 2.0


def test_multi_turn_dict_routing_matches():
    from a_nice_rag_tpu.evals.ragas.dataset import MultiTurnSample as JaxMT
    from a_nice_rag_tpu_torch.evals.ragas.dataset import (
        AIMessage,
        MultiTurnSample,
    )

    turns = [
        {"role": "user", "content": "dose?"},
        {"type": "ai", "content": "", "tool_calls": [
            {"name": "lookup", "args": {"drug": "amlodipine", "n": 2}}]},
        {"role": "tool", "content": "5 mg"},
        {"role": "assistant", "content": "5 mg daily"},
        {"role": "system", "content": "be brief", "metadata": {"k": 1}},
        AIMessage(content="kept as given"),
    ]
    jax_turns = [t if isinstance(t, dict) else
                 importlib.import_module(
                     "a_nice_rag_tpu.evals.ragas.dataset").AIMessage(
                         content=t.content) for t in turns]
    ref = JaxMT(user_input=jax_turns, reference="5 mg")
    got = MultiTurnSample(user_input=turns, reference="5 mg")
    assert ([type(m).__name__ for m in got.user_input]
            == [type(m).__name__ for m in ref.user_input]
            == ["HumanMessage", "AIMessage", "ToolMessage", "AIMessage",
                "Message", "AIMessage"])
    assert got.user_input[5] is turns[5]
    assert got.model_dump_json() == ref.model_dump_json()
    assert got.pretty_repr() == ref.pretty_repr()
    with pytest.raises(_model.ValidationError):
        MultiTurnSample(user_input=[{"role": "user"}])


def test_port_evals_import_no_pydantic():
    """The in-process half; test_torch_no_jax.py checks a fresh
    interpreter."""
    for mod in _walk(port_evals):
        for value in vars(mod).values():
            owner = getattr(value, "__module__", "") or ""
            assert not owner.startswith("pydantic"), (mod.__name__, value)
    assert "a_nice_rag_tpu_torch.evals.ragas._model" in sys.modules


# -- extract_json: the port's scan skips brackets inside JSON strings -----


@settings(max_examples=200, deadline=None, database=None)
@given(st.dictionaries(st.text(max_size=6), _json, max_size=4),
       st.sampled_from(["", "Here it is: ", "```json\n"]),
       st.sampled_from(["", " Done.", "\n```"]))
def test_extract_json_finds_every_document(doc, before, after):
    """Any JSON object, bare or wrapped in prose or a fence, comes back
    whole; where the JAX package's bracket count finds a document too, it
    is the same one."""
    from a_nice_rag_tpu.evals.ragas.prompt import extract_json as jax_extract
    from a_nice_rag_tpu_torch.evals.ragas.prompt import extract_json

    text = before + json.dumps(doc, ensure_ascii=False) + after
    got = extract_json(text)
    assert json.loads(got) == doc
    if not any(set(t) & set("{}[]`") for t in _strings(doc)):
        assert json.loads(jax_extract(text)) == doc


def _strings(v):
    """Every key and string value in a JSON value."""
    if isinstance(v, str):
        yield v
    elif isinstance(v, dict):
        for k, x in v.items():
            yield k
            yield from _strings(x)
    elif isinstance(v, list):
        for x in v:
            yield from _strings(x)


@pytest.mark.parametrize("verdict", [
    '{"statements":["}}}}","x"]}',
    '{"statements":["{{","[x]"]}',
    '{"question":"a \\" } b","noncommittal":0}',
])
def test_extract_json_skips_brackets_in_strings(verdict):
    """A guided verdict whose string holds a bracket: the port returns it
    whole, the JAX package's scan cuts it (a documented difference)."""
    from a_nice_rag_tpu.evals.ragas.prompt import extract_json as jax_extract
    from a_nice_rag_tpu_torch.evals.ragas.prompt import extract_json

    assert extract_json(verdict) == verdict
    assert jax_extract(verdict) != verdict
