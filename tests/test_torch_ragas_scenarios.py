"""Every scenario of the JAX package's judge-framework tests, run through
both packages in one process.

Each test function of test_ragas_eval.py, test_ragas_extended.py,
test_prompt_streaming.py, test_metric_train.py and test_integrations.py is
one case here. The case runs the JAX package's function as it stands, then
the same source with its imports pointed at the port
(``a_nice_rag_tpu_torch``, and ``_model`` in place of pydantic), so the
port must pass the same assertions. Both runs are recorded, and the
records must agree:

* every prompt ``StructuredPrompt.render`` produced, byte for byte;
* every prompt a scripted judge received (the repair prompt's ``Error:``
  line names the validator's own message, a known difference, and is
  masked);
* every score a metric returned, equal with NaN at the same places;
  the cosine-based metrics within 1e-6.

Records are compared as sorted multisets: the executor's workers finish in
an order the packages need not share.
"""

import importlib
import importlib.util
import inspect
import math
import re
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
MIRRORED = ("test_ragas_eval", "test_ragas_extended", "test_prompt_streaming",
            "test_metric_train", "test_integrations")
COSINE_METRICS = {"semantic_similarity", "answer_relevancy"}
_ERROR_LINE = re.compile(r"\nError: .*?\nReply with ONLY the corrected JSON\.",
                         re.DOTALL)


def _port_source(src: str) -> str:
    src = re.sub(r"\ba_nice_rag_tpu\.", "a_nice_rag_tpu_torch.", src)
    src = re.sub(r"\ba_nice_rag_tpu\b(?!_)", "a_nice_rag_tpu_torch", src)
    return re.sub(r"^(\s*)from pydantic import",
                  r"\1from a_nice_rag_tpu_torch.evals.ragas._model import",
                  src, flags=re.MULTILINE)


def _load(name: str, port: bool):
    key = f"_{'port' if port else 'jax'}_mirror_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = TESTS / f"{name}.py"
    if port:
        mod = types.ModuleType(key)
        mod.__file__ = str(path)
        sys.modules[key] = mod
        exec(compile(_port_source(path.read_text()), str(path), "exec"),
             mod.__dict__)
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def _cases():
    out = []
    for name in MIRRORED:
        src = (TESTS / f"{name}.py").read_text()
        for fn in re.findall(r"^def (test_\w+)\(", src, re.MULTILINE):
            out.append(pytest.param(name, fn, id=f"{name}::{fn}"))
    return out


class _Recorder:
    def __init__(self, root: str, mp: pytest.MonkeyPatch):
        self.rendered, self.judged, self.scores = [], [], []
        prompt = importlib.import_module(root + ".evals.ragas.prompt")
        llm = importlib.import_module(root + ".evals.ragas.llm")
        base = importlib.import_module(root + ".evals.ragas.metrics.base")
        rec = self

        render = prompt.StructuredPrompt.render

        def rendered(self, data):
            out = render(self, data)
            rec.rendered.append(out)
            return out

        agenerate = llm.FakeJudgeLLM.agenerate

        async def judged(self, prompt_text, n=1, temperature=1e-8):
            rec.judged.append(_ERROR_LINE.sub("\nError: <masked>",
                                              prompt_text))
            return await agenerate(self, prompt_text, n, temperature)

        single = base.SingleTurnMetric.single_turn_ascore
        multi = base.MultiTurnMetric.multi_turn_ascore

        async def single_scored(self, sample, timeout=None):
            out = await single(self, sample, timeout)
            rec.scores.append((self.name, out))
            return out

        async def multi_scored(self, sample, timeout=None):
            out = await multi(self, sample, timeout)
            rec.scores.append((self.name, out))
            return out

        mp.setattr(prompt.StructuredPrompt, "render", rendered)
        mp.setattr(llm.FakeJudgeLLM, "agenerate", judged)
        mp.setattr(base.SingleTurnMetric, "single_turn_ascore", single_scored)
        mp.setattr(base.MultiTurnMetric, "multi_turn_ascore", multi_scored)


def _run(fn, tmp_path: Path, tag: str, root: str):
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(root, mp)
        kwargs = {}
        for p in inspect.signature(fn).parameters:
            if p == "tmp_path":
                d = tmp_path / tag
                d.mkdir()
                kwargs[p] = d
            elif p == "monkeypatch":
                kwargs[p] = mp
            else:
                raise AssertionError(f"unhandled fixture {p}")
        fn(**kwargs)
    return rec


def _score_key(item):
    name, value = item
    return (name, repr(value))


def _assert_scores_equal(jax_scores, port_scores):
    assert len(jax_scores) == len(port_scores)
    for (jn, jv), (pn, pv) in zip(sorted(jax_scores, key=_score_key),
                                  sorted(port_scores, key=_score_key)):
        assert jn == pn
        jf, pf = float(jv), float(pv)
        if math.isnan(jf) or math.isnan(pf):
            assert math.isnan(jf) and math.isnan(pf), (jn, jv, pv)
        elif jn in COSINE_METRICS:
            assert abs(jf - pf) <= 1e-6, (jn, jv, pv)
        else:
            assert jf == pf, (jn, jv, pv)


@pytest.mark.parametrize("module,name", _cases())
def test_scenario_agrees_with_the_jax_package(module, name, tmp_path):
    jax_fn = getattr(_load(module, port=False), name)
    port_fn = getattr(_load(module, port=True), name)
    ref = _run(jax_fn, tmp_path, "jax", "a_nice_rag_tpu")
    got = _run(port_fn, tmp_path, "port", "a_nice_rag_tpu_torch")
    assert sorted(got.rendered) == sorted(ref.rendered)
    assert sorted(got.judged) == sorted(ref.judged)
    _assert_scores_equal(ref.scores, got.scores)


def test_port_sources_point_at_the_port():
    """The rewritten test modules import the port's judge framework and
    no pydantic, so the cases above really run the port."""
    for name in MIRRORED:
        mod = _load(name, port=True)
        roots = {getattr(v, "__module__", "") or "" for v in vars(mod).values()
                 if callable(v) or isinstance(v, types.ModuleType)}
        roots |= {v.__name__ for v in vars(mod).values()
                  if isinstance(v, types.ModuleType)}
        assert not any(r == "a_nice_rag_tpu" or r.startswith("a_nice_rag_tpu.")
                       or r.startswith("pydantic") for r in roots), name
        assert any(r.startswith("a_nice_rag_tpu_torch.evals") for r in roots)
