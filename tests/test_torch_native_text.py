"""The port's native text path (``native/anr_text.cpp`` through
``native/build.py``) against the port's and the JAX package's pure-Python
``preprocess_text_python``, on the CPU.

Tokens must be equal, list for list: the native path is a host speed-up
with the Python path's output, never another tokenizer. The cases are
the JAX package's ``tests/test_native_text.py`` ``CASES``, its 500-fold
input, and seeded chunk texts (ASCII, as the native path takes only
ASCII). Its speed is recorded by ``chip_smoke.py`` phase 25 (b) on the
card's host, not asserted here. The tests need g++ and skip without it;
with g++ a failed build fails them.
"""

import importlib.util
import logging
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from a_nice_rag_tpu.text.preprocess import (
    preprocess_text_python as jax_preprocess_text_python,
)
from a_nice_rag_tpu_torch.native import build
from a_nice_rag_tpu_torch.text import preprocess
from a_nice_rag_tpu_torch.text.lemma_calibration import CALIBRATED_LEMMAS

TESTS = Path(__file__).resolve().parent
JAX_NATIVE = TESTS.parent / "a_nice_rag_tpu" / "native"


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native text path cannot "
                    "be built here")
    assert build.load_text_lib() is not None, build.text_build_error


def _jax_cases():
    key = "_jax_inputs_test_native_text"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, TESTS / "test_native_text.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key].CASES


def _seeded_chunk(seed):
    """A chunk-like ASCII text: clinical words, plurals, irregular and
    calibrated lemmas, stopwords, numbers, contractions, punctuation,
    markdown and mixed whitespace."""
    rng = np.random.default_rng(seed)
    words = (list(preprocess._IRREGULAR) + list(preprocess._NO_LEMMA)
             + sorted(CALIBRATED_LEMMAS)[::40]
             + list(preprocess._CONTRACTION_SPLITS)
             + "the of and patients doses classes boxes churches analyses "
               "ACE-inhibitors don't it's we're 42 3.5mg 1,000 a b x".split())
    seps = [" ", " ", " ", "  ", "\n", "\n\n", "\t", " - ", ", ", ". ",
            "; ", " (", ") ", " | ", " **", "** ", " [", "](", "# "]
    n = int(rng.integers(20, 400))
    picks = rng.choice(len(words), n)
    gaps = rng.choice(len(seps), n)
    text = "".join(words[w] + seps[g] for w, g in zip(picks, gaps))
    return text.upper() if seed % 7 == 0 else text


def _texts():
    return (list(_jax_cases())
            + ["patients with diabetes need regular blood pressure "
               "reviews " * 500]
            + [_seeded_chunk(s) for s in range(200)])


@pytest.mark.parametrize("lemma", [False, True])
def test_native_equals_both_python_paths(lemma):
    texts = _texts()
    assert all(t.isascii() for t in texts)
    for text in texts:
        native = build.native_preprocess(text, lemma)
        assert native == preprocess.preprocess_text_python(text, lemma), text
        assert native == jax_preprocess_text_python(text, lemma), text


def test_preprocess_text_takes_the_native_route(monkeypatch):
    calls = []

    def spy(text, lemma):
        calls.append(text)
        return build.native_preprocess(text, lemma)

    monkeypatch.setattr(preprocess, "native_preprocess", spy)
    monkeypatch.setattr(preprocess, "_nltk_word_tokenize", False)
    monkeypatch.setattr(preprocess, "_nltk_lemmatizer", False)
    ascii_text = "Offer statins to adults; review doses yearly."
    assert preprocess.preprocess_text(ascii_text, True) == \
        preprocess.preprocess_text_python(ascii_text, True)
    assert calls == [ascii_text]
    # Non-ASCII text (a curly apostrophe, a Unicode capital) takes Python.
    for text in ("women’s health", "Étude of children"):
        assert preprocess.preprocess_text(text, True) == \
            jax_preprocess_text_python(text, True)
    assert preprocess.preprocess_text("", True) == []
    assert calls == [ascii_text]
    # With NLTK's data installed the Python path (NLTK's tokenizer) runs.
    monkeypatch.setattr(preprocess, "_nltk_word_tokenize", str.split)
    preprocess.preprocess_text(ascii_text, False)
    assert calls == [ascii_text]


def test_overflow_and_a_failed_build_fall_back(monkeypatch, tmp_path,
                                               caplog):
    text = "cannot " * 4 + "stage hypertension"
    # An output overflow: the native call answers None, the Python path
    # the tokens.
    monkeypatch.setattr(build._text_lib, "anr_preprocess",
                        lambda *a: -1, raising=False)
    assert build.native_preprocess(text, False) is None
    monkeypatch.undo()
    want = preprocess.preprocess_text_python(text, True)

    def no_gxx(src, flags, out):
        raise RuntimeError("g++ failed building anr_text.cpp (exit 1)")

    monkeypatch.setattr(build, "_text_lib", None)
    monkeypatch.setattr(build, "text_build_error", None)
    monkeypatch.setattr(build, "text_library_path",
                        lambda: tmp_path / "libanr_text_missing.so")
    monkeypatch.setattr(build, "_build", no_gxx)
    with caplog.at_level(logging.WARNING, logger=build.__name__):
        assert preprocess.preprocess_text(text, True) == want
        assert preprocess.preprocess_text(text, True) == want
    assert build.text_build_error.startswith("g++ failed")
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 1 and "Python path" in warned[0].getMessage()


def test_library_lands_in_the_build_dir():
    path = build.text_library_path()
    assert path.parent == build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libanr_text_")
    assert not list(build.TEXT_SRC.parent.glob("*.so"))


def test_tables_regenerate_byte_for_byte(tmp_path):
    out = tmp_path / "tables.h"
    build.regenerate_tables(out)
    committed = build.TEXT_TABLES.read_bytes()
    assert out.read_bytes() == committed
    lines = committed.decode().splitlines(keepends=True)
    assert "a_nice_rag_tpu_torch" in lines[0] + lines[1]
    jax_lines = (JAX_NATIVE / "anr_text_tables.h").read_text(
        encoding="utf-8").splitlines(keepends=True)
    assert lines[2:] == jax_lines[2:]
    src = build.TEXT_SRC.read_text()
    jax_src = (JAX_NATIVE / "anr_text.cpp").read_text()
    assert src.splitlines()[3:] == jax_src.splitlines()[3:]
