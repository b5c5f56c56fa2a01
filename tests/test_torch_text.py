"""The port's text preprocessing against the JAX package's pure-Python
path (``preprocess_text_python``, ``tokenize``, ``lemmatize``).

Token lists must be equal (no tolerance: the pipeline is string code):
contractions, ASCII punctuation and unicode quotes, numerics and short
tokens, stopwords, lemmas from the calibration table and the suffix
rules, and the optional NLTK hook.
"""

import string

import pytest

from a_nice_rag_tpu.text import preprocess as jax_pre
from a_nice_rag_tpu.text.lemma_calibration import (
    CALIBRATED_LEMMAS as JAX_LEMMAS,
)
from a_nice_rag_tpu.text.stopwords_en import STOPWORDS_EN as JAX_STOPWORDS
from a_nice_rag_tpu_torch.text import lemmatize, preprocess_text, tokenize
from a_nice_rag_tpu_torch.text import preprocess as pre
from a_nice_rag_tpu_torch.text.lemma_calibration import CALIBRATED_LEMMAS
from a_nice_rag_tpu_torch.text.stopwords_en import STOPWORDS_EN

TEXTS = [
    "What are the Recommended interventions, for adults?",
    "stage 2 hypertension in a b 42 patients",
    "don't smoke; I cannot gonna wanna gimme lemme gotta",
    "women’s health ‘quoted’ “double” quotes",
    "COPD-OSAHS overlap: 3.5mg 25s 17yearolds 2nd-line ½ dose",
    "Children's feet, teeth and mice; criteria for diagnoses and analyses",
    "classes processes causes doses studies boxes churches wishes buzzes",
    "diabetes status analysis class gas news series species bias lens",
    "the of and to in is was were be been being have has had do does",
    "knives leaves wolves initiatives calves halves lives thieves",
    "NHS carers bisphosphonates betablockers camhs alzheimers barretts",
    "  multiple   spaces\tand\ttabs\nand newlines  ",
    "café naïve résumé über § µg/kg ± ≤ 5",
    "x y z aa bb 1 22 333 a1 b2 ii iii",
    "",
]


@pytest.mark.parametrize("lemmas", [False, True])
@pytest.mark.parametrize("text", TEXTS)
def test_preprocess_text_matches_python_path(text, lemmas):
    assert preprocess_text(text, use_lemmatization=lemmas) == \
        jax_pre.preprocess_text_python(text, use_lemmatization=lemmas)


def test_empty_and_none():
    assert preprocess_text("") == [] and preprocess_text(None) == []


def test_reference_cases():
    # The JAX package's tests/test_text.py expectations.
    assert preprocess_text(
        "What are the Recommended interventions, for adults?") == [
        "recommended", "interventions", "adults"]
    assert preprocess_text("stage 2 hypertension in a b 42 patients") == [
        "stage", "hypertension", "patients"]
    assert preprocess_text("guidelines interventions medicines studies",
                           use_lemmatization=True) == [
        "guideline", "intervention", "medicine", "study"]
    assert preprocess_text("don't smoke") == ["dont", "smoke"]
    for word, lemma in [("children", "child"), ("criteria", "criterion"),
                        ("diagnoses", "diagnosis"), ("diabetes", "diabetes"),
                        ("status", "status"), ("analysis", "analysis"),
                        ("class", "class"), ("gas", "gas")]:
        assert lemmatize(word) == lemma


def test_tables_are_copies():
    assert STOPWORDS_EN == JAX_STOPWORDS
    assert CALIBRATED_LEMMAS == JAX_LEMMAS
    assert pre._IRREGULAR == jax_pre._IRREGULAR
    assert pre._NO_LEMMA == jax_pre._NO_LEMMA
    assert pre._MORPHY_RULES == jax_pre._MORPHY_RULES
    assert pre._CONTRACTION_SPLITS == jax_pre._CONTRACTION_SPLITS
    for ch in string.punctuation + "‘’“”":
        assert ch.translate(pre._PUNCT_TABLE).translate(
            pre._UNICODE_QUOTE_TABLE) == ch.translate(
            jax_pre._PUNCT_TABLE).translate(jax_pre._UNICODE_QUOTE_TABLE)


def test_lemmatize_matches_on_calibrated_and_rule_words():
    words = sorted(CALIBRATED_LEMMAS)
    words += [w + "s" for w in words[:200]] + [
        "boxes", "churches", "wishes", "buzzes", "classes", "babies", "is",
        "its", "ok", "abcs", "us", "virus", "crisis", "men", "data"]
    for w in words:
        assert lemmatize(w) == jax_pre.lemmatize(w), w
        assert pre._lemmatize_rules(w) == jax_pre._lemmatize_rules(w), w


def test_tokenize_matches():
    for text in TEXTS:
        low = text.lower().translate(pre._PUNCT_TABLE)
        assert tokenize(low) == jax_pre.tokenize(low)
    assert tokenize("cannot gonna") == ["can", "not", "gon", "na"]


def test_nltk_hook_is_used_when_its_data_is_present(monkeypatch):
    class Lemmatizer:
        def lemmatize(self, token):
            return token.upper()

    monkeypatch.setattr(pre, "_nltk_word_tokenize",
                        lambda text: text.split()[::-1])
    monkeypatch.setattr(pre, "_nltk_lemmatizer", Lemmatizer())
    assert preprocess_text("alpha beta gamma", use_lemmatization=True) == [
        "GAMMA", "BETA", "ALPHA"]
