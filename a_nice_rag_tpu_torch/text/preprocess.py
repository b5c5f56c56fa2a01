"""Tokenization, stopword filtering, and lemmatization (the BM25 path's
text preprocessing).

Copy of the JAX package's ``text/preprocess.py``, which imports no jax;
pipeline parity with the reference system's
``src/processing/preprocess_bm25.py:33-52``:

1. lowercase
2. remove ASCII punctuation (string.punctuation translate), then map
   unicode quote marks to spaces
3. word-tokenize: a whitespace split with NLTK's contraction splits, or
   NLTK's own tokenizer when its "punkt" data is installed
4. drop stopwords, numeric tokens, and tokens of length <= 1
5. optional lemmatization: WordNet morphy when NLTK's "wordnet" data is
   installed, else the calibration overlay of observed NLTK outputs
   (``lemma_calibration.py``) over morphy-style suffix rules

Corpus and query sides always use the same implementation, so the BM25
token streams stay self-consistent. ``preprocess_text`` takes the native
C++ path (``native/anr_text.cpp``) for ASCII text where NLTK's data is
not installed; ``preprocess_text_python`` is the authoritative pure
path, and the two give the same tokens.
"""

from __future__ import annotations

import string
from typing import List, Optional

from a_nice_rag_tpu_torch.native.build import native_preprocess
from a_nice_rag_tpu_torch.text.lemma_calibration import CALIBRATED_LEMMAS
from a_nice_rag_tpu_torch.text.stopwords_en import STOPWORDS_EN

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)

# Unicode quote marks survive the ASCII punctuation strip; NLTK's
# word_tokenize then emits them as standalone 1-char tokens (splitting
# "women's" with a curly apostrophe into women + ' + s, the tail dropped
# by the length filter). Mapping them to spaces reproduces that. Dashes
# (- -- ...) are NOT separators: NLTK keeps "copd-osahs" joined.
_UNICODE_QUOTE_TABLE = str.maketrans(
    {"‘": " ", "’": " ", "“": " ", "”": " "}
)

# NLTK's word_tokenize (MacIntyreContractions) splits these even in
# punctuation-free text; after apostrophe deletion only the all-alpha
# patterns can still match. Reference behavior: "cannot" -> can + not
# (both stopwords, so the token disappears from BM25 streams).
_CONTRACTION_SPLITS = {
    "cannot": ("can", "not"),
    "gimme": ("gim", "me"),
    "gonna": ("gon", "na"),
    "gotta": ("got", "ta"),
    "lemme": ("lem", "me"),
    "wanna": ("wan", "na"),
}

# WordNet noun.exc-style irregular plurals (curated subset, clinical-heavy).
_IRREGULAR = {
    "children": "child",
    "women": "woman",
    "feet": "foot",
    "teeth": "tooth",
    "mice": "mouse",
    "lice": "louse",
    "geese": "goose",
    "people": "people",
    "criteria": "criterion",
    "phenomena": "phenomenon",
    "stimuli": "stimulus",
    "fungi": "fungus",
    "nuclei": "nucleus",
    "radii": "radius",
    "foci": "focus",
    "analyses": "analysis",
    "diagnoses": "diagnosis",
    "prognoses": "prognosis",
    "neuroses": "neurosis",
    "psychoses": "psychosis",
    "theses": "thesis",
    "hypotheses": "hypothesis",
    "crises": "crisis",
    "metastases": "metastasis",
    "emphases": "emphasis",
    "bacteria": "bacterium",
    "curricula": "curriculum",
    "indices": "index",
    "appendices": "appendix",
    "matrices": "matrix",
    "vertebrae": "vertebra",
    "larvae": "larva",
    "media": "medium",
    # True -ves plurals (WordNet noun.exc / lexicon-validated "ves"->"f"
    # outcomes). The blanket "ves"->"f" rule was removed: without a
    # lexicon check it mangles -ve singulars (initiatives -> initiatif);
    # plain "s"-stripping plus this table matches real NLTK far better.
    "calves": "calf",
    "dwarves": "dwarf",
    "elves": "elf",
    "halves": "half",
    "hooves": "hoof",
    "knives": "knife",
    "leaves": "leaf",
    "lives": "life",
    "loaves": "loaf",
    "scarves": "scarf",
    "selves": "self",
    "sheaves": "sheaf",
    "shelves": "shelf",
    "thieves": "thief",
    "wives": "wife",
    "wolves": "wolf",
}

# Words that look plural but are not (would be over-stripped by rules).
# "men"/"data" stay unchanged to match real-WordNet behavior (measured
# against the reference's NLTK-produced token CSVs).
_NO_LEMMA = frozenset(
    """
    this its is was has does news series species feces mumps measles
    rabies scabies herpes diabetes pertussis asthma gas bias atlas lens
    always perhaps physics mathematics genetics pediatrics obstetrics
    statistics ethics caries men data
    """.split()
)

# Morphy noun suffix rules. Order calibrated against real NLTK/WordNet
# outputs on the reference's 9.6k-query token CSVs: plain "s"-stripping
# handles -ses words better than WordNet's "ses"->"s" rule does without
# a lexicon check (causes->cause, doses->dose), -sis plurals live in the
# irregular table, and "sses"->"ss" precedes it (classes->class,
# processes->process).
_MORPHY_RULES = (
    ("sses", "ss"),
    ("ches", "ch"),
    ("shes", "sh"),
    ("xes", "x"),
    ("zes", "z"),
    ("ies", "y"),
    ("s", ""),
)

_nltk_word_tokenize = None
_nltk_lemmatizer = None


def _try_nltk() -> None:
    """Use real NLTK tokenization/lemmatization when its data is present."""
    global _nltk_word_tokenize, _nltk_lemmatizer
    if _nltk_word_tokenize is not None:
        return
    try:
        import nltk

        nltk.data.find("tokenizers/punkt")
        from nltk.tokenize import word_tokenize

        _nltk_word_tokenize = word_tokenize
    except Exception:
        _nltk_word_tokenize = False
    try:
        import nltk

        nltk.data.find("corpora/wordnet")
        from nltk.stem import WordNetLemmatizer

        _nltk_lemmatizer = WordNetLemmatizer()
    except Exception:
        _nltk_lemmatizer = False


def tokenize(text: str) -> List[str]:
    """Whitespace tokenization (input is already punctuation-free)."""
    _try_nltk()
    if _nltk_word_tokenize:
        return _nltk_word_tokenize(text)
    out: List[str] = []
    for tok in text.split():
        split = _CONTRACTION_SPLITS.get(tok)
        if split is None:
            out.append(tok)
        else:
            out.extend(split)
    return out


def _lemmatize_rules(token: str) -> str:
    """Rule-only morphy approximation (no calibration overlay).

    The calibration generator (scripts/gen_lemma_calibration.py) diffs
    THIS function against observed NLTK outputs, so it must not consult
    the calibration table itself.
    """
    if token in _IRREGULAR:
        return _IRREGULAR[token]
    if token in _NO_LEMMA or len(token) <= 3:
        return token
    # Guard: -ss, -us, -is endings are almost never simple plurals.
    if token.endswith(("ss", "us", "is")):
        return token
    for suffix, repl in _MORPHY_RULES:
        if token.endswith(suffix):
            lemma = token[: -len(suffix)] + repl
            if len(lemma) >= 2:
                return lemma
    return token


def lemmatize(token: str) -> str:
    """Noun lemmatization: WordNet morphy when available, else rules
    plus a calibration overlay of observed real-NLTK outputs (see
    text/lemma_calibration.py) — lexicon-membership decisions that
    suffix rules cannot reproduce without the WordNet data files."""
    _try_nltk()
    if _nltk_lemmatizer:
        return _nltk_lemmatizer.lemmatize(token)
    hit = CALIBRATED_LEMMAS.get(token)
    if hit is not None:
        return hit
    return _lemmatize_rules(token)


def preprocess_text(
    text: Optional[str], use_lemmatization: bool = False
) -> List[str]:
    """Full preprocessing pipeline (query and corpus sides).

    Routes ASCII inputs through the native C++ library
    (``native.build.native_preprocess``) when NLTK's data-backed tokenizer
    and lemmatizer are not installed and the library is built; the tokens
    are :func:`preprocess_text_python`'s. Without the library (its build
    error is in ``native.build.text_build_error``), or when its output
    would overflow, the Python path runs.
    """
    if not text:
        return []
    _try_nltk()
    if not _nltk_word_tokenize and not _nltk_lemmatizer and text.isascii():
        native = native_preprocess(text, use_lemmatization)
        if native is not None:
            return native
    return preprocess_text_python(text, use_lemmatization)


def preprocess_text_python(
    text: Optional[str], use_lemmatization: bool = False
) -> List[str]:
    """Pure-Python reference path (authoritative; used by parity tests)."""
    if not text:
        return []
    text = text.lower().translate(_PUNCT_TABLE).translate(
        _UNICODE_QUOTE_TABLE
    )
    tokens = [
        tok
        for tok in tokenize(text)
        if tok not in STOPWORDS_EN and not tok.isnumeric() and len(tok) > 1
    ]
    if use_lemmatization:
        tokens = [lemmatize(tok) for tok in tokens]
    return tokens
