"""Text preprocessing for the BM25 path (counterpart of
``a_nice_rag_tpu.text``): lowercase, strip punctuation, tokenize, drop
stopwords, numerics and single characters, optional lemmatization."""

from a_nice_rag_tpu_torch.text.preprocess import (  # noqa: F401
    lemmatize,
    preprocess_text,
    preprocess_text_python,
    tokenize,
)
