"""On-device models (the port of the JAX package's ``models/``, the
inference half): the embedding encoder, the cross-encoder reranker, the
NLI scorer, the hashing tokenizer, the Qwen3 encoder with its
HuggingFace weight import, ``convert`` for the JAX package's weights,
and generation: ``decoder`` (the KV-cached Qwen3 decoder LM),
``speculative``, ``constrain`` (guided-decoding automata) and
``hf_tokenizer``.

The reference delegates embedding, reranking and generation to SaaS APIs
(VoyageAI, OpenAI; src/search_engine.py:148-203, src/query_rag.py:434-513);
these modules are the fully local alternative. Training and checkpoints
are not ported yet (ROADMAP item 9).
"""

from a_nice_rag_tpu_torch.models.embedder import OnDeviceEmbedder  # noqa: F401
from a_nice_rag_tpu_torch.models.encoder import (  # noqa: F401
    EncoderConfig,
    TransformerEncoder,
    init_encoder,
    load_hf_encoder,
)
from a_nice_rag_tpu_torch.models.nli import (  # noqa: F401
    NliScorer,
    nli_scorer_for_corpus,
    synth_nli_pairs,
    train_nli_scorer,
)
from a_nice_rag_tpu_torch.models.qwen3 import (  # noqa: F401
    Qwen3Config,
    Qwen3Encoder,
    convert_hf_qwen3,
    init_qwen3,
    load_hf_qwen3_encoder,
    load_qwen3_checkpoint_dir,
    load_qwen3_state,
)
from a_nice_rag_tpu_torch.models.reranker import (  # noqa: F401
    CrossEncoderReranker,
    OnDeviceReranker,
    init_reranker,
)
from a_nice_rag_tpu_torch.models.tokenizer import HashingTokenizer  # noqa: F401
