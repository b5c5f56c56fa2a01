"""On-device models (the port of the JAX package's ``models/``): the
embedding encoder, the cross-encoder reranker, the NLI scorer, the
hashing tokenizer, the Qwen3 encoder with its HuggingFace weight import,
``convert`` for the JAX package's weights and optimizer state;
generation: ``decoder`` (the KV-cached Qwen3 decoder LM),
``speculative``, ``constrain`` (guided-decoding automata) and
``hf_tokenizer``; training: ``train`` (the contrastive step, one slot or
dp x tp x sp over a slot mesh), ``trainer``, ``checkpoint``,
``rerank_train``, ``pipeline`` (GPipe over dp x pp) and ``moe`` (expert
parallelism over dp x ep).

The reference delegates embedding, reranking and generation to SaaS APIs
(VoyageAI, OpenAI; src/search_engine.py:148-203, src/query_rag.py:434-513);
these modules are the fully local alternative.
"""

from a_nice_rag_tpu_torch.models.embedder import OnDeviceEmbedder  # noqa: F401
from a_nice_rag_tpu_torch.models.encoder import (  # noqa: F401
    EncoderConfig,
    TransformerEncoder,
    init_encoder,
    load_hf_encoder,
)
from a_nice_rag_tpu_torch.models.moe import (  # noqa: F401
    MoEEncoderConfig,
    MoETransformerEncoder,
    init_moe_encoder,
    make_moe_train_step,
)
from a_nice_rag_tpu_torch.models.nli import (  # noqa: F401
    NliScorer,
    nli_scorer_for_corpus,
    synth_nli_pairs,
    train_nli_scorer,
)
from a_nice_rag_tpu_torch.models.pipeline import (  # noqa: F401
    make_pipeline_forward,
    make_pipeline_train_step,
    merge_pipeline_params,
    split_pipeline_params,
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
from a_nice_rag_tpu_torch.models.rerank_train import (  # noqa: F401
    RerankTrainResult,
    mine_candidates,
    train_cross_encoder_reranker,
)
from a_nice_rag_tpu_torch.models.tokenizer import HashingTokenizer  # noqa: F401
from a_nice_rag_tpu_torch.models.train import (  # noqa: F401
    contrastive_loss,
    make_sharded_train_step,
    make_train_step,
)
