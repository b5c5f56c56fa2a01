"""Measurement helpers, golden reference algorithms and synthetic data
for the port."""

from a_nice_rag_tpu_torch.testing.golden import (  # noqa: F401
    GoldenBm25Okapi,
    golden_dense_top_k,
    golden_wrrf,
)
from a_nice_rag_tpu_torch.testing.synth import (  # noqa: F401
    REFERENCE_QUALITY_NOISE,
    SynthCorpus,
    add_hard_distractors,
    calibrated_quality_corpus,
    calibrated_sample_queries,
    sample_queries,
    synth_corpus,
)
from a_nice_rag_tpu_torch.testing.timing import (  # noqa: F401
    chained_ms,
    cuda_event_ms,
    device_loop_ms,
    profiled_kernel_ms,
)
