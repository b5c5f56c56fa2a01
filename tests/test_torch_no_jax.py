"""The PyTorch port imports no jax, and carries no TPU-kernel code.

The import check runs in a fresh interpreter: this test process already
holds jax (tests/conftest.py imports it), so an in-process check would
prove nothing.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "a_nice_rag_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import a_nice_rag_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m.startswith("jaxlib") or m.startswith("flax")
                or m.startswith("ml_dtypes") or m.startswith("optax")
                or m.startswith("orbax")
                or m == "pydantic" or m.startswith("pydantic.")
                or m.startswith("pydantic_core")
                or m == "pandas" or m.startswith("pandas.")
                or m == "a_nice_rag_tpu" or m.startswith("a_nice_rag_tpu."))
print(len(names), leaked)
assert not leaked, leaked
missing = sorted(set(sys.argv[1:]) - set(names))
assert not missing, missing
"""
# The SearchEngine slice's, the reference-path slice's, the sharding
# slice's, the serving slice's, the models slice's, the generation
# slice's, the training and tensor-parallel slice's and the evaluation
# slice's modules (the judge framework on its pydantic-free model base),
# beside the earlier slices'.
SLICE_MODULES = [
    "a_nice_rag_tpu_torch." + m for m in (
        "config", "text", "text.preprocess", "text.stopwords_en",
        "text.lemma_calibration", "retrieval.engine", "retrieval.embed",
        "retrieval.rerank", "retrieval.eval_system", "testing.golden",
        "index.io", "index.manager", "testing.synth",
        "testing.reference_fixture", "ingest", "ingest.bm25_build",
        "ingest.import_reference", "ingest.bm25_tune", "ingest.query_prep",
        "evals", "evals.metrics", "evals.retrieval_eval",
        "evals.run_retrieval_eval", "evals.replay_reference", "utils",
        "utils.trace", "rag", "rag.prompts", "rag.providers", "rag.system",
        "parallel", "parallel.mesh", "parallel.sharded", "parallel.health",
        "parallel.engine", "ops.kernels.autotune", "utils.debugging",
        "native", "native.build", "serving", "serving.feedback",
        "serving.scheduler", "serving.native_front", "serving.webui",
        "serving.http_api", "serving.serve_cli", "serving.app", "models",
        "models.tokenizer", "models.encoder", "models.embedder",
        "models.reranker", "models.qwen3", "models.nli", "models.convert",
        "models.decoder", "models.speculative", "models.constrain",
        "models.hf_tokenizer", "serving.genserver", "parallel.lm",
        "models.train", "models.checkpoint", "models.trainer",
        "models.rerank_train", "models.pipeline", "models.moe",
        "evals.question_gen", "evals.run_ragas_eval", "evals.ragas",
        "evals.ragas._model", "evals.ragas.analytics", "evals.ragas.cache",
        "evals.ragas.cost", "evals.ragas.dataset", "evals.ragas.embeddings",
        "evals.ragas.evaluation", "evals.ragas.executor",
        "evals.ragas.integrations",
        "evals.ragas.integrations.amazon_bedrock",
        "evals.ragas.integrations.griptape",
        "evals.ragas.integrations.helicone",
        "evals.ragas.integrations.langchain",
        "evals.ragas.integrations.langgraph",
        "evals.ragas.integrations.langsmith",
        "evals.ragas.integrations.llama_index",
        "evals.ragas.integrations.opik", "evals.ragas.integrations.r2r",
        "evals.ragas.integrations.swarm", "evals.ragas.llm",
        "evals.ragas.losses", "evals.ragas.metrics",
        "evals.ragas.metrics.agentic",
        "evals.ragas.metrics.answer_correctness",
        "evals.ragas.metrics.answer_relevance",
        "evals.ragas.metrics.aspect_critic", "evals.ragas.metrics.base",
        "evals.ragas.metrics.context_precision",
        "evals.ragas.metrics.context_recall",
        "evals.ragas.metrics.entities_noise",
        "evals.ragas.metrics.faithfulness", "evals.ragas.metrics.misc",
        "evals.ragas.metrics.multimodal", "evals.ragas.metrics.nv_metrics",
        "evals.ragas.metrics.rubrics",
        "evals.ragas.metrics.semantic_similarity",
        "evals.ragas.metrics.string_metrics",
        "evals.ragas.metrics.summarization", "evals.ragas.optimizers",
        "evals.ragas.prompt", "evals.ragas.run_config",
        "evals.ragas.testset", "evals.ragas.validation")
]


def test_port_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, *SLICE_MODULES], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 149, proc.stdout


def test_port_sources_hold_no_jax_or_tpu_kernel_code():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|ml_dtypes|optax|orbax"
        r"|pydantic)\b"
    r"|pallas"
        r"|torch\.compile",
        re.MULTILINE | re.IGNORECASE,
    )
    files = [p for p in PKG.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh", ".cpp")
             and "_build" not in p.parts]
    assert any(p.suffix == ".cpp" for p in files)
    hits = [
        f"{p.relative_to(REPO)}: {m.group(0)!r}"
        for p in files for m in pattern.finditer(p.read_text())
    ]
    assert not hits, hits


_IMPORT_BENCH = """
import importlib, sys
names = ["chip_smoke", "a_nice_rag_tpu_torch.bench",
         "a_nice_rag_tpu_torch.probes.hbm_stream",
         "a_nice_rag_tpu_torch.probes.dma_overlap",
         "a_nice_rag_tpu_torch.probes.kernel_anatomy",
         "a_nice_rag_tpu_torch.probes.iteration_count",
         "a_nice_rag_tpu_torch.probes.bf16_fold",
         "a_nice_rag_tpu_torch.probes.int4",
         "a_nice_rag_tpu_torch.testing.synth",
         "a_nice_rag_tpu_torch.ops.kernels.stream",
         "a_nice_rag_tpu_torch.ops.kernels.anatomy",
         "a_nice_rag_tpu_torch.ops.kernels.keys",
         "a_nice_rag_tpu_torch.ops.kernels.int4",
         "a_nice_rag_tpu_torch.evals",
         "a_nice_rag_tpu_torch.evals.replay_reference",
         "a_nice_rag_tpu_torch.index.manager",
         "a_nice_rag_tpu_torch.ingest.bm25_tune",
         "a_nice_rag_tpu_torch.rag",
         "a_nice_rag_tpu_torch.testing.reference_fixture",
         "a_nice_rag_tpu_torch.utils.trace",
         "a_nice_rag_tpu_torch.ops.kernels.autotune",
         "a_nice_rag_tpu_torch.utils.debugging",
         "a_nice_rag_tpu_torch.serving.serve_cli",
         "a_nice_rag_tpu_torch.serving.native_front",
         "a_nice_rag_tpu_torch.serving.http_api",
         "a_nice_rag_tpu_torch.native.build",
         "a_nice_rag_tpu_torch.models"]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m.startswith("ml_dtypes")
                or m.startswith("a_nice_rag_tpu.") or m == "a_nice_rag_tpu")
assert not leaked, leaked
print(len(names))
"""


def test_bench_probes_and_smoke_import_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_BENCH], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["27"]
