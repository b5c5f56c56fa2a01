"""Nothing under benchmark/ imports JAX or the JAX package; the reference
imports nothing of the port."""

import ast

import pytest

from benchmark.harness.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "a_nice_rag_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


FILES = sorted(p for p in BENCH_DIR.rglob("*.py")
               if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_top_level_names_compared_whole():
    # The port's name begins with the JAX package's and is allowed.
    assert "a_nice_rag_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    names = set(_imports(BENCH_DIR / "harness" / "reference.py"))
    assert not names & (FORBIDDEN | {"a_nice_rag_tpu_torch", "benchmark"})
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}
