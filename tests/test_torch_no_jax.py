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
                or m.startswith("jaxlib") or m.startswith("flax"))
print(len(names), leaked)
assert not leaked, leaked
"""


def test_port_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15, proc.stdout


def test_port_sources_hold_no_jax_or_tpu_kernel_code():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax)\b|pallas|torch\.compile",
        re.MULTILINE | re.IGNORECASE,
    )
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu")]
    assert files
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
         "a_nice_rag_tpu_torch.ops.kernels.int4"]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
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
    assert proc.stdout.split() == ["13"]
