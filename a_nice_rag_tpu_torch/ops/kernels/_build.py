"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>_<hash>.so csrc/<name>.cu

The library lands in ``a_nice_rag_tpu_torch/_build/`` keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds. :func:`load_all` runs one nvcc per
source, all at once. nvcc is found through ``CUDA_HOME`` or ``PATH``;
without it the build raises. Only sources inside this package are ever
built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, Tuple[float, str]] = {}  # name -> (seconds, ptxas report)


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on "
        "PATH to build the a_nice_rag_tpu_torch kernels"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log[name] = (time.perf_counter() - t0, proc.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


def load_all(names: Sequence[str]) -> None:
    """Build every named source at once (one nvcc each), then load them."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(build, names))
    for name in names:
        load(name)
