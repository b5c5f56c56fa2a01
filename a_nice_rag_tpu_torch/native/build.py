"""Build the native serving front with g++ and load it with ctypes.

``anr_serve.cpp`` (a copy of the JAX package's front) is compiled on first
use into ``a_nice_rag_tpu_torch/_build/`` (gitignored), the library's name
keyed by a hash of the source and the flags, as ``ops/kernels/_build.py``
keys the CUDA libraries:

    g++ -O2 -shared -fPIC -std=c++17 -pthread \
        -o _build/libanr_serve_<hash>.so native/anr_serve.cpp

Nothing is built beside the source. Without g++ (or when the build fails)
:func:`load_serve_lib` returns None and keeps the reason in
``build_error``; the front then raises ``NativeFrontUnavailable``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
SERVE_SRC = _DIR / "anr_serve.cpp"
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_error: Optional[str] = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_U64, _I32 = ctypes.c_uint64, ctypes.c_int32


def library_path() -> Path:
    h = hashlib.sha256(SERVE_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libanr_serve_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, str(SERVE_SRC), "-o", tmp],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building anr_serve.cpp (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    sigs = {
        "anr_serve_start": ([ctypes.c_char_p] + [_I] * 6, _P),
        "anr_serve_port": ([_P], _I),
        "anr_serve_poll": ([_P, _I, ctypes.c_double, _P,
                            ctypes.POINTER(_I32), ctypes.POINTER(_U64),
                            ctypes.POINTER(_I32), _I, ctypes.c_double], _I),
        "anr_serve_queued_rows": ([_P], _I),
        "anr_serve_reply": ([_P, _U64, _I, _I, ctypes.POINTER(_I32),
                             ctypes.POINTER(ctypes.c_float)], _I),
        "anr_serve_reply_error": ([_P, _U64, ctypes.c_char_p], _I),
        "anr_serve_stats": ([_P] + [ctypes.POINTER(_U64)] * 3, None),
        "anr_serve_stop": ([_P], None),
        "anr_serve_free": ([_P], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def load_serve_lib() -> Optional[ctypes.CDLL]:
    """The native binary serving front, building it on first use; None
    when it cannot be built (``build_error`` says why)."""
    global _lib, build_error
    with _lock:
        if _lib is None and build_error is None:
            out = library_path()
            try:
                if not out.exists():
                    _build(out)
                _lib = _bind(ctypes.CDLL(str(out)))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                build_error = str(e)
                logger.info("native serve lib unavailable: %s", e)
    return _lib
