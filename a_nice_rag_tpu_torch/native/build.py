"""Build the native host libraries with g++ and load them with ctypes.

Two C++ sources, copies of the JAX package's, each compiled on first use
into ``a_nice_rag_tpu_torch/_build/`` (gitignored), the library's name
keyed by a hash of its source, its headers and the flags, as
``ops/kernels/_build.py`` keys the CUDA libraries:

    g++ -O2 -shared -fPIC -std=c++17 -pthread \
        -o _build/libanr_serve_<hash>.so native/anr_serve.cpp
    g++ -O2 -shared -fPIC -std=c++17 \
        -o _build/libanr_text_<hash>.so native/anr_text.cpp

``anr_serve.cpp`` is the binary serving front; ``anr_text.cpp`` is the
BM25 text preprocessing of ``text.preprocess`` (its tables in
``anr_text_tables.h``, generated from that module by
:func:`regenerate_tables`). Each build writes a temporary file and
renames it into place, so processes that build at once are safe, and
nothing is built beside the sources. Without g++ (or when a build fails)
:func:`load_serve_lib` returns None and keeps the reason in
``build_error`` (the front then raises ``NativeFrontUnavailable``), and
:func:`load_text_lib` returns None, keeps the reason in
``text_build_error`` and logs it once at WARNING (``preprocess_text``
then takes its Python path, whose tokens are the same).

Regenerate the text tables with:
``python -m a_nice_rag_tpu_torch.native.build --tables``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence

logger = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
SERVE_SRC = _DIR / "anr_serve.cpp"
TEXT_SRC = _DIR / "anr_text.cpp"
TEXT_TABLES = _DIR / "anr_text_tables.h"
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
TEXT_GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_error: Optional[str] = None
_text_lock = threading.Lock()
_text_lib: Optional[ctypes.CDLL] = None
text_build_error: Optional[str] = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_U64, _I32 = ctypes.c_uint64, ctypes.c_int32


def _hashed_path(stem: str, files: Sequence[Path], flags) -> Path:
    h = hashlib.sha256()
    for f in files:
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _hashed_path("anr_serve", (SERVE_SRC,), GXX_FLAGS)


def text_library_path() -> Path:
    return _hashed_path("anr_text", (TEXT_SRC, TEXT_TABLES), TEXT_GXX_FLAGS)


def _build(src: Path, flags, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *flags, str(src), "-o", tmp],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {src.name} (exit "
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
                    _build(SERVE_SRC, GXX_FLAGS, out)
                _lib = _bind(ctypes.CDLL(str(out)))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                build_error = str(e)
                logger.info("native serve lib unavailable: %s", e)
    return _lib


def load_text_lib() -> Optional[ctypes.CDLL]:
    """The native text-preprocessing library, building it on first use;
    None when it cannot be built (``text_build_error`` says why; the
    first failure is logged at WARNING)."""
    global _text_lib, text_build_error
    if _text_lib is not None:
        return _text_lib
    with _text_lock:
        if _text_lib is None and text_build_error is None:
            out = text_library_path()
            try:
                if not out.exists():
                    _build(TEXT_SRC, TEXT_GXX_FLAGS, out)
                lib = ctypes.CDLL(str(out))
                lib.anr_preprocess.argtypes = [ctypes.c_char_p, _I,
                                               ctypes.c_char_p, _I]
                lib.anr_preprocess.restype = _I
                _text_lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                text_build_error = str(e)
                logger.warning("native text lib unavailable, preprocess_text "
                               "takes its Python path: %s", e)
    return _text_lib


def native_preprocess(text: str,
                      use_lemmatization: bool) -> Optional[List[str]]:
    """Tokenize through the native library; None when it is unavailable
    or when the output buffer would overflow (callers then take the
    Python path)."""
    lib = load_text_lib()
    if lib is None:
        return None
    raw = text.encode("utf-8", errors="ignore")
    cap = max(4096, 2 * len(raw) + 64)
    buf = ctypes.create_string_buffer(cap)
    n = lib.anr_preprocess(raw, int(use_lemmatization), buf, cap)
    if n < 0:
        return None
    if n == 0:
        return []
    return buf.raw[:n].decode("utf-8").rstrip("\n").split("\n")


def regenerate_tables(path: Path = TEXT_TABLES) -> None:
    """Write the C++ token tables from ``text.preprocess``, the Python
    source of truth."""
    from a_nice_rag_tpu_torch.text.lemma_calibration import CALIBRATED_LEMMAS
    from a_nice_rag_tpu_torch.text.preprocess import (
        _CONTRACTION_SPLITS,
        _IRREGULAR,
        _NO_LEMMA,
    )
    from a_nice_rag_tpu_torch.text.stopwords_en import STOPWORDS_EN

    with open(path, "w", encoding="utf-8") as f:
        f.write("// Generated from a_nice_rag_tpu_torch.text — do not edit "
                "by hand.\n")
        f.write("// Regenerate with: python -m "
                "a_nice_rag_tpu_torch.native.build --tables\n")
        f.write("#pragma once\n#include <unordered_set>\n")
        f.write("#include <unordered_map>\n#include <string>\n\n")
        words = ",\n  ".join(f'"{w}"' for w in sorted(STOPWORDS_EN))
        f.write(
            "static const std::unordered_set<std::string> kStopwords = {\n"
            f"  {words}\n}};\n\n"
        )
        nl = ",\n  ".join(f'"{w}"' for w in sorted(_NO_LEMMA))
        f.write(
            "static const std::unordered_set<std::string> kNoLemma = {\n"
            f"  {nl}\n}};\n\n"
        )
        irr = ",\n  ".join(
            f'{{"{k}", "{v}"}}' for k, v in sorted(_IRREGULAR.items())
        )
        f.write(
            "static const std::unordered_map<std::string, std::string> "
            f"kIrregular = {{\n  {irr}\n}};\n\n"
        )
        cal = ",\n  ".join(
            f'{{"{k}", "{v}"}}' for k, v in sorted(CALIBRATED_LEMMAS.items())
        )
        f.write(
            "static const std::unordered_map<std::string, std::string> "
            f"kCalibrated = {{\n  {cal}\n}};\n\n"
        )
        spl = ",\n  ".join(
            f'{{"{k}", {{"{a}", "{b}"}}}}'
            for k, (a, b) in sorted(_CONTRACTION_SPLITS.items())
        )
        f.write(
            "static const std::unordered_map<std::string, "
            "std::pair<std::string, std::string>> "
            f"kContractionSplits = {{\n  {spl}\n}};\n"
        )


if __name__ == "__main__":
    if "--tables" in sys.argv:
        regenerate_tables()
        print("tables regenerated")
    print("native text lib:", "OK" if load_text_lib() else text_build_error)
