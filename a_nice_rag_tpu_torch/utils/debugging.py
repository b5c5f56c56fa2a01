"""Numerical debugging and determinism controls.

Counterpart of ``a_nice_rag_tpu/utils/debugging.py``. ``enable_debug``
traps non-finite values the way ``jax_debug_nans`` / ``jax_debug_infs``
do: a ``TorchDispatchMode`` checks every floating output of every op and
raises ``FloatingPointError`` naming the op. It reads each output back to
the host, so it syncs every op: debug only. ``deterministic_mode`` pins
PyTorch's deterministic algorithms and cuBLAS's workspace so repeated
runs bit-match.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

logger = logging.getLogger(__name__)


class _NonFiniteTrap(TorchDispatchMode):
    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf in the output of {func}")
        return out


_mode: Optional[_NonFiniteTrap] = None


def enable_debug(nans: bool = True, infs: bool = False) -> None:
    """Raise ``FloatingPointError`` at the first op whose output holds a
    NaN (``nans``) or an Inf (``infs``), on this thread."""
    global _mode
    disable_debug()
    if nans or infs:
        _mode = _NonFiniteTrap(nans, infs)
        _mode.__enter__()
    logger.info("debug flags: nans=%s infs=%s", nans, infs)


def disable_debug() -> None:
    global _mode
    if _mode is not None:
        _mode.__exit__(None, None, None)
        _mode = None


def deterministic_mode() -> None:
    """Bitwise determinism for repeated runs: deterministic algorithms
    (ops without one raise) and a fixed cuBLAS workspace, which must be
    set before the first cuBLAS call to take effect."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    logger.info("deterministic mode on")
