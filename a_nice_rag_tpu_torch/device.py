"""Explicit device selection: no silent fallback from CUDA to the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """Return exactly the device asked for.

    A CUDA device is checked to exist; asking for one on a machine
    without a GPU raises instead of quietly running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) are visible"
            )
    return dev


def require_cuda() -> torch.device:
    """The current CUDA device; raises when no GPU is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA GPU is required here but torch.cuda.is_available() "
            "is False"
        )
    return torch.device("cuda", torch.cuda.current_device())
