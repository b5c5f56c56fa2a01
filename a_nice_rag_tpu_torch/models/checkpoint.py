"""Model checkpoints (the port of the JAX package's ``models/checkpoint.py``):
save / restore an encoder's or cross-encoder's parameters and optimizer
state for resumable training, in step-numbered directories with a
latest-step lookup.

The format is the port's own: ``{path}/{step}/state.pt``, one
``torch.save`` of ``{"params": state dict, "opt_state": optimizer state
dict}``, read back with ``weights_only=True`` (tensors and plain
containers only, no code). The JAX package writes orbax directories; its
``restore_checkpoint`` gives numpy arrays, which ``models.convert`` turns
into the port's state dicts.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Mapping, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str, step: int, params: Mapping[str, Any],
                    opt_state: Optional[Mapping] = None) -> str:
    """Write ``{path}/{step}`` atomically (a temporary directory beside it,
    then ``os.replace``; an existing step is replaced); returns the
    checkpoint dir."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    ckpt_dir = os.path.join(path, str(step))
    payload = {"params": dict(params)}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    tmp = tempfile.mkdtemp(prefix=f".{step}.tmp-", dir=path)
    try:
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(ckpt_dir):
            old = tempfile.mkdtemp(prefix=f".{step}.old-", dir=path)
            os.replace(ckpt_dir, os.path.join(old, "ckpt"))
            os.replace(tmp, ckpt_dir)
            shutil.rmtree(old)
        else:
            os.replace(tmp, ckpt_dir)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    return ckpt_dir


def latest_step(path: str) -> Optional[int]:
    """The largest step saved under ``path`` (None when there is none)."""
    try:
        steps = [int(d) for d in os.listdir(path) if d.isdigit()]
    except FileNotFoundError:
        return None
    return max(steps) if steps else None


def restore_checkpoint(path: str, step: Optional[int] = None,
                       template: Optional[Mapping[str, Any]] = None
                       ) -> Tuple[int, dict, Optional[dict]]:
    """Restore ``(step, params, opt_state)`` (the latest step unless
    given), on the CPU. ``template`` (a state dict) is matched by name: a
    missing or extra name or a shape mismatch raises ``ValueError``;
    otherwise each tensor takes the template's dtype and device, in the
    template's order."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    ckpt_dir = os.path.join(os.path.abspath(path), str(step))
    restored = torch.load(os.path.join(ckpt_dir, STATE_FILE),
                          map_location="cpu", weights_only=True)
    params = restored["params"]
    if template is not None:
        missing = [n for n in template if n not in params]
        extra = [n for n in params if n not in template]
        if missing or extra:
            raise ValueError(
                f"checkpoint at {ckpt_dir} has {len(params)} leaves but the "
                f"template has {len(template)}: missing={missing}, "
                f"extra={extra}")
        for name, want in template.items():
            got = params[name]
            if tuple(want.shape) != tuple(got.shape):
                raise ValueError(
                    f"checkpoint leaf {name} shape {tuple(got.shape)} != "
                    f"template shape {tuple(want.shape)}")
        params = {n: params[n].to(t.device, t.dtype)
                  for n, t in template.items()}
    return step, params, restored.get("opt_state")
