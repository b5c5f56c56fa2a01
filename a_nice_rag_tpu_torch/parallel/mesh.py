"""Slot meshes (counterpart of ``a_nice_rag_tpu/parallel/mesh.py``).

The JAX package lays a corpus over a ``jax.sharding.Mesh`` and runs one
SPMD program over it. The port keeps the single controller: a
:class:`DeviceMesh` is a grid of *slots*, each bound to a
``torch.device``, and the sharded layer dispatches each shard's work to its
slot's device from the host. A slot, not a device, is the unit: slots may
share a device (a virtual mesh, as the JAX tests' 8 virtual CPU devices
are one CPU), and torch has one ``"cpu"`` device and, on a one-card
machine, one ``"cuda:0"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from a_nice_rag_tpu_torch.device import DeviceLike, require_cuda, resolve_device


@dataclasses.dataclass(frozen=True)
class Slot:
    """One position of a mesh: its number in the pool it came from and the
    device it runs on. Two slots on one device stay distinct."""

    index: int
    device: torch.device


def as_device(device: DeviceLike) -> torch.device:
    """``device`` checked to exist, with the CUDA index made explicit (so
    it compares equal to a tensor's ``.device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_slots(items: Sequence) -> Tuple[Slot, ...]:
    """Slots as they are; devices become slots numbered by position."""
    return tuple(x if isinstance(x, Slot) else Slot(i, as_device(x))
                 for i, x in enumerate(items))


class DeviceMesh:
    """A grid of slots with named axes (``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does)."""

    def __init__(self, slots: Sequence[Slot], shape: Sequence[int],
                 axis_names: Sequence[str]):
        self.slots = tuple(slots)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} does not match axes "
                             f"{tuple(axis_names)}")
        if int(np.prod(shape)) != len(self.slots):
            raise ValueError(f"mesh shape {tuple(shape)} does not cover "
                             f"{len(self.slots)} slots")
        if len(set(self.slots)) != len(self.slots):
            raise ValueError("a slot appears twice in the mesh")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(v) for v in shape)))

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Each slot's device, in slot order."""
        return tuple(s.device for s in self.slots)

    def slot_grid(self, *axes: Optional[str]) -> np.ndarray:
        """The slots as an array whose dimensions follow ``axes`` (None
        entries are skipped; an axis the mesh lacks has size 1). Every
        mesh axis must be named."""
        named = [a for a in axes if a is not None]
        extra = set(self.axis_names) - set(named)
        if extra:
            raise ValueError(f"mesh axes {sorted(extra)} have no role")
        grid = np.empty(len(self.slots), dtype=object)
        grid[:] = self.slots
        grid = grid.reshape(tuple(self.shape.values()))
        present = [a for a in named if a in self.shape]
        grid = grid.transpose([self.axis_names.index(a) for a in present])
        return grid.reshape(tuple(self.shape.get(a, 1) for a in named))

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]})")


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("dp", "corpus"),
    devices: Optional[Sequence[DeviceLike]] = None,
) -> DeviceMesh:
    """A mesh of one slot per entry of ``devices``.

    The default devices are every visible card, ``cuda:0 ... cuda:n-1``;
    without a GPU that raises (it never falls back to the CPU). Repeat a
    device to put several slots on it: ``devices=["cpu"] * 8`` or
    ``["cuda:0"] * 4`` is a virtual mesh. The default shape puts every
    slot on the last (corpus) axis with size 1 elsewhere; pass e.g.
    ``shape=(2, 4)`` to split eight slots into dp x corpus.
    """
    if devices is None:
        require_cuda()
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    slots = as_slots(list(devices))
    n = len(slots)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    return DeviceMesh(slots, shape, axis_names)
