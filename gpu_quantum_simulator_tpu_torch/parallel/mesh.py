"""Device meshes: a list of torch devices shaped like the JAX package's Mesh.

The JAX package's mesh has a single controller: one process drives every
device, and ``Simulator.run`` returns the whole state in that process.
The port keeps that: one process holds one shard pair a device of the
mesh.  A device may appear more than once (``["cuda:0"] * 8``, or
``["cpu"] * 8`` in the tests, the counterpart of the JAX tests' eight
virtual CPU devices), so a mesh runs on one card too; shards on distinct
cards exchange their halves by peer copies.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.apply import resolve_device


class Mesh:
    """``devices``: a numpy object array of torch devices shaped like the
    mesh; ``axis_names`` name its axes; ``shape[axis]`` is an axis' size,
    as in JAX."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} axes, names "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def device_list(self) -> list:
        """The devices in shard order (row-major over the axes)."""
        return list(self.devices.flat)

    @property
    def key(self) -> tuple:
        """A hashable key of the mesh: names, shape and device list."""
        return (self.axis_names, tuple(self.devices.shape),
                tuple(str(d) for d in self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def visible_devices(device="cuda") -> list:
    """Every visible device of ``device``'s type: the CUDA cards (a
    RuntimeError on a host without one, no fallback), or the one CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("amp",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh; default = all devices on one 'amp' axis, cut down to a
    power of two (the state-vector axis must shard 2^d ways).  ``devices``
    defaults to every visible CUDA card and may repeat a device."""
    devices = [resolve_device(d) for d in (
        devices if devices is not None else visible_devices("cuda"))]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        d = 1 << int(math.log2(len(devices)))
        shape = (d,)
        devices = devices[:d]
    total = int(np.prod(shape))
    if total > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {total} devices, "
                         f"have {len(devices)}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(shape), axis_names)


def num_global_qubits(mesh: Mesh, axis: str = "amp") -> int:
    size = mesh.shape[axis]
    d = int(math.log2(size))
    if (1 << d) != size:
        raise ValueError(f"mesh axis {axis!r} size {size} must be a power of two")
    return d
