"""Device meshes for sharded runs — the torch counterpart of
readbouncer_tpu/parallel/mesh.py.

The two parallel axes are the reference package's:

* ``data`` — read batches are data-parallel, and the basecaller trains
  data-parallel;
* ``bins`` — the IBF's bin axis is the tensor-parallel axis: each device
  holds a contiguous block of every filter row's words, and the
  per-filter maxima merge over the devices of a row.

``Mesh`` is the single-controller counterpart of ``jax.sharding.Mesh``:
one process drives every device of its mesh, one after another.  An
explicit device list may name one device several times (``["cpu"] * 8``
or ``[cuda:0] * 4``), as JAX's tests run on 8 virtual CPU devices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device

__all__ = ["Mesh", "parse_mesh_shape", "make_mesh", "DATA_AXIS", "BINS_AXIS"]

DATA_AXIS = "data"
BINS_AXIS = "bins"


def parse_mesh_shape(spec: str) -> dict[str, int]:
    """Parse a ``"data:4,bins:2"`` mesh spec (config key TPU.mesh_shape)."""
    out: dict[str, int] = {}
    if not spec:
        return out
    for part in spec.split(","):
        name, _, n = part.strip().partition(":")
        if not n:
            raise ValueError(f"mesh spec part {part!r} must be 'axis:count'")
        out[name.strip()] = int(n)
    return out


@dataclass(frozen=True)
class Mesh:
    """Named axes over an object array of ``torch.device``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, **index: int) -> torch.device:
        """The device at the given axis indices; an axis not named is
        taken at index 0 (replicated over it)."""
        return self.devices[tuple(index.get(a, 0) for a in self.axis_names)]


def make_mesh(
    shape: dict[str, int] | str | None = None,
    devices: list | None = None,
) -> Mesh:
    """A Mesh over ``devices`` (default: the visible CUDA cards; raises
    without one).

    Default shape: every device on the ``data`` axis with a size-1
    ``bins`` axis — pure data parallelism.
    """
    if isinstance(shape, str):
        shape = parse_mesh_shape(shape)
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if not shape:
        shape = {DATA_AXIS: n, BINS_AXIS: 1}
    total = math.prod(shape.values())
    if total != n:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {n}")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(tuple(shape.values())), tuple(shape.keys()))
