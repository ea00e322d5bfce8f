"""Device meshes for sharded runs — the torch counterpart of
readbouncer_tpu/parallel/mesh.py.

The two parallel axes are the reference package's:

* ``data`` — read batches are data-parallel, and the basecaller trains
  data-parallel;
* ``bins`` — the IBF's bin axis is the tensor-parallel axis: each device
  holds a contiguous block of every filter row's words, and the
  per-filter maxima merge over the devices of a row.

``Mesh`` is the counterpart of ``jax.sharding.Mesh``.  Each cell knows
the rank of the process that owns it; a process drives its own cells, one
after another.  Inside a process group ``make_mesh`` builds over every
process's devices (``distributed.global_devices``), as JAX's builds over
``jax.devices()``, so a mesh may span processes; an explicit list of
plain devices stays this process's.  A device list may name one device
several times (``["cpu"] * 8`` or ``[cuda:0] * 4``), as JAX's tests run
on 8 virtual CPU devices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.parallel.distributed import RankDevice, global_devices, process_count, process_index

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
    """Named axes over an object array of ``torch.device`` and an int
    array, of the same shape, of the rank owning each cell."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    ranks: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return len(set(self.ranks.flat)) > 1

    def _at(self, index: dict[str, int]) -> tuple[int, ...]:
        # an axis not named is taken at index 0 (replicated over it)
        return tuple(index.get(a, 0) for a in self.axis_names)

    def device_at(self, **index: int) -> torch.device:
        """The device at the given axis indices, as its owning rank names
        it."""
        return self.devices[self._at(index)]

    def owns(self, **index: int) -> bool:
        """Whether this process owns the cell at the given axis indices."""
        return int(self.ranks[self._at(index)]) == process_index()


def make_mesh(
    shape: dict[str, int] | str | None = None,
    devices: list | None = None,
) -> Mesh:
    """A Mesh over ``devices``, filled in row-major order.

    ``devices`` defaults to the visible CUDA cards (raises without one),
    and inside a process group to every process's cards in rank order
    (``global_devices()``, which every process must then call).  Entries
    are plain devices, this process's, or ``RankDevice`` entries of
    ``global_devices``.  A mesh that spans processes must hold a device
    of each; a mesh must hold one of this process.

    Default shape: every device on the ``data`` axis with a size-1
    ``bins`` axis — pure data parallelism.
    """
    if isinstance(shape, str):
        shape = parse_mesh_shape(shape)
    if devices is None:
        if process_count() > 1:
            devices = global_devices()
        else:
            resolve_device(None)  # raises without a card
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    me = process_index()
    entries = [d if isinstance(d, RankDevice) else RankDevice(me, resolve_device(d)) for d in devices]
    n = len(entries)
    if not shape:
        shape = {DATA_AXIS: n, BINS_AXIS: 1}
    total = math.prod(shape.values())
    if total != n:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {n}")
    owners = {e.rank for e in entries}
    if me not in owners:
        raise ValueError(f"the mesh holds no device of process {me}")
    if len(owners) > 1 and owners != set(range(process_count())):
        raise ValueError(
            f"a mesh that spans processes must hold a device of each of the "
            f"{process_count()}; it holds devices of {sorted(owners)}"
        )
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = [e.device for e in entries]
    dims = tuple(shape.values())
    ranks = np.array([e.rank for e in entries], dtype=np.int64).reshape(dims)
    return Mesh(dev_array.reshape(dims), tuple(shape.keys()), ranks)
