"""Multi-process runs on ``torch.distributed`` — the torch counterpart of
readbouncer_tpu/parallel/distributed.py.

* ``init_distributed`` joins N processes (one per host) into one gloo
  process group.  gloo, not NCCL: every collective here moves small
  host tensors (counters, gradients of a small net, a batch's
  per-filter maxima), and NCCL refuses two ranks on one card.
* The CLI shards input per process: each reads or replays only its
  slice of the read records or channels (``host_shard``), so the only
  traffic between processes is the scalar merge of the report.
* ``allgather_pytree`` / ``aggregate_counters`` gather and sum host
  results for the report that rank 0 prints.
* ``global_devices`` lists every process's devices in rank order (the
  counterpart of ``jax.devices()`` in a group), so a ``Mesh`` can span
  processes; ``allreduce_max`` merges the per-filter maxima of a
  bins-sharded stack across them (parallel/sharded.py).

Config: ``[TPU] coordinator = "host0:8476"``, ``num_processes``,
``process_id``, or torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
``RANK`` / ``WORLD_SIZE`` environment.  Without either the run is one
process and the helpers are identities, so the same entry points serve
1..N processes.
"""

from __future__ import annotations

import atexit
import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.errors import ConfigError

__all__ = [
    "init_distributed",
    "shutdown_distributed",
    "is_distributed",
    "process_index",
    "process_count",
    "host_shard",
    "allgather_pytree",
    "aggregate_counters",
    "RankDevice",
    "global_devices",
    "allreduce_max",
]

# how long a process waits for the others: to join the group, and in
# every collective; past it the call raises instead of waiting forever
TIMEOUT = timedelta(seconds=300)

_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(
    coordinator: str = "",
    num_processes: int = 0,
    process_id: int = -1,
) -> bool:
    """Join this process to the group; no-op without a coordinator.

    Returns True when running distributed, False for single-process runs.
    With no coordinator, joins through torchrun's environment if all of
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` are set.
    Raises ``ConfigError`` for a process id outside ``[0,
    num_processes)``, and whatever the group raises when the coordinator
    cannot be reached within ``TIMEOUT``.
    """
    if dist.is_initialized():
        return True
    if coordinator:
        if num_processes < 1 or not 0 <= process_id < num_processes:
            raise ConfigError(
                f"TPU.process_id {process_id} must lie in [0, TPU.num_processes = "
                f"{num_processes}) when TPU.coordinator is set"
            )
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id, timeout=TIMEOUT,
        )
    elif all(os.environ.get(k) for k in _ENV_KEYS):
        dist.init_process_group("gloo", init_method="env://", timeout=TIMEOUT)
    else:
        return False
    atexit.register(shutdown_distributed)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard(items: list, index: int | None = None, count: int | None = None) -> list:
    """This process's contiguous slice of a work list (reads, channels,
    files).  Every process must pass the same ``items`` order; slices are
    balanced to within one element."""
    i = process_index() if index is None else index
    n = process_count() if count is None else count
    base, rem = divmod(len(items), n)
    start = i * base + min(i, rem)
    return items[start : start + base + (1 if i < rem else 0)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _allgather_leaf(x) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return np.stack([o.numpy() for o in out])


def allgather_pytree(tree):
    """Gather a host-local tree (dicts, lists, tuples) of numpy-readable
    leaves from every process: each leaf gains a leading process axis.
    In a single-process run that axis has length 1."""
    if process_count() == 1:
        return _tree_map(lambda x: np.asarray(x)[None, ...], tree)
    return _tree_map(_allgather_leaf, tree)


def aggregate_counters(counters: dict[str, int | float]) -> dict[str, int | float]:
    """Sum scalar counters across processes (the rank-0 report).

    Integers travel as int64 (exact for any count; a float64 round trip
    loses precision above 2**53), floats as float64.
    """
    keys = sorted(counters)
    int_keys = [k for k in keys if isinstance(counters[k], (int, np.integer))]
    flt_keys = [k for k in keys if k not in int_keys]
    out: dict[str, int | float] = {}
    if int_keys:
        ivec = np.array([counters[k] for k in int_keys], dtype=np.int64)
        itotal = allgather_pytree(ivec).sum(axis=0)
        out.update({k: int(v) for k, v in zip(int_keys, itotal)})
    if flt_keys:
        fvec = np.array([float(counters[k]) for k in flt_keys], dtype=np.float64)
        ftotal = allgather_pytree(fvec).sum(axis=0)
        out.update({k: float(v) for k, v in zip(flt_keys, ftotal)})
    return out


@dataclass(frozen=True)
class RankDevice:
    """A device of the group: the rank of the process that drives it, and
    the device as that process names it."""

    rank: int
    device: torch.device


def global_devices(local: list | None = None) -> list[RankDevice]:
    """Every process's devices in rank order, each naming its owning rank:
    the counterpart of ``jax.devices()`` inside a group, gathered with one
    ``all_gather_object`` (every process must call it).

    ``local`` is this process's share (default: its visible cards; raises
    without one) and may name one device several times, as ``[cuda:0] *
    2``.  Outside a group the list is this process's alone, as rank 0.
    """
    if local is None:
        resolve_device(None)  # raises without a card
        local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    names = [str(resolve_device(d)) for d in local]
    gathered = [names]
    if process_count() > 1:
        gathered = [None] * process_count()
        dist.all_gather_object(gathered, names)
    return [RankDevice(rank, torch.device(n)) for rank, ns in enumerate(gathered) for n in ns]


def allreduce_max(t: torch.Tensor) -> torch.Tensor:
    """Elementwise max of an int32 tensor over every process of the group,
    returned on ``t``'s device; in a single-process run ``t`` itself.

    Like ``allgather_pytree`` it travels as a CPU tensor over the gloo
    group: gloo, because NCCL refuses two ranks on one card.
    """
    if t.dtype != torch.int32:
        raise TypeError(f"allreduce_max takes int32 tensors, got {t.dtype}")
    if process_count() == 1:
        return t
    host = t.to("cpu", copy=True)
    dist.all_reduce(host, op=dist.ReduceOp.MAX)
    return host.to(t.device)
