"""The graft-entry contract of ``__graft_entry__.py``, for the port.

entry()               -> (fn, example_args): the forward step of the
                         flagship model (the GRU basecaller network) and
                         example frames [8, 128, 66].
dryrun_multichip(n)   -> an n-device (data, bins) mesh, one step each of
                         the bins-sharded classify, the sharded live
                         decision and the data-parallel CTC train step, on
                         tiny shapes; ``dryrun_steps`` returns their
                         results.

The mesh names one device n times (the card, or the CPU when asked), as
``parallel/mesh.py`` allows: on one card the steps run cell after cell.
The forward is float32 without TF32, as everywhere in the port, where
the JAX contract asks ``precision="default"``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from readbouncer_tpu_torch.classify.math import ci_and_threshold_batch
from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.ibf.query import FilterStack
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.models.gru import _full_precision, gru_logits
from readbouncer_tpu_torch.models.train import init_gru_params, make_sharded_train_step, synthetic_ctc_batch
from readbouncer_tpu_torch.parallel.mesh import BINS_AXIS, DATA_AXIS, make_mesh
from readbouncer_tpu_torch.parallel.sharded import ShardedFilterStack, ShardedLiveClassifier
from readbouncer_tpu_torch.stream.scheduler import LiveConfig

__all__ = ["entry", "dryrun_steps", "dryrun_multichip"]

HIDDEN = 48


def _params(dev: torch.device, params: dict | None) -> dict:
    """``params``, or the port's init at hidden 48 from a generator seeded 0."""
    if params is not None:
        return params
    return init_gru_params(torch.Generator(device=dev).manual_seed(0), hidden=HIDDEN)


def entry(device=None, params: dict | None = None):
    """The GRU basecaller's forward, frames [B, T, 66] -> CTC logits
    [B, T, 5], and its example input: zeros [8, 128, 66] float32 on the
    device.  On the card each layer's recurrence is kernel K3.  ``params``
    (a ``models/train.py`` param tree) replaces the seeded init."""
    dev = resolve_device(device)
    _full_precision()
    fn = functools.partial(_forward, _params(dev, params))  # fn.args[0]: the params
    return fn, (torch.zeros((8, 128, 66), dtype=torch.float32, device=dev),)


def _forward(params: dict, frames: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return gru_logits(params, frames, kernel=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {msg}")


def dryrun_steps(n_devices: int, device=None, params: dict | None = None) -> dict:
    """The reference dryrun's three steps, step for step, on an n-device
    mesh of ``device`` (None: the card) repeated; returns {"mesh", "mb",
    "mr", "decisions", "loss"}.  ``params`` replaces the seeded init of
    the train step's net."""
    dev = resolve_device(device)
    bins_shards = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh({DATA_AXIS: n_devices // bins_shards, BINS_AXIS: bins_shards}, [dev] * n_devices)

    # --- bins-tensor-parallel IBF classification step
    rng = np.random.default_rng(7)
    k, h, rows = 13, 3, 512
    filters = []
    for name in ("target", "deplete"):
        # W = 2 words a filter -> stack W = 4, which divides over bins_shards in {1, 2}
        bits = rng.integers(0, 1 << 32, size=(rows, 2), dtype=np.uint32)
        filters.append(IBFData(kmer_size=k, hash_functions=h, num_bins=50, bits=bits,
                               fragment_length=1000, name=name))
    sharded = ShardedFilterStack(FilterStack(filters, dev), mesh)
    R, L = 4 * (n_devices // bins_shards), 64
    reads = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    lengths = np.full((R,), L, dtype=np.int32)
    thr_b = ci_and_threshold_batch(lengths, k, 0.1, 0.95)
    thr_r = ci_and_threshold_batch(lengths, k, 0.08, 0.95)
    mb, mr = sharded.max_counts_dual(reads, lengths, thr_b, thr_r)
    _check(tuple(mb.shape) == (R, 2), f"max counts of shape {tuple(mb.shape)}")

    # --- bins-sharded live decision step
    live = ShardedLiveClassifier(filters[:1], filters[1:], LiveConfig(batch_size=max(32, R), max_seq_len=512), mesh)
    dec = live.decide(["".join("ACGT"[b] for b in row) for row in reads])
    _check(dec.shape == (R,), f"decisions of shape {dec.shape}")

    # --- data-parallel CTC training step
    params = _params(dev, params)
    step = make_sharded_train_step(mesh, lambda leaves: torch.optim.Adam(leaves, lr=1e-3))
    opt_state = step.init(params)
    batch = synthetic_ctc_batch(rng, batch=R, frames_t=48)
    params, opt_state, loss = step(params, opt_state, batch)
    loss = float(loss)
    _check(bool(np.isfinite(loss)), f"loss {loss}")
    return {"mesh": mesh.shape, "mb": mb, "mr": mr, "decisions": dec, "loss": loss}


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run ``dryrun_steps``; raises if a step fails its check."""
    dryrun_steps(n_devices, device)
