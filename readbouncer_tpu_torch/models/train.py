"""CTC training for the GRU basecaller — the torch counterpart of
readbouncer_tpu/models/train.py.

One step = forward (``models.gru.gru_logits`` with ``kernel=False``) ->
CTC loss (``F.ctc_loss``) -> gradients by autograd -> optimizer update.
The forward is the plain per-step recurrence, which autograd
differentiates, as the JAX trainer differentiates its ``lax.scan``
forward and not its Pallas kernel: K3 (``ops.gru.gru_layer``) is
forward-only, here as there, and serves the basecaller, not training.

Multi-device: ``make_sharded_train_step`` is data-parallel over the
mesh's ``data`` axis: the params are replicated to each shard's device,
each shard runs its forward and backward there, the gradients are
averaged onto the params' device and one update is made; in a
multi-process group the gradients are also averaged across processes
(the DDP twin of the reference's all-reduce over ICI).

Params are a tree ``{"w_in", "b_in", "w_out", "b_out", "layers":
[{"w_zrn", ...}]}`` of leaf tensors that require grad; the optimizer
(``opt_state``) is a ``torch.optim.Optimizer`` over ``param_leaves``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.models.gru import LAYER_KEYS, _full_precision, gru_logits, params_from_jax
from readbouncer_tpu_torch.parallel import distributed
from readbouncer_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

__all__ = [
    "init_gru_params",
    "param_tree",
    "param_leaves",
    "host_params",
    "ctc_loss",
    "cosine_decay",
    "make_train_step",
    "make_sharded_train_step",
    "synthetic_ctc_batch",
]

_TOP_KEYS = ("w_in", "b_in", "w_out", "b_out")


def init_gru_params(
    generator: torch.Generator,
    hidden: int = 48,
    window: int = 66,
    num_layers: int = 4,
    num_symbols: int = 5,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Random params in the tree layout ``gru_logits`` takes (the layout
    GRUBasecallerModel builds from rnn*.txt files): Glorot normal weights
    (std sqrt(2 / (fan_in + fan_out))) and zero biases, drawn from
    ``generator`` on its device, leaves requiring grad."""
    H = hidden
    dev = generator.device

    def glorot(shape):
        scale = math.sqrt(2.0 / (shape[0] + shape[1]))
        return torch.randn(shape, generator=generator, device=dev, dtype=dtype) * scale

    def zeros(n):
        return torch.zeros(n, device=dev, dtype=dtype)

    w_in = glorot((window, H))
    w_out = glorot((H, num_symbols))
    layers = [
        {
            "w_zrn": glorot((H, 3 * H)),
            "b_zrn": zeros(3 * H),
            "r_zr": glorot((H, 2 * H)),
            "b_hzr": zeros(2 * H),
            "rn": glorot((H, H)),
            "bhn": zeros(H),
        }
        for _ in range(num_layers)
    ]
    tree = {"w_in": w_in, "b_in": zeros(H), "w_out": w_out, "b_out": zeros(num_symbols), "layers": layers}
    return _map(lambda t: t.requires_grad_(), tree)


def _map(fn, params: dict) -> dict:
    out = {k: fn(params[k]) for k in _TOP_KEYS}
    out["layers"] = [{k: fn(layer[k]) for k in LAYER_KEYS} for layer in params["layers"]]
    return out


def param_tree(tree: dict, device=None) -> dict:
    """A param tree of numpy-readable leaves (a ``load_params_npz`` tree,
    the JAX package's params) -> float32 leaf tensors on ``device``
    (None = the card) that require grad, through ``params_from_jax``."""
    dev = resolve_device(device)
    state = params_from_jax(tree)
    out = {k: state[k].to(dev) for k in _TOP_KEYS}
    out["layers"] = [
        {k: state[f"layers.{i}.{k}"].to(dev) for k in LAYER_KEYS} for i in range(len(tree["layers"]))
    ]
    return _map(lambda t: t.requires_grad_(), out)


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The tree's leaves in a fixed order (top keys, then layer by layer)."""
    return [params[k] for k in _TOP_KEYS] + [layer[k] for layer in params["layers"] for k in LAYER_KEYS]


def host_params(params: dict) -> dict:
    """The tree as numpy float32 arrays (``save_params_npz`` takes it)."""
    return _map(lambda t: t.detach().cpu().numpy(), params)


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)


def ctc_loss(
    params: dict,
    frames,  # [B, T, window] f32
    frame_lengths,  # [B]
    labels,  # [B, Lmax] in 1..4 (0 = blank is never a label)
    label_lengths,  # [B]
) -> torch.Tensor:
    """Mean CTC loss over the batch, each sequence's loss divided by its
    label length (at least 1) first, as the reference's ``ctc_loss``;
    blank id 0, matching models/ctc.py.  On the params' device."""
    dev = params["w_in"].device
    logits = gru_logits(params, _on(frames, dev, torch.float32), kernel=False)
    log_probs = F.log_softmax(logits, dim=-1).transpose(0, 1)  # [T, B, C]
    return F.ctc_loss(
        log_probs, _on(labels, dev, torch.int64), _on(frame_lengths, dev, torch.int64),
        _on(label_lengths, dev, torch.int64), blank=0, reduction="mean",
    )


def cosine_decay(decay_steps: int, alpha: float = 0.0):
    """The factor of optax's ``cosine_decay_schedule(lr, decay_steps,
    alpha)`` after ``count`` updates, for ``torch.optim.lr_scheduler.LambdaLR``
    stepped once after each optimizer step."""

    def factor(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha

    return factor


class _TrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``;
    ``step.init(params)`` makes ``opt_state``.  The params are updated in
    place and returned; the loss is a detached 0-d tensor."""

    def __init__(self, optimizer_factory, max_grad_norm: float | None, mesh: Mesh | None):
        _full_precision()
        self.optimizer_factory = optimizer_factory
        self.max_grad_norm = max_grad_norm
        self.mesh = mesh

    def init(self, params: dict) -> torch.optim.Optimizer:
        return self.optimizer_factory(param_leaves(params))

    def __call__(self, params: dict, opt_state: torch.optim.Optimizer, batch):
        opt_state.zero_grad(set_to_none=True)
        if self.mesh is None:
            loss = ctc_loss(params, *batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = self._sharded_grads(params, batch)
        if self.max_grad_norm is not None:
            torch.nn.utils.clip_grad_norm_(param_leaves(params), self.max_grad_norm)
        opt_state.step()
        return params, opt_state, loss

    def _sharded_grads(self, params: dict, batch) -> torch.Tensor:
        """Sets each leaf's ``grad`` to the batch's mean gradient over the
        data shards (and processes); returns the batch's mean loss."""
        n = self.mesh.shape.get(DATA_AXIS, 1)
        B = batch[0].shape[0]
        if B % n:
            raise ValueError(f"batch {B} must divide over '{DATA_AXIS}' axis ({n})")
        S = B // n
        leaves = param_leaves(params)
        home = leaves[0].device
        grads = [torch.zeros_like(p) for p in leaves]
        loss = torch.zeros((), device=home)
        for i in range(n):
            dev = self.mesh.device_at(**{DATA_AXIS: i})
            replica = _map(lambda t: t.detach().to(dev, copy=True).requires_grad_(), params)
            part = [x[i * S : (i + 1) * S] for x in batch]
            loss_i = ctc_loss(replica, *part)
            for acc, g in zip(grads, torch.autograd.grad(loss_i, param_leaves(replica))):
                acc += g.to(home)
            loss += loss_i.detach().to(home)
        procs = distributed.process_count()
        for p, g in zip(leaves, grads):
            p.grad = _process_mean(g, procs) / n
        return _process_mean(loss, procs) / n


def _process_mean(t: torch.Tensor, procs: int) -> torch.Tensor:
    if procs == 1:
        return t
    host = t.cpu()
    torch.distributed.all_reduce(host)
    return (host / procs).to(t.device)


def make_train_step(optimizer_factory, max_grad_norm: float | None = None) -> _TrainStep:
    """Single-device train step.  ``optimizer_factory(leaves)`` makes the
    optimizer (``step.init(params)`` calls it); ``max_grad_norm`` clips
    the gradients' global norm before the update."""
    return _TrainStep(optimizer_factory, max_grad_norm, None)


def make_sharded_train_step(
    mesh: Mesh, optimizer_factory, max_grad_norm: float | None = None
) -> _TrainStep:
    """Data-parallel train step over ``mesh``'s ``data`` axis: params
    replicated, batch split, gradients averaged onto the params' device
    (and across processes), one update.  The mesh is this process's own:
    each process passes its own batch."""
    if mesh.spans_processes:
        raise ValueError("the train step's mesh must be this process's own; it spans processes")
    return _TrainStep(optimizer_factory, max_grad_norm, mesh)


def synthetic_ctc_batch(
    rng: np.random.Generator,
    batch: int,
    frames_t: int,
    window: int = 66,
    max_label: int = 24,
):
    """Random (frames, frame_lengths, labels, label_lengths) numpy batch —
    fixture for smoke tests and the multi-device step."""
    frames = rng.standard_normal((batch, frames_t, window), dtype=np.float32)
    frame_lengths = np.full((batch,), frames_t, dtype=np.int32)
    label_lengths = rng.integers(4, max_label + 1, size=batch).astype(np.int32)
    labels = rng.integers(1, 5, size=(batch, max_label)).astype(np.int32)
    labels[np.arange(max_label)[None, :] >= label_lengths[:, None]] = 0
    return frames, frame_lengths, labels, label_lengths
