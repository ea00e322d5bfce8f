"""Batched GRU basecaller (DeepNano-blitz nets) in PyTorch — the torch
counterpart of readbouncer_tpu/models/gru.py.

* **signal framing**: per-read median/MAD normalisation and overlapping
  windows of ``window`` (66) samples at ``frame_stride`` (5), on the host
  (``frame_signal``, numpy copies) or on the device (``frame_signal_t``,
  a strided view);
* **input-side matmuls hoisted**: the input projection and every layer's
  input-gate terms are one matmul each over all timesteps; only the
  recurrence runs step by step (kernel K3, ``ops/gru.py``);
* **alternating directions**: odd layers scan the sequence backwards;
* output: per-step logits over 5 CTC symbols (blank + ACGT).

Float math is f32 at full precision, as the reference's
``precision="highest"``: no TF32 (``_full_precision``).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.models.weights import GRUWeights
from readbouncer_tpu_torch.ops.gru import gru_layer, gru_layer_plain

__all__ = [
    "GRUBasecallerModel",
    "LAYER_KEYS",
    "frame_signal",
    "frame_signal_t",
    "gru_logits",
    "med_mad_normalize",
    "params_from_jax",
    "params_from_weights",
]

LAYER_KEYS = ("w_zrn", "b_zrn", "r_zr", "b_hzr", "rn", "bhn")


def med_mad_normalize(signal: np.ndarray) -> np.ndarray:
    """Per-read median / MAD scaling of the raw current signal."""
    signal = np.asarray(signal, dtype=np.float32)
    med = np.median(signal)
    mad = np.median(np.abs(signal - med)) + 1e-6
    return (signal - med) / mad


def frame_signal(
    signal: np.ndarray, window: int = 66, stride: int = 5, max_frames: int | None = None
) -> np.ndarray:
    """Normalized signal -> [T, window] overlapping frames (host side)."""
    signal = np.asarray(signal, dtype=np.float32)
    if signal.shape[0] < window:
        signal = np.pad(signal, (0, window - signal.shape[0]))
    n = (signal.shape[0] - window) // stride + 1
    if max_frames is not None:
        n = min(n, max_frames)
    idx = np.arange(window)[None, :] + stride * np.arange(n)[:, None]
    return signal[idx]


def frame_signal_t(sig: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Device framing: [B, S] normalized signal -> [B, T, window] frames,
    T = (S - window) // stride + 1 (the reference's frame_signal_jnp).
    A strided view: the upload stays the signal, not the 13x larger frames."""
    return sig.unfold(1, window, stride)


def params_from_weights(w: GRUWeights) -> dict:
    """rnn*.txt weights -> the fused-gate param tree (numpy), as the
    reference's GRUBasecallerModel builds it: w_zrn = [Wz | Wr | Wn] etc."""
    return {
        "w_in": w.w_in,
        "b_in": w.b_in,
        "w_out": w.w_out,
        "b_out": w.b_out,
        "layers": [
            {
                "w_zrn": np.concatenate([l.wz, l.wr, l.wn], axis=1),
                "b_zrn": np.concatenate([l.biz, l.bir, l.bin_]),
                "r_zr": np.concatenate([l.rz, l.rr], axis=1),
                "b_hzr": np.concatenate([l.bhz, l.bhr]),
                "rn": l.rn,
                "bhn": l.bhn,
            }
            for l in w.layers
        ],
    }


def params_from_jax(tree: dict) -> "OrderedDict[str, torch.Tensor]":
    """The JAX model's param pytree ({"w_in", "b_in", "w_out", "b_out",
    "layers": [{"w_zrn", ...}]}, arrays of any kind numpy can read) ->
    the state dict of ``GRUBasecallerModel``: float32 CPU tensors under
    ``w_in`` ... and ``layers.<i>.<key>``."""
    state = OrderedDict()
    for k in ("w_in", "b_in", "w_out", "b_out"):
        state[k] = torch.from_numpy(np.array(tree[k], dtype=np.float32))
    for i, layer in enumerate(tree["layers"]):
        for k in LAYER_KEYS:
            state[f"layers.{i}.{k}"] = torch.from_numpy(np.array(layer[k], dtype=np.float32))
    return state


def _full_precision() -> None:
    # the reference's precision="highest": f32 products, no TF32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gru_logits(params: dict, frames: torch.Tensor, kernel: bool = False) -> torch.Tensor:
    """frames [B, T, window] -> logits [B, T, 5].

    ``kernel=False`` is the plain forward, step for step the reference's
    ``gru_logits``: input matmul, per layer the ``xg`` matmul and the
    per-step recurrence with odd layers flipped in time, then the head.
    ``kernel=True`` runs each recurrence through ``ops.gru.gru_layer``
    (K3 on CUDA tensors, the plain loop on CPU tensors) and scans odd
    layers backwards instead of flipping.
    """
    x = frames.to(torch.float32) @ params["w_in"] + params["b_in"]
    for li, layer in enumerate(params["layers"]):
        odd = li % 2 == 1
        if kernel:
            xg = x @ layer["w_zrn"] + layer["b_zrn"]
            x = gru_layer(layer, xg, reverse=odd)
            continue
        if odd:
            x = torch.flip(x, dims=(1,))
        x = gru_layer_plain(layer, x @ layer["w_zrn"] + layer["b_zrn"])
        if odd:
            x = torch.flip(x, dims=(1,))
    return x @ params["w_out"] + params["b_out"]


class _LayerState(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        H = hidden
        shapes = {"w_zrn": (H, 3 * H), "b_zrn": (3 * H,), "r_zr": (H, 2 * H),
                  "b_hzr": (2 * H,), "rn": (H, H), "bhn": (H,)}
        for k in LAYER_KEYS:
            self.register_buffer(k, torch.zeros(shapes[k]))


class GRUBasecallerModel(nn.Module):
    """The net's weights as buffers on one device, and its forward.

    Build it from a param tree (``load_params_npz`` or
    ``params_from_weights``): ``GRUBasecallerModel(tree, device=...)``.
    ``logits`` maps frames to CTC logits; ``tokens_from_signal`` maps a
    normalized f16 signal batch to argmax token ids on the device.
    """

    def __init__(self, tree: dict, frame_stride: int = 5, device=None):
        super().__init__()
        _full_precision()
        window, hidden = np.shape(tree["w_in"])
        self.frame_stride = frame_stride
        self.register_buffer("w_in", torch.zeros(window, hidden))
        self.register_buffer("b_in", torch.zeros(hidden))
        self.register_buffer("w_out", torch.zeros(np.shape(tree["w_out"])))
        self.register_buffer("b_out", torch.zeros(np.shape(tree["b_out"])))
        self.layers = nn.ModuleList(_LayerState(hidden) for _ in tree["layers"])
        self.load_state_dict(params_from_jax(tree))
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.w_in.device

    @property
    def hidden(self) -> int:
        return int(self.w_in.shape[1])

    @property
    def window(self) -> int:
        return int(self.w_in.shape[0])

    @property
    def params(self) -> dict:
        """The param tree of device tensors that ``gru_logits`` takes."""
        return {
            "w_in": self.w_in, "b_in": self.b_in, "w_out": self.w_out, "b_out": self.b_out,
            "layers": [{k: getattr(l, k) for k in LAYER_KEYS} for l in self.layers],
        }

    @torch.no_grad()
    def logits(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, T, window] -> CTC logits [B, T, 5] on the device."""
        return gru_logits(self.params, frames.to(self.device), kernel=True)

    @torch.no_grad()
    def tokens_from_signal(self, sig: torch.Tensor) -> torch.Tensor:
        """Normalized signal [B, S] (f16) -> greedy argmax ids [B, T] uint8
        on the device: framing, forward and argmax in one call, so only the
        token array crosses back to the host."""
        frames = frame_signal_t(sig.to(self.device, torch.float32), self.window, self.frame_stride)
        return torch.argmax(self.logits(frames), dim=-1).to(torch.uint8)
