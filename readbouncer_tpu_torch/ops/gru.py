"""Kernel K3 of the basecaller: one GRU layer's recurrence.

Counterpart of readbouncer_tpu/ops/gru_pallas.py.  ``gru_layer``
validates its operands, then

* on CPU tensors runs ``gru_layer_plain``, the per-step PyTorch loop;
* on CUDA tensors launches the CUDA C++ kernel of ``csrc/gru.cu`` (built
  and bound by ``ops/_build.py``), and raises if it cannot.

There is no fallback from the kernel to the plain version.
``gru_layer.launches`` goes up by one per kernel launch and nowhere else.

The input-side products (``x @ w_zrn + b_zrn``) are not part of the
kernel: the caller computes ``xg`` with a matmul, as the JAX package
leaves them to XLA outside its Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["MAX_HIDDEN", "gru_layer", "gru_layer_plain"]

MAX_HIDDEN = 96  # the widest DeepNano-blitz net; its weights take 111 KB of shared memory

_PARAM_SHAPES = {
    "r_zr": lambda H: (H, 2 * H),
    "b_hzr": lambda H: (2 * H,),
    "rn": lambda H: (H, H),
    "bhn": lambda H: (H,),
}


def _check(params: dict, xg: torch.Tensor) -> int:
    if xg.dtype != torch.float32 or xg.dim() != 3 or xg.shape[2] % 3:
        raise ValueError(f"xg must be float32 [B, T, 3H], got {xg.dtype} {tuple(xg.shape)}")
    if xg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"xg is on unsupported device {xg.device}")
    H = xg.shape[2] // 3
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"hidden width {H} outside 1..{MAX_HIDDEN}")
    for name, shape in _PARAM_SHAPES.items():
        t = params[name]
        if t.dtype != torch.float32 or tuple(t.shape) != shape(H):
            raise ValueError(f"{name} must be float32 {shape(H)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != xg.device:
            raise ValueError(f"{name} on {t.device}, xg on {xg.device}")
    return H


def gru_layer(params: dict, xg: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """xg [B, T, 3H] f32 (z, r, n input terms) -> ys [B, T, H] f32.

    ``params`` holds one layer's ``r_zr`` [H, 2H], ``b_hzr`` [2H], ``rn``
    [H, H] and ``bhn`` [H].  ``reverse`` scans t from T-1 down to 0 (the
    odd layers of the net), which equals flipping xg in time, scanning
    and flipping ys back.  Replaces the Pallas ``_gru_kernel``
    (gru_layer_pallas); unlike it, any B and T are accepted.
    """
    H = _check(params, xg)
    if xg.device.type == "cpu":
        return gru_layer_plain(params, xg, reverse)
    B, T, _ = xg.shape
    xg = xg.contiguous()
    ys = torch.empty((B, T, H), dtype=torch.float32, device=xg.device)
    if ys.numel() == 0:
        return ys
    from readbouncer_tpu_torch.ops._build import error_string, load_library

    w = {k: params[k].contiguous() for k in _PARAM_SHAPES}
    lib = load_library("gru").lib
    with torch.cuda.device(xg.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(xg.device).cuda_stream)
        err = lib.rb_gru_layer(
            ctypes.c_void_p(xg.data_ptr()), ctypes.c_void_p(w["r_zr"].data_ptr()),
            ctypes.c_void_p(w["b_hzr"].data_ptr()), ctypes.c_void_p(w["rn"].data_ptr()),
            ctypes.c_void_p(w["bhn"].data_ptr()), ctypes.c_void_p(ys.data_ptr()),
            B, T, H, int(reverse), stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_layer launch failed: CUDA error {err} ({error_string(err, 'gru')})")
    gru_layer.launches += 1
    return ys


gru_layer.launches = 0


def gru_layer_plain(params: dict, xg: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain version of K3: the reference's per-step scan (models/gru.py
    ``_gru_layer``), with ``reverse`` as two flips in time."""
    if reverse:
        return torch.flip(gru_layer_plain(params, torch.flip(xg, dims=(1,))), dims=(1,))
    B, T, G = xg.shape
    H = G // 3
    h = torch.zeros((B, H), dtype=xg.dtype, device=xg.device)
    ys = []
    for t in range(T):
        x_t = xg[:, t]
        hzr = h @ params["r_zr"] + params["b_hzr"]
        z = torch.sigmoid(x_t[:, :H] + hzr[:, :H])
        r = torch.sigmoid(x_t[:, H : 2 * H] + hzr[:, H:])
        hn = h @ params["rn"] + params["bhn"]
        n = torch.tanh(x_t[:, 2 * H :] + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    if not ys:
        return xg.new_zeros((B, 0, H))
    return torch.stack(ys, dim=1)
