"""Device selection for the port's entry points.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the CUDA card, and with no card that is an error.  The CPU is used
only when the caller asks for it (``device="cpu"``), as the tests do; an
entry point never carries on quietly on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["host_tensor", "resolve_device", "upload"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); otherwise as given.

    Accepts only CPU and CUDA devices; a CUDA device with no card raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU"
        )
    return dev


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor: without a copy, unless the array is
    read-only (as the native encode's buffers are), which a tensor must
    not alias."""
    arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: on CUDA copied once into
    pinned memory and from there without blocking the host; on the CPU
    as ``host_tensor`` gives it."""
    arr = np.asarray(arr)
    if device.type != "cuda":
        return host_tensor(arr)
    dtype = torch.from_numpy(np.empty(0, dtype=arr.dtype)).dtype
    pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = arr
    return pinned.to(device, non_blocking=True)
