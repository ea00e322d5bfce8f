"""Device selection for the port's entry points.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the CUDA card, and with no card that is an error.  The CPU is used
only when the caller asks for it (``device="cpu"``), as the tests do; an
entry point never carries on quietly on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "upload"]


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


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: on CUDA through pinned
    memory, copied without blocking the host; on the CPU without a copy."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
