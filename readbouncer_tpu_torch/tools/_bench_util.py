"""Shared timing helpers of the port's probe and profile tools.

PyTorch returns before the card finishes, so a time on the host clock is
taken around work that ends in a synchronise.  ``timeit`` amortises a
loop of calls over one synchronise and reports the median of several
passes, as scripts/_bench_util.py does for the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["sync", "timeit", "device_name"]


def sync(device: torch.device) -> None:
    """Wait until the card has finished all queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, *args, device: torch.device, n: int = 15, passes: int = 3) -> float:
    """Median-of-passes per-call seconds of fn(*args), synchronised per pass."""
    t0 = time.perf_counter()
    fn(*args)
    sync(device)
    print(f"  first call: {time.perf_counter() - t0:.2f}s", flush=True)
    ts = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        sync(device)
        ts.append((time.perf_counter() - t0) / n)
    return float(np.median(ts))


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"; printed beside every time."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
