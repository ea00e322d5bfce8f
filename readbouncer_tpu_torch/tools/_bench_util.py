"""Shared timing helpers of the port's probe and profile tools.

PyTorch returns before the card finishes, so a time on the host clock is
taken around work that ends in a synchronise.  ``timeit`` amortises a
loop of calls over one synchronise and reports the median of several
passes, as scripts/_bench_util.py does for the JAX package.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

__all__ = ["sync", "timeit", "device_name", "card"]


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


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or "cpu": the
    ``device`` of every tool's JSON line.  A card whose power limit
    nvidia-smi cannot read is named by torch, and says so."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is None or out.returncode != 0 or not out.stdout.strip():
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    return out.stdout.strip().splitlines()[0]
