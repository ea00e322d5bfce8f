"""Host <-> card transfer mechanics.

Counterpart of scripts/transfer_probe.py, with its five sections and
sizes.  The engine uploads each host batch's reads and fetches results;
what those transfers cost at small and large sizes bounds what a change
of its upload path can win.  Measures:

* H2D: ``torch.from_numpy(host).to(device)`` from pageable memory, as
  the reference's ``device_put``, at 4 KB .. 64 MB, completed by a
  synchronise and a one-element fetch (best of 5);
* whether queued uploads pipeline: 5 x 0.5 MB puts, then one sync;
* D2H: ``.cpu()`` of a card-resident tensor of 4 B .. 4 MB (best of 5);
* 20 x 40 KB fetched in one go (torch has no batched fetch: 20 ``.cpu()``);
* dispatch latency: 20 chained ``x + 1`` launches, then one sync.

The last line is one JSON object with every number and ``device``.

    python -m readbouncer_tpu_torch.tools.transfer_probe [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.tools._bench_util import card, device_name, sync

__all__ = ["H2D_SIZES", "D2H_SIZES", "run_transfer_probe", "main"]

H2D_SIZES = (4 << 10, 512 << 10, 4 << 20, 64 << 20)
D2H_SIZES = (4, 4 << 10, 512 << 10, 4 << 20)


def _done(x: torch.Tensor, dev) -> None:
    """True completion: a synchronise and a one-element fetch."""
    sync(dev)
    x[0].item()


def run_transfer_probe(dev, h2d_sizes=H2D_SIZES, d2h_sizes=D2H_SIZES) -> dict:
    """Every section once; returns the numbers and the JSON ``line``."""
    dev = resolve_device(dev)
    print(f"device: {device_name(dev)}", flush=True)

    print("-- H2D: single put from pageable memory, synced (synchronise + one-element fetch)")
    h2d = {}
    for size in h2d_sizes:
        host = np.random.randint(0, 255, size=size, dtype=np.uint8)
        _done(torch.from_numpy(host).to(dev), dev)  # warm
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            _done(torch.from_numpy(host).to(dev), dev)
            ts.append(time.perf_counter() - t0)
        ms = min(ts) * 1e3
        h2d[size] = ms
        print(f"  {size / 1e6:8.3f} MB: {ms:8.3f} ms  {size / 1e6 / ms * 1e3:8.1f} MB/s", flush=True)

    print("-- H2D: 5 queued puts then one sync (do transfers pipeline?)")
    host = np.random.randint(0, 255, size=512 << 10, dtype=np.uint8)
    _done(torch.from_numpy(host).to(dev), dev)
    t0 = time.perf_counter()
    xs = [torch.from_numpy(host).to(dev) for _ in range(5)]
    for x in xs:
        _done(x, dev)
    queued = (time.perf_counter() - t0) * 1e3
    print(f"  5 x 0.5 MB queued: {queued:.3f} ms total ({queued / 5:.3f} ms each)", flush=True)

    print("-- D2H: fetch of n bytes (card-resident tensor)")
    d2h = {}
    for size in d2h_sizes:
        x = torch.zeros(max(size, 4), dtype=torch.uint8, device=dev)
        x.cpu()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            x.cpu()
            ts.append(time.perf_counter() - t0)
        d2h[size] = min(ts) * 1e3
        print(f"  {size / 1e6:8.3f} MB: {d2h[size]:8.3f} ms", flush=True)

    print("-- D2H: 20 x 40KB fetched together (batched round trip?)")
    xs = [torch.zeros(40 << 10, dtype=torch.uint8, device=dev) for _ in range(20)]
    for x in xs:
        _done(x, dev)
    t0 = time.perf_counter()
    [x.cpu() for x in xs]
    fetch20 = (time.perf_counter() - t0) * 1e3
    print(f"  20 x 40KB fetched: {fetch20:.3f} ms", flush=True)

    print("-- dispatch latency: trivial op, queued x20 + one sync")
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    _done(x + 1, dev)
    t0 = time.perf_counter()
    y = x
    for _ in range(20):
        y = y + 1
    _done(y, dev)
    chain20 = (time.perf_counter() - t0) * 1e3
    print(f"  20 chained dispatches: {chain20:.3f} ms", flush=True)

    line = {
        "metric": "transfer_probe",
        "h2d_ms": {str(s): v for s, v in h2d.items()},
        "h2d_mb_per_s": {str(s): s / 1e6 / v * 1e3 for s, v in h2d.items()},
        "h2d_5x512k_queued_ms": queued,
        "d2h_ms": {str(s): v for s, v in d2h.items()},
        "d2h_20x40k_ms": fetch20,
        "dispatch_20_chained_ms": chain20,
        "device": card(dev),
    }
    return {"line": line}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(run_transfer_probe(args.device, H2D_SIZES, D2H_SIZES)["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
