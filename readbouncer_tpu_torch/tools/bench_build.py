"""Filter build throughput: one realistic filter built on the card.

Counterpart of scripts/bench_build.py, with its genome and flags: a
``--mb`` megabase genome (51.2 by default: 512 fragments of 100 kb)
drawn from ``default_rng(7)``, written to a FASTA file and built
``--runs`` times (k=13, h=3, rbt1) through the file-level
``ibf/build.py::build_ibf``.  The JAX script builds on the host (its
native insert workers).  The port's build parses the FASTA on the host
(the native reader) and, on the card, hashes and inserts there;
``--device cpu`` measures the same native insert as the JAX script
(``insert_fragments`` over ``IBFParams.threads`` workers).  Each run
ends in a synchronise.
The last line is one JSON object:

    {"metric": "ibf_build_mbases_per_sec", "value", "unit", "genome_mb",
     "median_seconds", "runs", "peak_device_gb", "device"}

``peak_device_gb`` is ``torch.cuda.max_memory_allocated`` over the runs
after ``reset_peak_memory_stats`` (null on the CPU); ``device`` is the
card's name and power limit from nvidia-smi ("cpu" on the CPU).

    python -m readbouncer_tpu_torch.tools.bench_build [--mb 51.2] [--runs 3]
    python -m readbouncer_tpu_torch.tools.bench_build --device cpu --mb 0.05 --runs 1
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.ibf.build import build_ibf
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.tools._bench_util import card, sync

__all__ = ["build_genome", "run_bench_build", "main"]


def build_genome(mb: float = 51.2) -> bytes:
    """scripts/bench_build.py's genome: int(mb * 1e6) bases from
    ``default_rng(7)``."""
    rng = np.random.default_rng(7)
    return bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, int(mb * 1e6))])


def run_bench_build(genome: bytes, device=None, runs: int = 3) -> dict:
    """Build the genome's filter ``runs`` times.  Returns ``line`` (the
    JSON line) and ``bits_sha`` (sha256 of each run's bits)."""
    dev = resolve_device(device)
    mb = len(genome) / 1e6
    params = IBFParams(kmer_size=13, fragment_length=100_000)
    times, digests = [], []
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "g.fasta"
        path.write_bytes(b">g\n" + genome + b"\n")
        for i in range(runs):
            t0 = time.monotonic()
            ibf, _ = build_ibf([path], params, name="g", device=dev)
            sync(dev)
            times.append(time.monotonic() - t0)
            digests.append(hashlib.sha256(ibf.bits.tobytes()).hexdigest())
            print(f"# run {i + 1}: {times[-1]:.2f}s ({mb / times[-1]:.1f} Mb/s, {ibf.rows} rows x "
                  f"{ibf.words} words)", file=sys.stderr, flush=True)
    med = float(np.median(times))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    line = {
        "metric": "ibf_build_mbases_per_sec",
        "value": round(mb / med, 2),
        "unit": "Mb/s",
        "genome_mb": mb,
        "median_seconds": round(med, 2),
        "runs": runs,
        "peak_device_gb": peak,
        "device": card(dev),
    }
    return dict(line=line, bits_sha=digests, run_seconds=times)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=51.2, help="genome megabases")
    ap.add_argument("--runs", type=int, default=3, help="timed runs (median)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run_bench_build(build_genome(args.mb), dev, args.runs)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
