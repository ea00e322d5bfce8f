"""Offline classification throughput over narrow filters.

Counterpart of scripts/bench_toy.py, with its workload and seeds: from
one ``default_rng(42)``, three target genomes and one depletion genome
of 300 kb, each built into a filter of 100 kb fragments (k=13: 3 bins,
one word), then 40,960 reads of 1 kb with 10 % substitutions (half from
the targets, a quarter from the depletion genome, a quarter from a
random 300 kb genome), permuted.  The filters are built on the card.
``ClassifyEngine.classify_sequences`` at device batch 8,192: one full
warm-up run, then 3 timed runs on the host clock.  These narrow filters
and the large batch give the count kernels a shape no other tool
reaches.  The last line is one JSON object:

    {"metric": "classify_reads_per_sec", "value", "unit", "vs_baseline", "device"}

``value`` is the median of the 3 runs; ``vs_baseline`` divides it by 506
reads/s, the C++ reference's CPU figure; ``device`` is the card's name
and power limit from nvidia-smi ("cpu" on the CPU).

    python -m readbouncer_tpu_torch.tools.bench_toy [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from readbouncer_tpu_torch.classify.engine import ClassifyEngine
from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.ibf.build import build_ibf_records
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.tools._bench_util import card, sync
from readbouncer_tpu_torch.tools.bench import BASELINE_READS_PER_SEC, ERROR_RATE, READ_LEN, bench_reads, synth_genome

__all__ = [
    "GENOME_LEN", "N_READS", "BATCH_SIZE", "N_TIMED_RUNS", "toy_workload", "toy_filters", "run_bench_toy", "main",
]

GENOME_LEN = 300_000
N_READS = 40_960
BATCH_SIZE = 8_192
N_TIMED_RUNS = 3
NAMES = ("target0", "target1", "target2", "deplete")


def toy_workload(n_reads: int = N_READS, genome_len: int = GENOME_LEN) -> tuple[list[np.ndarray], list[str]]:
    """scripts/bench_toy.py's genomes (3 targets, then the depletion
    genome) and reads, draw for draw."""
    rng = np.random.default_rng(42)
    genomes = [synth_genome(rng, genome_len) for _ in NAMES]
    return genomes, bench_reads(genomes, n_reads, READ_LEN, rng=rng, random_len=genome_len)


def toy_filters(genomes: list[np.ndarray], device=None) -> list[IBFData]:
    """The four narrow filters (100 kb fragments, k=13), built on ``device``."""
    params = IBFParams(kmer_size=13, fragment_length=100_000)
    dev = resolve_device(device)
    return [
        build_ibf_records([(name, g.tobytes().decode())], params, name=name, device=dev)[0]
        for name, g in zip(NAMES, genomes)
    ]


def run_bench_toy(
    targets: list[IBFData],
    depletes: list[IBFData],
    seqs: list[str],
    device=None,
    batch: int = BATCH_SIZE,
    runs: int = N_TIMED_RUNS,
) -> dict:
    """One full warm-up run, then ``runs`` timed runs of classify_sequences.
    Returns ``line`` (the JSON line) and the last run's per-read
    ``classified``, ``best`` and ``attempts``."""
    dev = resolve_device(device)
    engine = ClassifyEngine(targets, depletes, error_rate=ERROR_RATE, batch_size=batch, device=dev)
    t0 = time.perf_counter()
    engine.classify_sequences(seqs)
    sync(dev)
    print(f"# warmup run: {time.perf_counter() - t0:.1f}s", flush=True)
    times = []
    for i in range(runs):
        t0 = time.perf_counter()
        classified, best, attempts = engine.classify_sequences(seqs)
        sync(dev)
        times.append(time.perf_counter() - t0)
        print(f"# run {i + 1}: {times[-1]:.2f}s", flush=True)
    reads_per_sec = len(seqs) / float(np.median(times))
    line = {
        "metric": "classify_reads_per_sec",
        "value": round(reads_per_sec, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_sec / BASELINE_READS_PER_SEC, 2),
        "device": card(dev),
    }
    return dict(line=line, run_seconds=times, classified=classified, best=best, attempts=attempts)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    genomes, seqs = toy_workload(N_READS, GENOME_LEN)
    filters = toy_filters(genomes, dev)
    out = run_bench_toy(filters[:3], filters[3:], seqs, dev, BATCH_SIZE, N_TIMED_RUNS)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
