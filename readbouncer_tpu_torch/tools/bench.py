"""Offline classification throughput at the realistic geometry.

Counterpart of the repository's ``bench.py``, with its workload, seeds
and timing: 3 target + 1 deplete filters of 512 bins x 100 kb fragments
(k=13, h=3, rbt1), genome ``i`` drawn from ``default_rng(1000 + i)``,
and 40,960 reads of 1 kb with 10 % substitutions drawn from
``default_rng(42)`` (half from the targets, a quarter from the depletion
genome, a quarter from a random genome).  One full warm-up run of
``ClassifyEngine.classify_sequences_pipelined`` (host batch 16,384,
depth 2, device batch 1,024), then 3 timed runs on the host clock; the
engine returns numpy arrays, so each run ends in a synchronise.  As in
bench.py, a timed upload of 0.5 MB first (``probe_transfer_seconds``)
picks the regime: at 80 ms or more the link is congested and the whole
read set goes as one host batch at depth 1 ("single_pool"), else the
pipeline runs as set ("pipelined"); ``--force-mode`` overrides the
probe.  The last line is one JSON object:

    {"metric": "classify_reads_per_sec_realistic", "value", "unit",
     "vs_baseline", "transfer_probe_ms", "transfer_mode", "classified",
     "run_seconds", "device"}

``value`` is the median of the 3 runs; ``vs_baseline`` divides it by
506 reads/s, the C++ reference's CPU figure that bench.py compares with.
``device`` is the card's name and power limit from nvidia-smi ("cpu" on
the CPU).

    python -m readbouncer_tpu_torch.tools.bench [--batch 1024] [--batch-b 0]
        [--host-batch 16384] [--depth 2] [--force-mode auto|pipelined|single_pool]
        [--cache build/bench_cache]

The filters are built on the card from the seeds and saved under
``--cache`` (loaded from there when present; ``--cache ''`` keeps
nothing); every genome and every filter's bits, built or loaded, are
checked against the sha256 of the reference's bench files.  Left out of
bench.py's line: ``pct_of_compute_floor`` divides by a floor measured
on a TPU, not on this card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

from readbouncer_tpu_torch.classify.engine import CONGESTED_SECONDS, ClassifyEngine
from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.ibf.build import build_ibf_records
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.tools._bench_util import card, sync

__all__ = [
    "BINS_PER_FILTER", "FRAGMENT", "N_READS", "READ_LEN", "ERROR_RATE", "BATCH_SIZE", "HOST_BATCH",
    "PIPELINE_DEPTH", "N_TIMED_RUNS", "BASELINE_READS_PER_SEC", "GENOME_SHA", "BITS_SHA", "CACHE", "FORCE_MODES",
    "synth_genome", "bench_name", "bench_genome", "reads_from", "bench_reads", "bench_filters",
    "run_bench", "main",
]

BINS_PER_FILTER = 512
FRAGMENT = 100_000
N_READS = 40_960
READ_LEN = 1_000
ERROR_RATE = 0.1
BATCH_SIZE = 1_024
HOST_BATCH = 16_384
PIPELINE_DEPTH = 2
N_TIMED_RUNS = 3
RANDOM_GENOME = 1_000_000  # the genome the random quarter of the reads comes from
BASELINE_READS_PER_SEC = 506.0  # the C++ reference's CPU figure (bench.py)
FORCE_MODES = ("auto", "pipelined", "single_pool")
# sha256 of bench genome i's text (g{i}_b512_f100000_k13) and of the bits
# of its filter (uint32 little-endian bytes); tests/test_torch_storage.py
# recomputes them from the reference's cached files
GENOME_SHA = [
    "75fa242b6f8f0bafaf649cbf31119969e850e05dba6313251beaf595913469d9",
    "9c7948641eee1a5189440e0281cf505682d7ec1c7537bb8e171a048a9b69e5aa",
    "ac348b1590d608b6978914541cc185da33208c2a3196c60a842a0f7cf0765aa9",
    "79b5a6e0b0ef57aae4e3cfa32da5d882ce9706623cd161b8b0ffe26280be9cff",
]
BITS_SHA = [
    "57743b72d25f1c756559e4f10936b6a02d0b2edeeca4cca4a2796dd8c54cebc2",
    "17c35e125f0ab9352b9b8534ba411cdc6a86b86f6d75937c9e72116f7ce3101c",
    "e28fbde15eb1c663be37cad4096352acb92e279ddd24533503ea4144647d9255",
    "6f2baca9d9d5c668144028003de62089708d66d185ced8177bb9aff640ccbd9c",
]
CACHE = Path(__file__).resolve().parents[2] / "build" / "bench_cache"


def synth_genome(rng: np.random.Generator, n: int) -> np.ndarray:
    """bench.py's synth_genome, as ASCII bytes: one draw of n bases."""
    return np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=n)]


def bench_name(i: int) -> str:
    return f"g{i}_b{BINS_PER_FILTER}_f{FRAGMENT}_k13"


def bench_genome(i: int, length: int | None = None) -> np.ndarray:
    """bench.py's genome i: ``length`` bases (BINS_PER_FILTER x FRAGMENT
    by default) from ``default_rng(1000 + i)``."""
    return synth_genome(np.random.default_rng(1000 + i), length or BINS_PER_FILTER * FRAGMENT)


def reads_from(rng: np.random.Generator, genome: np.ndarray, n: int, length: int) -> list[str]:
    """bench.py's reads_from: substrings with ERROR_RATE substitutions;
    draws the starts, then the mutation mask, then the substitutes."""
    starts = rng.integers(0, len(genome) - length, size=n)
    arr = genome[starts[:, None] + np.arange(length)[None, :]].copy()
    mut = rng.random((n, length)) < ERROR_RATE
    arr[mut] = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=int(mut.sum()))]
    return [bytes(r).decode() for r in arr]


def bench_reads(
    genomes: list[np.ndarray],
    n: int = N_READS,
    length: int = READ_LEN,
    rng: np.random.Generator | None = None,
    random_len: int = RANDOM_GENOME,
) -> list[str]:
    """bench.py's read set, draw for draw (from ``rng``, by default
    ``default_rng(42)``): n // 6 reads from each of genomes 0-2, n // 4
    from genome 3, the rest from a random genome of ``random_len`` bases,
    permuted."""
    rng = rng or np.random.default_rng(42)
    seqs: list[str] = []
    for i in range(3):
        seqs += reads_from(rng, genomes[i], n // 6, length)
    seqs += reads_from(rng, genomes[3], n // 4, length)
    n_rand = n - len(seqs)
    seqs += reads_from(rng, synth_genome(rng, random_len), n_rand, length)
    order = rng.permutation(len(seqs))
    return [seqs[i] for i in order]


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()


def bench_filters(device=None, cache: Path | None = CACHE) -> tuple[list[IBFData], list[np.ndarray]]:
    """The four bench genomes and their filters, built on ``device`` (or
    loaded from ``cache`` when saved there before; ``cache=None`` saves
    nothing).  Each genome and each filter's bits must hash to
    GENOME_SHA / BITS_SHA, the reference's bench files, else this raises."""
    dev = resolve_device(device)
    params = IBFParams(kmer_size=13, fragment_length=FRAGMENT)
    filters, genomes = [], []
    for i in range(4):
        name = bench_name(i)
        g = bench_genome(i)
        if _sha(g) != GENOME_SHA[i]:
            raise RuntimeError(
                f"{name}: the regenerated genome differs from the reference's bench genome "
                f"(numpy's generator gives other draws for seed {1000 + i})"
            )
        path = cache / f"{name}.ribf" if cache is not None else None
        t0 = time.monotonic()
        if path is not None and path.exists():
            ibf, how = IBFData.load(path), f"loaded from {path}"
        else:
            ibf, _ = build_ibf_records([(name, g.tobytes().decode())], params, name=name, device=dev)
            sync(dev)
            how = f"built on {card(dev)}"
            if path is not None:
                cache.mkdir(parents=True, exist_ok=True)
                ibf.save(path)
        if _sha(ibf.bits) != BITS_SHA[i]:
            raise RuntimeError(f"{name}: the filter's bits differ from the reference's bench filter ({how})")
        print(f"# {name}: rows={ibf.rows} words={ibf.words} {how} in {time.monotonic() - t0:.2f} s, "
              f"bits sha256 equal to the reference's", flush=True)
        filters.append(ibf)
        genomes.append(g)
    return filters, genomes


def run_bench(
    targets: list[IBFData],
    depletes: list[IBFData],
    seqs: list[str],
    device=None,
    batch: int = BATCH_SIZE,
    batch_b: int = 0,
    host_batch: int = HOST_BATCH,
    depth: int = PIPELINE_DEPTH,
    runs: int = N_TIMED_RUNS,
    before_timed=None,
    force_mode: str = "auto",
) -> dict:
    """The transfer probe, one full warm-up run, then ``runs`` timed runs
    of the pipelined classify over ``seqs``; ``before_timed()``, when
    given, is called between them (chip_smoke.py resets its launch counts
    there).  ``force_mode`` "auto" lets the probe choose between
    ``host_batch``/``depth`` and one host batch of every read at depth 1;
    "pipelined" or "single_pool" chooses without it.  Returns ``line``
    (the JSON line), ``classified_by_run`` (each run's per-read flags, the
    warm-up's first) and the last run's per-read ``classified``, ``best``
    and ``attempts``."""
    if force_mode not in FORCE_MODES:
        raise ValueError(f"force_mode must be one of {FORCE_MODES}, got {force_mode!r}")
    dev = resolve_device(device)
    engine = ClassifyEngine(
        targets, depletes, error_rate=ERROR_RATE, batch_size=batch, batch_size_b=batch_b or None, device=dev
    )
    probe_s = engine.probe_transfer_seconds()
    transfer_mode = "pipelined"
    if force_mode == "single_pool" or (force_mode == "auto" and probe_s >= CONGESTED_SECONDS):
        host_batch, depth, transfer_mode = len(seqs), 1, "single_pool"
    print(f"# transfer probe: {probe_s * 1e3:.3f} ms for 0.5 MB -> {transfer_mode}, host_batch={host_batch} "
          f"depth={depth}", flush=True)

    def run():
        out = engine.classify_sequences_pipelined(seqs, host_batch_reads=host_batch, depth=depth)
        sync(dev)
        return out

    t0 = time.perf_counter()
    warm = run()
    print(f"# warmup run: {time.perf_counter() - t0:.1f}s, classified {int(warm[0].sum())}/{len(seqs)}",
          flush=True)
    if before_timed is not None:
        before_timed()
    times, by_run = [], [warm[0]]
    for i in range(runs):
        t0 = time.perf_counter()
        classified, best, attempts = run()
        times.append(time.perf_counter() - t0)
        by_run.append(classified)
        print(f"# run {i + 1}: {times[-1]:.2f}s = {len(seqs) / times[-1]:.0f} reads/s", flush=True)
    reads_per_sec = len(seqs) / float(np.median(times))
    line = {
        "metric": "classify_reads_per_sec_realistic",
        "value": round(reads_per_sec, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_sec / BASELINE_READS_PER_SEC, 2),
        "transfer_probe_ms": probe_s * 1e3,
        "transfer_mode": transfer_mode,
        "classified": int(classified.sum()),
        "run_seconds": times,
        "device": card(dev),
    }
    return dict(line=line, classified_by_run=by_run, classified=classified, best=best, attempts=attempts)


def cache_arg(text: str) -> Path | None:
    """``--cache``'s value: a directory, or '' for none."""
    return Path(text) if text else None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH_SIZE)
    ap.add_argument("--batch-b", type=int, default=0, help="phase-B read batch (0 = same as --batch)")
    ap.add_argument("--host-batch", type=int, default=HOST_BATCH)
    ap.add_argument("--depth", type=int, default=PIPELINE_DEPTH)
    ap.add_argument("--force-mode", choices=FORCE_MODES, default="auto",
                    help="override the transfer probe's choice of regime")
    ap.add_argument("--cache", type=cache_arg, default=CACHE, help="filter cache directory ('' for none)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    filters, genomes = bench_filters(dev, args.cache)
    seqs = bench_reads(genomes, N_READS, READ_LEN)
    out = run_bench(filters[:3], filters[3:], seqs, dev, args.batch, args.batch_b, args.host_batch,
                    args.depth, N_TIMED_RUNS, force_mode=args.force_mode)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
