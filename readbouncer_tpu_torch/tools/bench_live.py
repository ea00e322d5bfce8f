"""Live adaptive-sampling tick latency at the realistic geometry.

Counterpart of scripts/bench_live.py, with its flags, defaults and read
set: bench's four filters (3 targets, 1 depletion; tools/bench.py builds
them on the card), and ``--reads`` reads of ``--read-bases`` bases drawn
from ``default_rng(7)`` (half from genome 0, a target, half from genome
3, the depletion genome; with ``--random-frac`` that share from a random
genome), permuted, then turned into squiggles from the same generator.
They are replayed over ``--channels`` channels at one 0.4 s chunk per
channel and tick, basecalled by the Oracle (``--caller oracle``) or a
trained GRU (``--caller synth48``: data/gru_synth48.npz; ``--caller
48``..``96`` name the DeepNano rnn48..rnn96 nets, which are not in the
repository and fail with the loader's message), and decided by
``LiveClassifier``.

Warm-ups before the timed run, as the script makes them: every length
bucket of the classifier, each power-of-two GRU batch from 32 up to the
channel count (it loads cuBLAS and builds the kernels), and the first
tick, timed apart.  Then ``AdaptiveSampler.run`` with ``profile_ticks``,
the stats report, the composition of the slowest ticks (>= p95) against
the rest, and as the last line one JSON object:

    {"metric": "live_p50_tick_latency_ms", "value", "p95_ms", "max_ms",
     "ticks", "channels", "reads", "unblocked", "stop_received",
     "within_0.4s_budget_pct", "wall_seconds", "device"}

over the ticks after the first; ``device`` is the card's name and power
limit from nvidia-smi ("cpu" on the CPU).  Ticks run back to back, not
paced by the wall clock.

    python -m readbouncer_tpu_torch.tools.bench_live [--channels 512] [--reads 2048]
        [--caller oracle|synth48] [--ticks N] [--cache build/bench_cache]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.models.basecaller import GRUBasecaller
from readbouncer_tpu_torch.stream.replay import NearestLevelBasecaller, ReplayRead, ReplaySource, sequence_to_signal
from readbouncer_tpu_torch.stream.scheduler import AdaptiveSampler, LiveClassifier, LiveConfig
from readbouncer_tpu_torch.tools._bench_util import card, sync
from readbouncer_tpu_torch.tools.bench import CACHE, RANDOM_GENOME, bench_filters, cache_arg, reads_from, synth_genome

__all__ = ["TICK_BUDGET_S", "live_workload", "make_caller", "run_bench_live", "main"]

TICK_BUDGET_S = 0.4  # break_reads_after_seconds (reference adaptive_sampling.hpp:634)


def live_workload(
    genomes: list[np.ndarray], n_reads: int = 2048, read_bases: int = 4000, random_frac: float = 0.0
) -> list[tuple[str, np.ndarray, str, int]]:
    """scripts/bench_live.py's reads, draw for draw: (read id, signal,
    sequence, genome of origin: 0, 3, or -1 for a random read)."""
    rng = np.random.default_rng(7)
    n_r = int(n_reads * random_frac)
    n_t = (n_reads - n_r) // 2
    n_d = n_reads - n_r - n_t
    seqs = reads_from(rng, genomes[0], n_t, read_bases) + reads_from(rng, genomes[3], n_d, read_bases)
    if n_r:
        seqs += reads_from(rng, synth_genome(rng, RANDOM_GENOME), n_r, read_bases)
    order = rng.permutation(len(seqs))
    origin = lambda j: 0 if j < n_t else 3 if j < n_t + n_d else -1  # noqa: E731
    return [
        (f"r{i}", sequence_to_signal(seqs[j], rng=rng), seqs[j], origin(j)) for i, j in enumerate(order)
    ]


def make_caller(name: str, max_frames: int = 320, device=None):
    """``oracle`` -> the nearest-level Oracle; any other name -> the GRU
    basecaller of that network (raises FileNotFoundError without its
    weights)."""
    if name == "oracle":
        return NearestLevelBasecaller()
    return GRUBasecaller(network=name, max_frames=max_frames, device=resolve_device(device))


def _composition(prof: list[dict]) -> list[str]:
    """The script's p95-tail attribution: mean composition of the ticks
    at or above the p95 latency and of the rest."""
    if not prof:
        return []
    p95 = float(np.percentile([p["latency_ms"] for p in prof], 95))
    lines = []
    for name, ps in (("tail(>=p95)", [p for p in prof if p["latency_ms"] >= p95]),
                     ("body", [p for p in prof if p["latency_ms"] < p95])):

        def comp(key):
            vals = [p.get(key, 0) for p in ps]
            return round(float(np.mean(vals)), 1) if vals else 0.0

        lines.append(
            f"# {name}: n={len(ps)} lat={comp('latency_ms')}ms bc={comp('basecall_ms')}ms "
            f"cl={comp('classify_ms')}ms chunks={comp('chunks')} items={comp('items')} "
            f"long={comp('long_items')} retry={comp('retry_items')}"
        )
    return lines


def run_bench_live(
    targets: list[IBFData],
    depletes: list[IBFData],
    workload: list[tuple[str, np.ndarray, str, int]],
    basecaller,
    device=None,
    channels: int = 512,
    batch: int = 512,
    mid_len: int = 0,
    ticks: int = 0,
    before_timed=None,
) -> dict:
    """The script's warm-ups and timed live run; ``before_timed()``, when
    given, is called between the warm-ups and the first tick
    (chip_smoke.py resets its launch counts there).  Returns ``line`` (the
    JSON line), ``stats`` (LiveStats), ``reads`` (the replayed reads, each
    with its ``unblocked`` / ``stopped`` flags), the ``classifier``, and
    ``warmup_s`` and ``first_tick_s``."""
    dev = resolve_device(device)
    src = ReplaySource(reads=[ReplayRead(rid, sig, seq) for rid, sig, seq, _ in workload], channels=channels)
    cfg = LiveConfig(batch_size=batch, profile_ticks=True, mid_len=mid_len)
    classifier = LiveClassifier(targets, depletes, cfg, device=dev)
    with tempfile.TemporaryDirectory() as td:
        sampler = AdaptiveSampler(src, basecaller, classifier, output_dir=td, cfg=cfg)
        t_warm = t0 = time.monotonic()
        classifier.decide(["ACGT" * (w // 4) for w in classifier.bucket_lens])
        sync(dev)
        print(f"# classifier warmup: {time.monotonic() - t0:.1f}s", flush=True)
        if not isinstance(basecaller, NearestLevelBasecaller):
            t0 = time.monotonic()
            b = 32
            while b <= max(32, channels):
                basecaller.basecall([np.zeros(1600, np.float32)] * b)
                b *= 2
            sync(dev)
            print(f"# basecaller warmup: {time.monotonic() - t0:.1f}s", flush=True)
        warmup_s = time.monotonic() - t_warm
        if before_timed is not None:
            before_timed()
        t0 = time.monotonic()
        sampler.step()
        first_tick_s = time.monotonic() - t0
        print(f"# first tick: {first_tick_s:.1f}s", flush=True)
        t_run = time.monotonic()
        stats = sampler.run(max_ticks=ticks if ticks > 0 else None)
        sync(dev)
        wall = time.monotonic() - t_run
    lat = np.array(stats.tick_latencies[1:] or [0.0])  # the first tick was timed apart
    print(stats.report())
    for line in _composition(stats.tick_profile[1:]):
        print(line, flush=True)
    line = {
        "metric": "live_p50_tick_latency_ms",
        "value": round(float(np.median(lat)) * 1e3, 2),
        "p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 2),
        "max_ms": round(float(lat.max()) * 1e3, 2),
        "ticks": stats.ticks,
        "channels": channels,
        "reads": len(workload),
        "unblocked": stats.unblocked,
        "stop_received": stats.stop_received,
        "within_0.4s_budget_pct": round(100.0 * float((lat < TICK_BUDGET_S).mean()), 2),
        "wall_seconds": round(wall, 2),
        "device": card(dev),
    }
    return dict(line=line, stats=stats, reads=src.reads, classifier=classifier, warmup_s=warmup_s,
                first_tick_s=first_tick_s)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=512)
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--read-bases", type=int, default=4000)
    ap.add_argument("--caller", default="oracle")
    ap.add_argument("--ticks", type=int, default=0, help="0 = run to completion")
    ap.add_argument("--batch", type=int, default=512)
    # frames of a 0.4 s chunk: (1600 - 66) // 5 + 1 = 307, padded to x64
    ap.add_argument("--max-frames", type=int, default=320)
    ap.add_argument("--mid-len", type=int, default=0, help="extra length bucket (LiveConfig.mid_len)")
    ap.add_argument("--random-frac", type=float, default=0.0, help="share of reads from no genome")
    ap.add_argument("--cache", type=cache_arg, default=CACHE, help="filter cache directory ('' for none)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    try:
        basecaller = make_caller(args.caller, args.max_frames, dev)
    except FileNotFoundError as e:
        print(f"bench_live: {e}", file=sys.stderr)
        return 1
    filters, genomes = bench_filters(dev, args.cache)
    workload = live_workload(genomes, args.reads, args.read_bases, args.random_frac)
    out = run_bench_live(filters[:3], filters[3:], workload, basecaller, dev, args.channels, args.batch,
                         args.mid_len, args.ticks)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
