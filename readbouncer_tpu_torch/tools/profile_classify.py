"""Stage timings of one classify job at the bench geometry.

Counterpart of scripts/profile_classify.py: bench's four filters
(tools/bench.py builds them on the card) and ``--reads`` reads drawn as
bench draws them (``default_rng(42)``), one full warm-up, then one job
split into its serial stages, each ended by a synchronise of the card:

    host encode            encode_batch of every read (the native host
                           library's encode_batch, native/rbt_native.cpp)
    H2D phase-A reads      upload of chunk 0 of every read (uint8)
    submit                 encode + upload + launch of phase A (host)
    phase A on the device  the wait for phase A
    dispatch B             the pending flags' fetch, phase B's upload
                           and launch
    phase B on the device  the wait for phase B
    final fetch            the results' copy and unpacking
    serial total           submit .. final fetch, as reads/s

The JAX script's "host pack (phase A)" stage (``pack4_np``, five bases
a byte) has no counterpart: the port uploads unpacked uint8, and the
tool prints a line that says so.  The JAX script prints text only; the
last line here is one JSON object with the same numbers:

    {"metric": "classify_serial_reads_per_sec", "value", "unit", "reads",
     "batch", "stages_ms", "device"}

``device`` is the card's name and power limit from nvidia-smi ("cpu" on
the CPU).

    python -m readbouncer_tpu_torch.tools.profile_classify [--reads 16384] [--cache build/bench_cache]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from readbouncer_tpu_torch.classify.engine import ClassifyEngine, encode_batch
from readbouncer_tpu_torch.device import resolve_device, upload
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.tools._bench_util import card, sync
from readbouncer_tpu_torch.tools import bench
from readbouncer_tpu_torch.tools.bench import BATCH_SIZE, CACHE, ERROR_RATE, READ_LEN, bench_filters, bench_reads, cache_arg

__all__ = ["run_profile_classify", "main"]


def _timed(fn, dev) -> tuple[object, float]:
    """fn's result and its seconds, the card synchronised at the end."""
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def _wait_ms(dev) -> float:
    """Milliseconds until the card has finished its queued work."""
    t0 = time.perf_counter()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3


def run_profile_classify(
    targets: list[IBFData], depletes: list[IBFData], seqs: list[str], device=None, batch: int = BATCH_SIZE
) -> dict:
    """The warm-up and the staged job.  Returns ``line`` (the JSON line)
    and the job's per-read ``classified``, ``best`` and ``attempts``."""
    dev = resolve_device(device)
    eng = ClassifyEngine(targets, depletes, error_rate=ERROR_RATE, batch_size=batch, device=dev)
    print("# warmup (both phases at the run's shapes)...", flush=True)
    _, dt = _timed(lambda: eng.classify_sequences(seqs), dev)
    print(f"# warmup: {dt:.1f}s", flush=True)
    cl, C = eng.chunk_length, eng.max_chunks
    ms = {}
    (enc, _), t = _timed(lambda: encode_batch(seqs, cl * C), dev)
    ms["host_encode"] = t * 1e3
    reads_a = np.ascontiguousarray(enc[:, :cl])
    _, t = _timed(lambda: upload(reads_a, dev), dev)
    ms["h2d_phase_a"] = t * 1e3
    t0 = time.perf_counter()
    job = eng.classify_submit(seqs)
    ms["submit"] = (time.perf_counter() - t0) * 1e3  # encode + upload + launch A; no wait
    ms["phase_a"] = _wait_ms(dev)
    t0 = time.perf_counter()
    job.dispatch_b()
    ms["dispatch_b"] = (time.perf_counter() - t0) * 1e3  # pending fetch + upload + launch B
    ms["phase_b"] = _wait_ms(dev)
    (classified, best, attempts), t = _timed(job.finish, dev)
    ms["final_fetch"] = t * 1e3
    total = sum(ms[k] for k in ("submit", "phase_a", "dispatch_b", "phase_b", "final_fetch")) / 1e3
    n = len(seqs)
    print(f"device               : {card(dev)}")
    print(f"reads                : {n} (device batch {batch}, reads uploaded as unpacked uint8)")
    print(f"host encode (native) : {ms['host_encode']:8.1f} ms")
    print("host pack (phase A)  : no counterpart: the port uploads unpacked uint8 (no pack4_np)")
    print(f"H2D phase-A reads    : {ms['h2d_phase_a']:8.1f} ms ({reads_a.nbytes / 1e6:.1f} MB synced)")
    print(f"submit (enc+put+launch A): {ms['submit']:8.1f} ms")
    print(f"phase A on the device: {ms['phase_a']:8.1f} ms")
    print(f"dispatch B (pend fetch+put+launch B): {ms['dispatch_b']:8.1f} ms")
    print(f"phase B on the device: {ms['phase_b']:8.1f} ms")
    print(f"final fetch          : {ms['final_fetch']:8.1f} ms")
    print(f"serial total         : {total:8.3f} s = {n / total:.0f} reads/s", flush=True)
    line = {
        "metric": "classify_serial_reads_per_sec",
        "value": round(n / total, 1),
        "unit": "reads/s",
        "reads": n,
        "batch": batch,
        "stages_ms": ms,
        "device": card(dev),
    }
    return dict(line=line, classified=classified, best=best, attempts=attempts)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=16384)
    ap.add_argument("--cache", type=cache_arg, default=CACHE, help="filter cache directory ('' for none)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    filters, genomes = bench_filters(dev, args.cache)
    seqs = bench_reads(genomes, args.reads, READ_LEN)
    out = run_profile_classify(filters[:3], filters[3:], seqs, dev, bench.BATCH_SIZE)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
