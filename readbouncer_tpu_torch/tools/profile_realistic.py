"""Profile the IBF query path at the realistic filter geometry on a card.

Counterpart of scripts/profile_realistic.py, with the same flags and
stages.  It builds (or loads, when cached) ``--filters`` filters of
``--bins`` bins x 100 kb from seeded random genomes with the file-level
``ibf/build.py::build_ibf``, then times each stage of the query of
``--batch`` random reads of ``--chunk`` bases:

    host encode -> H2D -> counts (the K1 path) -> gather+AND only
    -> K4 accumulate only (on a zero [W, n_pad, 2R] tensor) -> max_counts

and the counts throughput.  Times are host clock around a synchronise,
the median of 3 passes; each line names the device.  The last line gives
the kernel launches of the run.

    python -m readbouncer_tpu_torch.tools.profile_realistic [--bins 512] [--batch 2048] [--cache DIR]

Filters and genomes are cached under ``--cache`` with the reference's
names (``g{i}_b{bins}_f100000_k13.ribf``, a scheme / h suffix when they
differ from rbt1, h=3), so a directory of the reference's
``.bench_cache`` filters is used as it is.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from readbouncer_tpu_torch.classify.engine import encode_batch
from readbouncer_tpu_torch.classify.math import ci_and_threshold_batch
from readbouncer_tpu_torch.device import host_tensor, resolve_device
from readbouncer_tpu_torch.ibf.build import build_ibf
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.query import FilterStack, counts, hash_rows_all, kmer_codes
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.ops import ibf_count
from readbouncer_tpu_torch.tools._bench_util import device_name, sync, timeit

__all__ = ["CACHE", "synth_genome", "get_filters", "main"]

CACHE = Path(__file__).resolve().parents[2] / "build" / "torch_bench_cache"


def synth_genome(rng: np.random.Generator, n: int) -> str:
    return bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=n)]).decode()


def get_filters(cache: Path, n_filters: int, bins_per_filter: int, params: IBFParams, device) -> list[IBFData]:
    """Build (or load cached) filters with bins_per_filter declared bins,
    genome i drawn from seed 1000 + i."""
    cache.mkdir(parents=True, exist_ok=True)
    genome_len = bins_per_filter * params.fragment_length
    suffix = ""
    if params.hash_scheme != "rbt1":
        suffix += f"_{params.hash_scheme}"
    if params.hash_functions != 3:
        suffix += f"_h{params.hash_functions}"
    filters = []
    for i in range(n_filters):
        name = f"g{i}_b{bins_per_filter}_f{params.fragment_length}_k{params.kmer_size}"
        p = cache / f"{name}{suffix}.ribf"
        gpath = cache / f"{name}.fasta"
        if p.exists():
            filters.append(IBFData.load(p))
            continue
        if not gpath.exists():
            rng = np.random.default_rng(1000 + i)
            gpath.write_text(f">{name}\n{synth_genome(rng, genome_len)}\n")
        ibf, stats = build_ibf([gpath], params, name=name, device=device)
        print(f"built {name}{suffix}: bins={ibf.num_bins} words={ibf.words} "
              f"rows={ibf.rows} ({stats.build_seconds:.1f}s)", flush=True)
        ibf.save(p)
        filters.append(ibf)
    return filters


def gather_and(stack: FilterStack, reads: torch.Tensor) -> torch.Tensor:
    """Row gathers + AND over the hashes with flat indices, unmasked."""
    codes = kmer_codes(reads, stack.kmer_size)
    anded = None
    for ridx in hash_rows_all(codes, stack.hash_functions, stack.rows, stack.scheme):
        g = stack.bits.index_select(0, ridx.reshape(-1)).reshape(codes.shape + (stack.words,))
        anded = g if anded is None else anded.bitwise_and_(g)
    return anded


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bins", type=int, default=512)
    ap.add_argument("--filters", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--h", type=int, default=3, help="hash functions (sizing follows)")
    ap.add_argument("--scheme", default="rbt1")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--cache", type=Path, default=CACHE, help="filter and genome cache directory")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = f"on {device_name(dev)}"
    ibf_count.accumulate_planes.launches = 0
    ibf_count.accumulate_counts.launches = 0

    params = IBFParams(
        kmer_size=13,
        fragment_length=100_000,
        hash_functions=args.h,
        hash_scheme=args.scheme,
    )
    filters = get_filters(args.cache, args.filters, args.bins, params, dev)

    t0 = time.monotonic()
    stack = FilterStack(filters, device=dev)
    sync(dev)
    print(f"FilterStack: W={stack.words} total_bins={stack.total_bins} rows={stack.rows} "
          f"bits={stack.bits.numel() * 4 / 1e6:.0f}MB upload={time.monotonic() - t0:.2f}s {where}")

    R, cl = args.batch, args.chunk
    rng = np.random.default_rng(7)
    seqs = [synth_genome(rng, cl) for _ in range(R)]
    reads, lens = encode_batch(seqs, cl)
    t0 = time.perf_counter()
    encode_batch(seqs, cl)
    print(f"host encode [{R},{cl}]: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    host_reads = host_tensor(reads)  # the native encode's buffer is read-only
    dt = timeit(lambda: host_reads.to(dev), device=dev, n=5)
    print(f"H2D transfer {reads.nbytes / 1e6:.1f}MB: med={dt * 1e3:.3f} ms {where}")

    k, h, rows, scheme = stack.kmer_size, stack.hash_functions, stack.rows, stack.scheme
    dreads = host_reads.to(dev)
    dlens = host_tensor(lens).to(dev)

    def f_counts():
        return counts(stack.bits, dreads, dlens, k=k, h=h, rows=rows, scheme=scheme)

    dt = timeit(f_counts, device=dev, n=20)
    print(f"counts full (K1 path): med={dt * 1e3:.3f} ms {where}", flush=True)

    dt = timeit(lambda: gather_and(stack, dreads), device=dev, n=20)
    n = cl - k + 1
    out_mb = R * 2 * n * stack.words * 4 / 1e6
    print(f"gather+AND only ({out_mb:.0f}MB out): med={dt * 1e3:.3f} ms {where}", flush=True)

    n_pad = ibf_count.counts_v1_n_pad(n)
    a_t = torch.zeros((stack.words, n_pad, 2 * R), dtype=torch.int32, device=dev)
    dt = timeit(lambda: ibf_count.accumulate_counts(a_t), device=dev, n=20)
    print(f"K4 accumulate only [{stack.words},{n_pad},{2 * R}]: med={dt * 1e3:.3f} ms {where}")

    cnt = f_counts()
    thr = torch.from_numpy(ci_and_threshold_batch(lens, k, 0.1, 0.95)).to(dev)
    dt = timeit(lambda: stack.max_counts(cnt, thr), device=dev, n=20)
    print(f"max_counts: med={dt * 1e3:.3f} ms {where}")

    dt = timeit(f_counts, device=dev, n=20)
    print(f"=> counts throughput: {R / dt:,.0f} chunk-reads/s (batch {R}, W={stack.words}) {where}")
    launches = {"K1": ibf_count.accumulate_planes.launches, "K4": ibf_count.accumulate_counts.launches}
    print(f"launches: {json.dumps(launches)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
