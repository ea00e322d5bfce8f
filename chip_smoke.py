#!/usr/bin/env python3
"""Smoke run of readbouncer_tpu_torch on one CUDA card (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-only
    python3 chip_smoke.py --k4-k5-only
    python3 chip_smoke.py --probes-only
    python3 chip_smoke.py --mesh-only

Drives the port's paths at full width and holds every kernel against
its plain version:

* offline classify at the bench geometry of bench.py: 3 target + 1
  deplete filters of 512 bins x 100 kb (k=13, h=3, rbt1) and bench.py's
  40,960 reads of 1 kb (seed 42);
* the live target loop at scripts/bench_live.py's workload: 2,048 reads
  of 4 kb (1,024 from genome 0, a target, and 1,024 from genome 3, the
  depletion genome) replayed over 512 channels, basecalled by the trained
  synth48 GRU and decided against the same four filters;
* the filter-building usages (``build``, ``update``, FASTA filter inputs)
  on the bench genomes, and the two tools that reach the last two
  kernels: the realistic-geometry profile (K4, the v1 per-bin count
  accumulation) and the gather probe (K5);
* the bins-sharded classifier and live classifier over meshes of the one
  card named several times, a two-process classify, the live loop
  through the remote basecaller, and the CTC trainer;
* the bins-sharded classifier and live classifier over meshes that span
  two processes on the card, joined by a gloo group;
* the five measurement tools (readbouncer_tpu_torch/tools/bench.py,
  bench_live.py, bench_build.py, bench_toy.py, profile_classify.py),
  whose workload helpers this script imports;
* the four research probes (tools/proto_counts_layout.py,
  dedup_probe.py, gather_probe.py, transfer_probe.py) and the port's
  graft-entry contract (readbouncer_tpu_torch/graft_entry.py).

Phases:

1. card   — name and power limit (nvidia-smi), torch and CUDA versions;
2. build  — nvcc builds every ops/csrc/*.cu (ibf_count, gru,
            gather_probe), one process each, and the host C++ compiler
            the native host library (readbouncer_tpu_torch/native), all
            at once (seconds), with the -Xptxas -v register /
            shared-memory / spill lines and the host compiler's name,
            version and seconds;
3. state  — tools/bench.py::bench_filters: the four bench genomes
            regenerated from bench.py's seeds (sha256 equal to the
            tracked .bench_cache FASTAs), the four filters built on the
            card (bits sha256 equal to the tracked .bench_cache .ribf
            files; when those files are in the checkout they are also
            loaded and compared), saved in tools.bench's cache layout
            under a temporary directory (phase 17 loads them), merged
            into one stack of W=72 words;
   host   — the native host library against its plain versions:
            encode_batch over bench's 40,960 reads bit-equal to
            encode_batch_np, both timed on one 16,384-read job (median
            of 5); read_records over the four genome FASTAs, a gzip copy
            of one, the same genome at 80 bases a line and a FASTQ of
            bench's reads, equal to the Python parser, both timed; genome 3's filter built on the CPU from
            its FASTA through the native insert, bits sha256 equal to the
            tracked filter's;
4. kernels — K1 (accumulate_planes) and K2 (planes_dual_max) on real
            inputs of that stack at the phase-A and phase-B shapes of
            classify and the short bucket of the live loop, bit-equal to
            their plain versions, timed with CUDA events (K2, shorter
            than the host's cost of a call through its wrapper: 20 calls
            in a CUDA graph, the profiler's device time per launch, and
            the wrapper's time beside them); K2's launch layout (one warp
            per read and segment) printed;
   counts — K4 (accumulate_counts) on the v1 input of 2,048 bench-read
            chunks of 250 bp ([72, 256, 4096], 302 MB): bit-equal to its
            plain version, and reshaped equal to the K1 route's counts of
            the same reads; timed on it and on zeros;
5. main   — tools/bench.py::run_bench on the read set (a full warm-up
            run of the pipelined classify, then 3 timed runs, its JSON
            line printed): exactly 20,493 of 40,960 reads classified in
            every run, every run deciding as the warm-up, both kernel
            counters and the native encode_batch's calls > 0 over the
            timed runs, 256 reads' decisions equal
            to the numpy oracle, and the first 2,048 reads' decisions,
            best targets and attempts equal to the chunk-wave oracle's
            (``ClassifyEngine.classify_sequences_waves``);
   profile — host encode time and one host batch under torch.profiler
            (device busy share, top kernels and the port's own);
            informational;
6. cli    — `python -m readbouncer_tpu_torch --config` on 2,048 of the
            reads: output FASTAs and counters equal to the in-process run,
            over the .ribf filters and again over the genome FASTAs
            (which the CLI builds on the card);
   cli build/update — usage build on genome 3's FASTA: the bits' sha256
            equals the tracked filter's (and the build's time and peak
            device memory in-process); usage update of genome 0's filter
            with genome 1's FASTA: the old bins equal genome 0's filter,
            new bin 512 + j equals bin j of genome 1's, seqids and ranges
            appended;
   tool profile — `python -m readbouncer_tpu_torch.tools.profile_realistic`
            over the saved filters (nothing rebuilt): exits 0, K1 and K4
            launched;
7. gru    — K3 (gru_layer) against its plain version on the live path's
            real gate inputs (chunk signals framed and projected through
            synth48's layer 0) at B=256 and 512, T=320, H=48, both scan
            directions, and at H=96 with seeded random weights; the full
            forward's logits and argmax tokens against the plain forward,
            and both forwards against the plain forward in float64; timed
            beside PyTorch's cuDNN nn.GRU as a yardstick; K3's
            launch (rows per block, slices, threads, registers and local
            memory per thread, which must be 0: no spill) printed;
8. live   — tools/bench_live.py::run_bench_live (its warm-ups, the
            first tick, AdaptiveSampler.run, its JSON line printed) on
            bench_live's workload with the synth48 GRU caller, then with
            the Oracle caller; counters from the first tick on: 1,024 reads unblocked
            (every genome-3 read) and 1,024 stop_receiving (every genome-0
            read), nothing unclassified, no failed action, the K1, K2 (and
            with the GRU, K3) counters and the native encode_batch's
            calls risen; tick latencies;
9. cli live — `python -m readbouncer_tpu_torch` usage target (DeepNano
            caller, synth48) on a small replay FASTA: output FASTAs,
            decision CSV (less its timing column) and counters equal to
            an in-process run, and again with [TPU] mesh_shape = "bins:1";
            "bins:2" exits non-zero (needs 2 devices, have 1); usage
            test;
10. sharded — ShardedFilterStack over cuda:0 repeated on meshes bins:2
            and data:2,bins:2: per-filter maxima of chunk 0 of every
            read (classify's phase A, 40 batches of 1,024) bit-equal to
            the unsharded stack, K1 and K2 launched once per cell and
            batch; then the live loop of phase 8 (synth48) with
            ShardedLiveClassifier over data:2,bins:2: 1,024 / 1,024;
11. multi-process — the CLI's classify in two processes joined by
            [TPU] coordinator (gloo, a free local port), both on the
            card, over all 40,960 reads: rank 0 reports 20,493 / 40,960,
            the .h0 / .h1 FASTAs are disjoint and together the
            single-process run's;
12. remote — the CLI's target with caller = "remote" on bench_live's
            reads (their signals recorded to an .npz), against
            serve_basecalls in a thread of this process running the
            synth48 GRU on the card (K3), one read per request: every
            depletion read unblocked, every other read stopped;
13. train — the CTC trainer at scripts/train_basecaller.py's shape
            (H=48, 4 layers, window 66; batch 64 of 160 bases): step 1
            on the card within 1e-4 relative of the CPU's, 20 steps of
            the tool's optimizer lower the loss, K3 never launched in
            training, the data:2 step over cuda:0 twice within 1e-5 of
            the single step, ms per step; the tracked synth48 net's
            identity on tests/test_basecaller_e2e.py's draw >= 0.95;
14. gather — K5 (xor_gather) at the gather probe's defaults (974,848
            indices, CH=2048, NBUF=8) on [154,533, 8, 128] blocks and
            [1,236,269, 1, 128] rows bit-equal to its plain version, timed
            (and its kernels per call counted and timed by the profiler)
            beside PyTorch's index_select baselines (torch_block,
            torch_g3); then the probe tool's four experiments and --check
            (the probe's small shapes against numpy) in-process, which must
            return 0;
15. tools — the other three tools' run_* functions (tools.bench and
            tools.bench_live ran as phases 5 and 8), each one's launches
            counted from 0 over the call and its JSON line printed:
            tools.profile_classify on the first 16,384 reads (decisions
            equal to phase 5's), tools.bench_toy (its own narrow filters,
            built on the card; the first 2,048 reads decided as the CPU
            run of the plain versions decides them, read by read) and
            tools.bench_build (three builds of a 51.2 Mb genome on the
            card, the bits of all three equal to one build of the same
            genome on the CPU, which takes the native insert);
16. probes — tools.proto_counts_layout at its full constants (R=8192,
            L=250, W=8, 1,236,269 rows): ripple, tree, flat, flatg and k1
            (``counts`` through K1) all equal, K1 launched, times beside
            K1's byte bound at that shape; tools.dedup_probe invgather and
            counts --dup 0.5, the dedup sums equal to the baseline's;
            every tools.gather_probe experiment at its defaults
            (gprod_nobar is gprod's program, run once untimed);
            tools.transfer_probe once; graft_entry.entry() on the card
            (logits [8, 128, 5], K3 launched, within the K3 logits gate
            of the plain forward on seeded frames) and
            graft_entry.dryrun_steps(4) (K1 and K2 launched, the loss
            finite);
17. mesh across processes — two processes of this script
            (``--mesh-rank``) on the card, joined by a gloo group on a free
            local port, each naming cuda:0 (once for bins:2, twice for
            data:2,bins:2); each loads phase 3's filters from its cache
            (nothing rebuilt), draws bench's reads and bench_live's
            workload from the seeds and copies to the card only the word
            blocks of its cells.  On bins:2, then data:2,bins:2, the
            maxima of phase 10's batches are bit-equal to the unsharded
            stack's in both ranks, K1 and K2 launched once per owned cell
            and batch in each, one max all-reduce per call (timed apart
            from the card's work); then the live loop of phase 8 (synth48)
            with ShardedLiveClassifier over the cross-process bins:2 mesh:
            1,024 / 1,024 in each rank.  Prints each rank's resident bits
            and ms per max_counts_dual call.

Prints one line per phase with its seconds, the tools' JSON lines, a
JSON line with the kernels' numbers, the card line, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.

``--k2-only`` runs phases 1-4 and prints K2's times at the three shapes
as one JSON line, then the card line.  ``--k4-k5-only`` runs phases 1-3,
K4's counts phase and K5's part of the gather phase, and prints as one
JSON line K4's and K5's times, the profiler's device time per kernel of
one call, and K4's SASS (instructions in its window loop per word loaded,
from cuobjdump, and registers per thread), then the card line.
``--probes-only`` runs phases 1-2 and 16 and prints the probes' numbers
as one JSON line, then the card line.  ``--mesh-only`` runs phases 1-3
and 17 and prints phase 17's numbers, then the card line.  The first two modes call only
wrapper functions that earlier trees also have, so a copy
of this file placed at the root of another checkout of the repo times
that checkout's kernels on the same inputs the same way: how two versions
of a kernel are compared in one run.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from readbouncer_tpu_torch import graft_entry
from readbouncer_tpu_torch.classify.engine import ClassifyEngine, encode_batch, encode_batch_np
from readbouncer_tpu_torch.classify.fused import LiveFused, plan_stacks, stack_dual_max, threshold_table
from readbouncer_tpu_torch.classify.math import ci_and_threshold_batch
from readbouncer_tpu_torch.classify.policy import classify_decisions
from readbouncer_tpu_torch.config import ConfigReader
from readbouncer_tpu_torch.device import host_tensor
from readbouncer_tpu_torch.fastio.fasta import read_records, read_records_py
from readbouncer_tpu_torch.ibf.build import build_ibf
from readbouncer_tpu_torch.ibf.hashing import encode_bases
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.query import FilterStack, anded_windows, counts
from readbouncer_tpu_torch.ibf.query_np import counts_np
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.main import live_config, make_basecaller, make_replay_source
from readbouncer_tpu_torch.models.basecaller import GRUBasecaller
from readbouncer_tpu_torch.models.eval import batch_identity
from readbouncer_tpu_torch.models.gru import frame_signal_t, gru_logits
from readbouncer_tpu_torch.models.remote import serve_basecalls
from readbouncer_tpu_torch.models.train import (
    cosine_decay, ctc_loss, host_params, init_gru_params, make_sharded_train_step, make_train_step, param_leaves, param_tree,
)
from readbouncer_tpu_torch.ops import gather
from readbouncer_tpu_torch.ops import gru as gru_ops
from readbouncer_tpu_torch.ops import ibf_count
from readbouncer_tpu_torch.native import CALLS as NATIVE_CALLS
from readbouncer_tpu_torch.native import load_native
from readbouncer_tpu_torch.ops._build import load_all, load_library
from readbouncer_tpu_torch.parallel import distributed
from readbouncer_tpu_torch.parallel import sharded as sharded_module
from readbouncer_tpu_torch.parallel.mesh import Mesh, make_mesh, parse_mesh_shape
from readbouncer_tpu_torch.parallel.sharded import ShardedFilterStack, ShardedLiveClassifier
from readbouncer_tpu_torch.stream.replay import ReplayRead, ReplaySource, sequence_to_signal
from readbouncer_tpu_torch.stream.scheduler import AdaptiveSampler, LiveClassifier, LiveConfig
from readbouncer_tpu_torch.tools import (
    bench_build, bench_toy, dedup_probe, dma_gather_probe, gather_probe, profile_classify, proto_counts_layout,
    train_basecaller, transfer_probe,
)
from readbouncer_tpu_torch.tools._bench_util import card
from readbouncer_tpu_torch.tools.bench import BATCH_SIZE as BATCH
from readbouncer_tpu_torch.tools.bench import (
    BINS_PER_FILTER, BITS_SHA, ERROR_RATE, FRAGMENT, HOST_BATCH, N_READS, N_TIMED_RUNS, READ_LEN, bench_filters,
    bench_name, bench_reads, run_bench,
)
from readbouncer_tpu_torch.tools.bench_live import TICK_BUDGET_S, live_workload, make_caller, run_bench_live

ROOT = Path(__file__).resolve().parent

# bench.py's geometry and read set come from tools/bench.py
EXPECT_CLASSIFIED = 20_493  # every recorded bench run (BENCH_r03..r05.json)
ORACLE_READS = 256
CLI_READS = 2_048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# scripts/bench_live.py's workload
LIVE_READS = 2_048
LIVE_READ_LEN = 4_000
LIVE_CHANNELS = 512
LIVE_BATCH = 512
LIVE_FRAMES = 320  # frames of a 0.4 s chunk, (1600 - 66) // 5 + 1 = 307, padded to x64
CLI_LIVE_READS = 64
# int32 ALU rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the fp32 rate
# of 67 TFLOP/s counts 128 lanes and an FMA as two operations); the IBF
# kernels' least work is far below it, so their bound is the bytes
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# scripts/profile_realistic.py's batch: 2,048 reads of one 250 bp chunk
# (the engine's chunk_length, also phase A's chunk in phases 10 and 17)
COUNTS_READS = 2_048
COUNTS_CHUNK = 250
# scripts/dma_gather_probe.py's defaults
GATHER_M = 2048 * 2 * 238
GATHER_CH = 2048
GATHER_NBUF = 8
SHARD_MESHES = ("bins:2", "data:2,bins:2")  # over cuda:0 repeated
LIVE_MESH = "data:2,bins:2"
MP_PROCESSES = 2
# phase 17: meshes across MP_PROCESSES processes, each naming cuda:0 once
# (bins:2) or twice (data:2,bins:2); the live loop over the first
CROSS_MESHES = ("bins:2", "data:2,bins:2")
MESH_GROUP_TIMEOUT = timedelta(seconds=120)  # each collective's limit in the workers
MESH_PHASE_TIMEOUT_S = 420
WAVES_READS = 2_048
REMOTE_READS = LIVE_READS
REMOTE_CHANNELS = LIVE_CHANNELS
TRAIN_BATCH = 64  # scripts/train_basecaller.py's defaults
TRAIN_BASES = 160
TRAIN_STEPS = 20
TRAIN_LR = 2e-3
PROFILE_READS = 16_384  # scripts/profile_classify.py's default
TOY_CPU_READS = 2_048  # bench_toy's reads decided again on the CPU
K3_LOGITS_GATE = 1e-4  # the kernel forward's logits, max abs from the plain forward's
PROTO_REPS = 3  # scripts/proto_counts_layout.py's timed calls per variant
GRAFT_DRYRUN_DEVICES = 4
HOST_REPS = 5  # timed runs of each encode in the host phase (median)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> None:
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(load_native)  # the host C++ compiler, beside the nvcc builds
        libs = load_all()
        host = host.result()
    say(f"build: {len(libs)} libraries, one nvcc each, and the host library, at once: "
        f"{time.monotonic() - t0:.2f} s")
    check(host.path.exists(), "native host library missing after build")
    say(f"  host library: {host.compiler or 'c++'} {'built' if host.built else 'found'} {host.path.name} "
        f"in {host.seconds:.2f} s ({host.module.__name__})")
    for kl in libs:
        check(kl.path.exists(), f"kernel library {kl.name} missing after build")
        say(f"  {kl.name}: nvcc {'built' if kl.built else 'found'} {kl.path.name} in {kl.seconds:.2f} s")
        for line in kl.log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line or "spill" in line):
                say(f"    {line.strip()}")
            elif "bytes stack frame" in line:
                say(f"    {line.strip()}")


def phase_state(dev, cache: Path) -> tuple[list[IBFData], list[np.ndarray]]:
    """bench.py's genomes and filters, built on the card by tools/bench.py
    (which holds each genome and each filter's bits to the tracked
    .bench_cache hashes) and saved under ``cache`` (an empty directory) in
    tools.bench's layout; where the tracked .ribf files are in the
    checkout, each filter is also held equal to its file."""
    filters, genomes = bench_filters(dev, cache=cache)
    for i, ibf in enumerate(filters):
        name = bench_name(i)
        check(ibf.num_bins == BINS_PER_FILTER, f"{name}: {ibf.num_bins} bins")
        tracked = ROOT / ".bench_cache" / f"{name}.ribf"
        if tracked.exists():
            ref = IBFData.load(tracked)
            check(
                np.array_equal(ref.bits, ibf.bits) and ref.num_bins == ibf.num_bins
                and ref.scheme == ibf.scheme and ref.bin_seqids == ibf.bin_seqids
                and np.array_equal(ref.bin_ranges, ibf.bin_ranges),
                f"{name}: differs from {tracked.name} loaded with the port's loader",
            )
            say(f"  {name}: equal to {tracked.name} loaded with the port's loader")
    return filters, genomes


def _median_ms(fn, reps: int = HOST_REPS) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _records(reader, path: Path) -> tuple[list[tuple[str, str]], float]:
    t0 = time.perf_counter()
    recs = [(r.id, r.seq) for r in reader(path, first_word_id=True)]
    return recs, (time.perf_counter() - t0) * 1e3


def phase_host(genomes: list[np.ndarray], seqs: list[str], width: int, work: Path) -> dict:
    """The native host library against its plain versions on the main
    path's host work: encode_batch over bench's reads (bit-equal to
    encode_batch_np; both timed on one PROFILE_READS job, median of
    HOST_REPS), read_records over the four genome FASTAs (one line each),
    a gzip copy of one, the same genome at 80 bases a line and a FASTQ of
    bench's reads (equal to the Python parser; both timed), and the native
    insert: genome 3's filter built on the CPU from its FASTA, bits sha256
    equal to the tracked filter's."""
    out = {}
    got = encode_batch(seqs, width)
    want = encode_batch_np(seqs, width)
    check(all(np.array_equal(g, w) for g, w in zip(got, want)),
          f"host: native encode_batch differs from encode_batch_np on bench's {len(seqs)} reads")
    job = seqs[:PROFILE_READS]
    out["encode_ms"] = {"native": _median_ms(lambda: encode_batch(job, width)),
                        "numpy": _median_ms(lambda: encode_batch_np(job, width))}
    say(f"host: encode_batch of bench's {len(seqs)} reads x {width} bit-equal to encode_batch_np; one "
        f"{len(job)}-read job, median of {HOST_REPS}: native {out['encode_ms']['native']:.2f} ms, numpy "
        f"{out['encode_ms']['numpy']:.2f} ms ({out['encode_ms']['numpy'] / out['encode_ms']['native']:.1f}x)")

    paths = write_genomes(genomes, work)
    gz = work / f"{paths[0].name}.gz"
    gz.write_bytes(gzip.compress(paths[0].read_bytes(), compresslevel=1))
    wrapped = work / "g0_80_columns.fasta"  # genome 0 as FASTA files usually are: 80 bases a line
    g0 = genomes[0].tobytes()
    wrapped.write_bytes(b">g0\n" + b"".join(g0[i : i + 80] + b"\n" for i in range(0, len(g0), 80)))
    fq = work / "bench_reads.fastq"
    with open(fq, "w") as f:
        for i, q in enumerate(seqs):
            f.write(f"@read{i} bench\n{q}\n+\n{'I' * len(q)}\n")
    out["parse_ms"] = {}
    for path in [*paths, gz, wrapped, fq]:
        nat, t_nat = _records(read_records, path)
        py, t_py = _records(read_records_py, path)
        check(nat == py and len(nat) > 0, f"host: {path.name} parses otherwise natively than in Python")
        out["parse_ms"][path.name] = {"native": t_nat, "python": t_py, "records": len(nat),
                                      "mb": path.stat().st_size / 1e6}
        say(f"host: {path.name} ({path.stat().st_size / 1e6:.1f} MB, {len(nat)} records) equal through both "
            f"readers: native {t_nat:.1f} ms, Python {t_py:.1f} ms")

    before = NATIVE_CALLS["insert_fragments"]
    t0 = time.monotonic()
    ibf, _ = build_ibf([paths[3]], IBFParams(kmer_size=13, fragment_length=FRAGMENT), name=bench_name(3),
                       device="cpu")
    out["native_build_s"] = time.monotonic() - t0
    sha = hashlib.sha256(ibf.bits.tobytes()).hexdigest()
    check(NATIVE_CALLS["insert_fragments"] > before, "host: the CPU build did not take the native insert")
    check(sha == BITS_SHA[3], f"host: genome 3's CPU build (native insert) has bits {sha}, not the tracked filter's")
    out["native_build_threads"] = IBFParams().threads
    say(f"host: genome 3's filter built on the CPU from its FASTA (native insert, {out['native_build_threads']} "
        f"threads) in {out['native_build_s']:.2f} s, bits sha256 equal to the tracked filter's")
    return out


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Time of one call of fn with the host out of the way: ``calls`` calls
    captured in one CUDA graph, replayed between CUDA events.  For a
    kernel shorter than the host's cost of a call through its wrapper,
    where cuda_ms would time the host."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def kernels_ms(fn, calls: int = 20) -> dict:
    """Device time per launch and launches of every kernel that ``calls``
    calls of fn run, from torch.profiler: {name: (ms, launches)}.  The
    trace may miss a launch or two, so compare launches between kernels,
    not with ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {key: (ms / n, n) for ms, n, key in device_rows(prof)}


def sass_loops(lib_path: Path, kernel: str) -> dict:
    """K4's SASS, counted: for each function of the library whose name
    holds ``kernel``, its registers per thread (cuobjdump -res-usage) and,
    of its loops (a branch back to an earlier instruction), the one whose
    loads bring the most words: its instructions, the 32-bit words its
    global loads bring, instructions per word, and its most frequent
    opcodes."""
    from readbouncer_tpu_torch.ops._build import find_nvcc

    tool = str(Path(find_nvcc()).parent / "cuobjdump")
    res = subprocess.run([tool, "-res-usage", str(lib_path)], capture_output=True, text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump -res-usage failed: {res.stderr[-500:]}")
    regs = dict(re.findall(r"Function (\S+):\s*\n?\s*REG:(\d+)", res.stdout))
    dump = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=120)
    check(dump.returncode == 0, f"cuobjdump -sass failed: {dump.stderr[-500:]}")
    out = {}
    for block in re.split(r"\n\s*Function : ", dump.stdout)[1:]:
        name = block.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        instrs, labels = [], {}
        for line in block.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                labels[m.group(1)] = len(instrs)
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                instrs.append((int(m.group(1), 16), m.group(2)))
        addr = {a: k for k, (a, _) in enumerate(instrs)}

        def opcode(text: str) -> str:  # "@!P0 LDG.E.128.CONSTANT R4, ..." -> "LDG.E.128.CONSTANT"
            return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]

        def words(text: str) -> int:  # the width is in the opcode, not in "[R2.64]"
            op = opcode(text).split(".")
            if op[0] != "LDG":
                return 0
            return 4 if "128" in op else 2 if "64" in op else 1

        best = None
        for k, (_, text) in enumerate(instrs):
            if "BRA" not in text:
                continue
            m = re.search(r"`\((\.L_x_\d+)\)", text) or re.search(r"BRA\s+(?:\S+\s+)?(0x[0-9a-f]+)", text)
            if not m:
                continue
            tgt = labels.get(m.group(1)) if m.group(1).startswith(".L") else addr.get(int(m.group(1), 16))
            if tgt is None or tgt > k:
                continue
            body = [t for _, t in instrs[tgt : k + 1]]
            nw = sum(words(t) for t in body)
            if nw and (best is None or nw > best["words"]):
                ops = {}
                for t in body:
                    op = opcode(t).split(".")[0]
                    ops[op] = ops.get(op, 0) + 1
                top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:8])
                best = dict(instructions=len(body), words=nw, per_word=len(body) / nw, opcodes=top)
        out[name] = dict(registers=int(regs.get(name, -1)), total_instructions=len(instrs), loop=best)
    check(bool(out), f"no {kernel} function in {lib_path.name}")
    return out


def launch_ms(fn, kernel: str, calls: int = 20) -> float:
    """Device time per launch of the kernels whose name holds ``kernel``,
    over ``calls`` calls of fn traced by torch.profiler (kernels_ms)."""
    hits = [(ms * n, n) for key, (ms, n) in kernels_ms(fn, calls).items() if kernel in key]
    check(bool(hits), f"no {kernel} launch in the profile")
    return sum(t for t, _ in hits) / sum(n for _, n in hits)


def time_k2(planes, args) -> dict:
    """K2's time per call three ways: ``ms`` from a CUDA graph (graph_ms),
    ``launch_ms`` from the profiler's device time per launch, and
    ``call_ms`` through its wrapper between CUDA events, host included."""
    fn = lambda: ibf_count.planes_dual_max(planes, *args)  # noqa: E731
    return dict(ms=graph_ms(fn), launch_ms=launch_ms(fn, "planes_dual_max_kernel"), call_ms=cuda_ms(fn, 50))


def _anded_inputs(engine: ClassifyEngine, frags: np.ndarray, lens: np.ndarray, tab_b, tab_r):
    """anded words [2R, n, W] of the merged stack and the per-read
    thresholds looked up in the given tables."""
    stack, _ = engine._plan
    dev = engine.device
    frags_t = host_tensor(frags).to(dev)
    lens_t = torch.from_numpy(lens.astype(np.int64)).to(dev)
    anded = anded_windows(
        stack.bits, frags_t, lens_t, k=stack.kmer_size, h=stack.hash_functions,
        rows=stack.rows, scheme=stack.scheme,
    )
    R, _, n, W = anded.shape
    thr_b = tab_b.index_select(0, lens_t).contiguous()
    thr_r = tab_r.index_select(0, lens_t).contiguous()
    return stack, anded.reshape(2 * R, n, W), thr_b, thr_r


def kernel_inputs(engine: ClassifyEngine, seqs: list[str], chunks: slice):
    """K1/K2 inputs for 1,024 reads at the given chunks (classify phase A:
    chunk 0; phase B: chunks 1-3)."""
    cl = engine.chunk_length
    enc, lens = encode_batch(seqs[:BATCH], cl * engine.max_chunks)
    c0, c1 = chunks.start, chunks.stop
    frags = enc[:, c0 * cl : c1 * cl].reshape(-1, cl)
    steps = np.arange(c0, c1) * cl
    clens = np.clip(lens[:, None].astype(np.int64) - steps[None, :], 0, cl).reshape(-1)
    fused = engine._classifier(1, 0)
    return _anded_inputs(engine, frags, clens, fused.tabs["tb"], fused.tabs["tr"])


def live_kernel_inputs(engine: ClassifyEngine, live_seqs: list[str]):
    """K1/K2 inputs of one full live tick's short bucket: 512 reads of the
    live workload as they reach the classifier (two 0.4 s chunks, ~355
    bp) at the bucket width of 512."""
    width = 512
    enc, lens = encode_batch([s[:355] for s in live_seqs[:LIVE_BATCH]], width)
    stack, _ = engine._plan
    live = LiveFused(stack, None, width, ERROR_RATE, 0.95)
    return _anded_inputs(engine, enc, lens, live.tabs["tb"], live.tabs["tr"])


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time for moving ``nbytes`` and doing ``ops`` int32
    operations, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(engine: ClassifyEngine, seqs: list[str], live_seqs: list[str]) -> dict:
    """K1 and K2 against their plain versions at classify's phase-A and
    phase-B shapes and at the live short bucket ("L"); returns per-kernel
    numbers at each shape."""
    out = {}
    shapes = (
        ("A", lambda: kernel_inputs(engine, seqs, slice(0, 1))),
        ("B", lambda: kernel_inputs(engine, seqs, slice(1, 4))),
        ("L", lambda: live_kernel_inputs(engine, live_seqs)),
    )
    for label, inputs in shapes:
        stack, a, thr_b, thr_r = inputs()
        R2, n, W = a.shape
        R = R2 // 2
        P = max(int(n).bit_length(), 1)
        planes = ibf_count.accumulate_planes(a, P)
        plain = ibf_count.accumulate_planes_plain(a, P)
        torch.cuda.synchronize()
        err1 = int(
            (ibf_count.expand_planes(planes) - ibf_count.expand_planes(plain)).abs().max()
        )
        check(torch.equal(planes, plain), f"K1 differs from its plain version at phase {label} (max count err {err1})")
        args = (thr_b, thr_r, stack.mask_words, stack.seg_spec)
        mb, mr = ibf_count.planes_dual_max(planes, *args)
        pb, pr = ibf_count.planes_dual_max_plain(planes, *args)
        torch.cuda.synchronize()
        err2 = int(max((mb - pb).abs().max(), (mr - pr).abs().max()))
        check(torch.equal(mb, pb) and torch.equal(mr, pr), f"K2 differs from its plain version at phase {label}")
        F = len(stack.seg_spec)
        seg_words = sorted({padded // 32 for _, padded in stack.seg_spec})
        say(f"  K2 shape {label}: one warp per (read, segment): {R * F} warps, {P} planes per strand "
            f"and segments of {seg_words} words, 32 words per pass")
        # the least work each function needs, whatever the kernel does:
        # K1 reads every membership word once and writes the planes, and
        # adds each word into bit-sliced counters (a half adder, and +
        # xor, at least); K2 reads the planes, both thresholds, the mask
        # and the segments once and writes mb, mr, and compares bit-sliced
        # counters, 32 bins per word op (a borrow chain of 3 ops per
        # plane, per strand and threshold, plus 3 per plane for the max)
        k1_bytes = a.numel() * 4 + planes.numel() * 4
        k1_ops = R2 * n * W * 2
        k2_bytes = planes.numel() * 4 + 2 * R * 4 + W * 4 + 2 * F * 4 + 2 * R * F * 4
        k2_ops = R * W * P * (2 * 2 * 3 + 3)
        out[("K1", label)] = dict(
            shape=f"a int32 [{R2}, {n}, {W}] -> planes [{R2}, {P}, {W}]",
            max_abs_err=err1,
            ms=cuda_ms(lambda: ibf_count.accumulate_planes(a, P), 20),
            plain_ms=cuda_ms(lambda: ibf_count.accumulate_planes_plain(a, P), 2, warmup=1),
            bytes=k1_bytes, ops=k1_ops,
        )
        out[("K2", label)] = dict(
            shape=f"planes int32 [{R2}, {P}, {W}], F={F} -> mb, mr int32 [{R}, {F}]",
            max_abs_err=err2,
            **time_k2(planes, args),
            plain_ms=cuda_ms(lambda: ibf_count.planes_dual_max_plain(planes, *args), 5),
            bytes=k2_bytes, ops=k2_ops,
        )
        for kname in ("K1", "K2"):
            d = out[(kname, label)]
            d["bound_ms"], d["bound_by"] = _bound(d["bytes"], d["ops"])
            call = (
                f" (CUDA graph; {d['launch_ms']:.4f} ms per launch in the profiler, {d['call_ms']:.4f} ms "
                f"per call through the wrapper)" if "call_ms" in d else ""
            )
            say(
                f"  {kname} shape {label}: {d['shape']}: kernel {d['ms']:.4f} ms{call}, plain "
                f"{d['plain_ms']:.3f} ms, bound {d['bound_ms'] * 1e3:.1f} us ({d['bound_by']}: "
                f"{d['bytes'] / 1e6:.1f} MB, {d['ops'] / 1e6:.0f} M int ops), bit-equal"
            )
    return out


def phase_counts(engine: ClassifyEngine, seqs: list[str]) -> dict:
    """K4 on the v1 input of profile_realistic's geometry, built for real:
    bench reads' first 250 bp chunks, anded windows of the bench stack,
    transposed to [W, n_pad, 2R] with the padded windows zero."""
    stack, _ = engine._plan
    dev = engine.device
    reads, lens = encode_batch(seqs[:COUNTS_READS], COUNTS_CHUNK)
    reads_t, lens_t = host_tensor(reads).to(dev), host_tensor(lens).to(dev)
    kw = dict(k=stack.kmer_size, h=stack.hash_functions, rows=stack.rows, scheme=stack.scheme)
    n = COUNTS_CHUNK - stack.kmer_size + 1
    n_pad = ibf_count.counts_v1_n_pad(n)
    a_t = ibf_count.counts_v1_input(anded_windows(stack.bits, reads_t, lens_t, **kw), n_pad)
    check(tuple(a_t.shape) == (72, 256, 2 * COUNTS_READS), f"K4 input {tuple(a_t.shape)}")
    got = ibf_count.accumulate_counts(a_t)
    plain = ibf_count.accumulate_counts_plain(a_t)
    k1_route = counts(stack.bits, reads_t, lens_t, **kw)
    torch.cuda.synchronize()
    err = int((got - plain).abs().max())
    check(torch.equal(got, plain), f"K4 differs from its plain version (max abs err {err})")
    check(torch.equal(ibf_count.counts_from_v1(got), k1_route), "K4 reshaped differs from the K1 route's counts")
    zeros = torch.zeros_like(a_t)
    # the least work of the function: each membership word read once and
    # added into bit-sliced counters (2 ops, as K1 counts it), and each of
    # the W*32*2R counts written once after an expansion of its P planes
    P = max(int(n).bit_length(), 1)
    nbytes = a_t.numel() * 4 + got.numel() * 4
    ops = 2 * a_t.numel() + 2 * P * got.numel()
    bound_ms, bound_by = _bound(nbytes, ops)
    d = dict(
        shape=f"a_t int32 {list(a_t.shape)} -> counts int32 {list(got.shape)}",
        max_abs_err=err,
        ms=cuda_ms(lambda: ibf_count.accumulate_counts(a_t), 20),
        zeros_ms=cuda_ms(lambda: ibf_count.accumulate_counts(zeros), 20),
        plain_ms=cuda_ms(lambda: ibf_count.accumulate_counts_plain(a_t), 2, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by,
        nonzero_words=float((a_t != 0).float().mean()),
    )
    say(
        f"counts: K4 {d['shape']} on {COUNTS_READS} bench-read chunks of {COUNTS_CHUNK} bp "
        f"({100 * d['nonzero_words']:.2f}% of words non-zero): kernel {d['ms']:.4f} ms (zeros "
        f"{d['zeros_ms']:.4f} ms), plain {d['plain_ms']:.3f} ms, bound {bound_ms * 1e3:.1f} us ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e6:.0f} M int ops); bit-equal to its plain version and, "
        f"reshaped, to the K1 route's counts"
    )
    return d


def oracle_decisions(filters: list[IBFData], seq: str, cl: int, C: int):
    """Chunk loop of the reference on the numpy oracle: (classified, best,
    attempts) for one read, 3 targets + 1 deplete."""
    attempts = 0
    for i in range(C):
        chunk = seq[i * cl : (i + 1) * cl]
        if not chunk:
            break
        attempts += 1
        bases = encode_bases(chunk)
        thr = [
            int(ci_and_threshold_batch(np.array([len(chunk)]), 13, r, 0.95)[0])
            for r in (ERROR_RATE, ERROR_RATE - 0.02)
        ]
        maxima = []
        for f in filters:
            c = counts_np(f, bases)[:, : f.num_bins]
            row = []
            for t in thr:
                matched = (c[0] >= t) | (c[1] >= t)
                row.append(int(np.where(matched, np.maximum(c[0], c[1]), 0).max()))
            maxima.append(row)
        m = np.array(maxima)  # [F, 2]
        ok, best = classify_decisions(m[None, :3, 0], m[None, 3:, 0], m[None, :3, 1], m[None, 3:, 1])
        if ok[0]:
            return True, int(best[0]), attempts
    return False, -1, attempts


def phase_main(dev, engine: ClassifyEngine, filters, seqs: list[str]):
    """tools.bench's run on the main path, its launches counted over the
    timed runs; its decisions held to the numpy oracle on ORACLE_READS
    reads."""
    out = run_bench(filters[:3], filters[3:], seqs, dev, before_timed=_reset_counters)
    launches = _counters()
    native = dict(NATIVE_CALLS)
    line = out["line"]
    print(json.dumps(line), flush=True)
    classified, best, attempts = out["classified"], out["best"], out["attempts"]
    counts = [int(c.sum()) for c in out["classified_by_run"]]
    say(
        f"main: tools.bench classified {counts} of {len(seqs)} in the warm-up and {len(line['run_seconds'])} timed runs "
        f"({', '.join(f'{t:.3f}' for t in line['run_seconds'])} s), median {line['value']} reads/s on "
        f"{line['device']}; launches over the timed runs K1={launches['K1']} K2={launches['K2']}, native "
        f"encode_batch calls {native.get('encode_batch', 0)}; attempts "
        f"histogram {np.bincount(attempts).tolist()}"
    )
    check(all(n == EXPECT_CLASSIFIED for n in counts), f"classified {counts}, expected {EXPECT_CLASSIFIED}")
    check(all(np.array_equal(c, classified) for c in out["classified_by_run"]),
          "a run decided otherwise than the warm-up")
    check(launches["K1"] > 0 and launches["K2"] > 0, f"kernel counters {launches}")
    check(native.get("encode_batch", 0) > 0, f"main: the timed runs did not encode natively: {native}")
    check(((best >= 0) == classified).all(), "best target set exactly for classified reads")
    picks = np.linspace(0, len(seqs) - 1, ORACLE_READS).astype(int)
    t1 = time.monotonic()
    for i in picks:
        want = oracle_decisions(filters, seqs[i], engine.chunk_length, engine.max_chunks)
        got = (bool(classified[i]), int(best[i]), int(attempts[i]))
        check(want == got, f"read {i}: engine {got} vs numpy oracle {want}")
    say(f"  {ORACLE_READS} reads' decisions equal the numpy oracle ({time.monotonic() - t1:.1f} s)")
    t1 = time.monotonic()
    waves = engine.classify_sequences_waves(seqs[:WAVES_READS])
    for name, got, want in zip(("classified", "best", "attempts"), waves, (classified, best, attempts)):
        check(np.array_equal(got, want[:WAVES_READS]), f"chunk-wave oracle: {name} differs on the first "
              f"{WAVES_READS} reads")
    say(f"  chunk-wave oracle (classify_sequences_waves) on the first {WAVES_READS} reads: classified, best "
        f"and attempts equal ({int(waves[0].sum())} classified, {time.monotonic() - t1:.1f} s)")
    return classified, best, attempts, launches, line


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, launches, kernel name) of every kernel in a profile."""
    from torch.autograd import DeviceType

    return [
        (e.self_device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]


PORT_KERNELS = ("accumulate_planes_kernel", "planes_dual_max_kernel", "gru_layer_kernel")


def _listed(rows, top: int):
    """The ``top`` kernels by device time, then any of the port's own
    kernels (PORT_KERNELS) below them."""
    ranked = sorted(rows, reverse=True)
    return ranked[:top] + [r for r in ranked[top:] if any(k in r[2] for k in PORT_KERNELS)]


def phase_profile(engine: ClassifyEngine, seqs: list[str]) -> None:
    """Where the main path's time goes: host encode of the whole read set,
    and one host batch under torch.profiler (device busy share and the
    kernels that take the device time).  Informational; checks nothing."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    encode_batch(seqs, engine.chunk_length * engine.max_chunks)
    say(f"profile: host encode of all {len(seqs)} reads: {time.perf_counter() - t0:.3f} s")
    batch = seqs[:HOST_BATCH]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.classify_sequences(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    say(
        f"profile: one host batch of {len(batch)} reads under the profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(rows)} kernel kinds"
    )
    for ms, count, key in _listed(rows, 10):
        say(f"  {ms:8.2f} ms {count:5d}x {key[:100]}")


def save_filters(filters, filter_dir: Path) -> list[Path]:
    paths = []
    for f in filters:
        paths.append(filter_dir / f"{f.name}.ribf")
        f.save(paths[-1])
    return paths


def phase_cli(paths: list[Path], filters, seqs, classified, best, inputs: str = ".ribf filters") -> None:
    """usage classify through the CLI on CLI_READS reads, over ``paths``
    (the saved filters, or the genome FASTAs the CLI builds first), against
    the in-process run."""
    n = CLI_READS
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        reads = td / "reads.fasta"
        reads.write_text("".join(f">r{i}\n{seqs[i]}\n" for i in range(n)))
        out_dir = td / "out"
        cfg = td / "classify.toml"
        q = lambda ps: ", ".join(f'"{p}"' for p in ps)
        cfg.write_text(
            f'usage = "classify"\noutput_directory = "{out_dir}"\nlog_directory = "{td / "log"}"\n\n'
            f"[IBF]\nkmer_size = 13\nexp_seq_error_rate = {ERROR_RATE}\nchunk_length = 250\n"
            f"max_chunks = 5\ntarget_files = [{q(paths[:3])}]\ndeplete_files = [{q(paths[3:])}]\n"
            f'read_files = ["{reads}"]\n\n[TPU]\nbatch_size = {BATCH}\n'
        )
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.run(
            [sys.executable, "-m", "readbouncer_tpu_torch", "--config", str(cfg)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        check(proc.returncode == 0, f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        m = re.search(r"Number of classified reads\s*:\s*(\d+)", proc.stdout)
        check(m is not None, f"no results block in CLI output: {proc.stdout[-2000:]}")
        want_found = int(classified[:n].sum())
        check(int(m.group(1)) == want_found, f"CLI classified {m.group(1)}, in-process {want_found}")
        for t, f in enumerate(filters[:3]):
            got = (out_dir / f"{f.name}.fasta").read_text()
            want = "".join(f">r{i}\n{seqs[i]}\n" for i in range(n) if classified[i] and best[i] == t)
            check(got == want, f"CLI {f.name}.fasta differs from the in-process run")
            m = re.search(rf"^{re.escape(f.name)}\t : (\d+)", proc.stdout, re.M)
            check(m is not None and int(m.group(1)) == int(((best[:n] == t) & classified[:n]).sum()),
                  f"CLI per-target counter of {f.name}")
        # 1 kb reads are below (max_chunks-1)*chunk_length + k: an
        # unclassified one counts as failed and is written nowhere
        check((out_dir / "unclassified.fasta").read_text() == "", "unclassified.fasta not empty")
        say(f"cli: python -m readbouncer_tpu_torch over the {inputs} classified {want_found}/{n}; "
            f"FASTAs and counters equal to the in-process run")


def write_genomes(genomes: list[np.ndarray], d: Path) -> list[Path]:
    """The bench genomes as FASTA files named as the reference caches them."""
    paths = []
    for i, g in enumerate(genomes):
        paths.append(d / f"{bench_name(i)}.fasta")
        paths[-1].write_bytes(b">" + bench_name(i).encode() + b"\n" + g.tobytes() + b"\n")
    return paths


def run_cli(cfg: Path, what: str) -> subprocess.CompletedProcess:
    proc = subprocess.run(
        [sys.executable, "-m", "readbouncer_tpu_torch", "--config", str(cfg)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"CLI {what} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc


def _real_time(stdout: str) -> float:
    m = re.search(r"Real time : ([0-9.]+) sec", stdout)
    check(m is not None, "no resource report in the CLI output")
    return float(m.group(1))


def phase_cli_build(dev, genome_paths: list[Path], filters, filter_dir: Path) -> dict:
    """usage build on genome 3's FASTA (and the same build in-process, for
    its peak device memory), and usage update of genome 0's filter with
    genome 1's FASTA."""
    params = IBFParams(kmer_size=13, fragment_length=FRAGMENT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ibf, stats = build_ibf([genome_paths[3]], params, name=bench_name(3), device=dev)
    torch.cuda.synchronize()
    d = dict(build_s=time.monotonic() - t0, build_peak_bytes=torch.cuda.max_memory_allocated())
    check(np.array_equal(ibf.bits, filters[3].bits), "build_ibf on the FASTA differs from the records build")
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        cfg = td / "build.toml"
        cfg.write_text(
            f'usage = "build"\noutput_directory = "{td / "out"}"\nlog_directory = "{td / "log"}"\n\n'
            f'[IBF]\nkmer_size = 13\nfragment_size = {FRAGMENT}\ntarget_files = ["{genome_paths[3]}"]\n'
        )
        proc = run_cli(cfg, "build")
        built = IBFData.load(td / "out" / f"{bench_name(3)}.ribf")
        digest = hashlib.sha256(built.bits.tobytes()).hexdigest()
        check(digest == BITS_SHA[3], f"usage build: bits sha256 {digest} is not the tracked filter's")
        check(built.bin_seqids == filters[3].bin_seqids and np.array_equal(built.bin_ranges, filters[3].bin_ranges),
              "usage build: bin seqids or ranges differ")
        d["cli_build_s"] = _real_time(proc.stdout)

        g0, g1 = filters[0], filters[1]
        cfg = td / "update.toml"
        cfg.write_text(
            f'usage = "update"\noutput_directory = "{td / "upd"}"\nlog_directory = "{td / "log"}"\n\n'
            f'[IBF]\nkmer_size = 13\ntarget_files = ["{genome_paths[1]}"]\n'
            f'update_filter = "{filter_dir / f"{g0.name}.ribf"}"\n'
        )
        proc = run_cli(cfg, "update")
        upd = IBFData.load(td / "upd" / f"{g0.name}.ribf")
        d["cli_update_s"] = _real_time(proc.stdout)
    old = g0.num_bins
    check(old % 32 == 0 and upd.num_bins == old + g1.num_bins, f"usage update: {upd.num_bins} bins")
    # each bin's column depends only on its own fragment, and the new bins
    # start on a word boundary (512 = 16 words): old bins are genome 0's
    # filter, new bin old + j is bin j of genome 1's, the rest is zero
    w_old, w_new = old // 32, g1.num_bins // 32
    check(np.array_equal(upd.bits[:, :w_old], g0.bits[:, :w_old]), "usage update: old bins changed")
    check(np.array_equal(upd.bits[:, w_old : w_old + w_new], g1.bits[:, :w_new]),
          "usage update: new bins differ from genome 1's filter")
    check(not upd.bits[:, w_old + w_new :].any(), "usage update: bits past the new bins")
    check(upd.bin_seqids == g0.bin_seqids + g1.bin_seqids, "usage update: bin seqids not appended")
    check(np.array_equal(upd.bin_ranges, np.concatenate([g0.bin_ranges, g1.bin_ranges])),
          "usage update: bin ranges not appended")
    say(
        f"cli build/update: build_ibf on genome 3's FASTA ({stats.sum_seq_len / 1e6:.1f} Mb) "
        f"{d['build_s']:.2f} s, peak device memory {d['build_peak_bytes'] / 1e9:.3f} GB; usage build "
        f"{d['cli_build_s']:.2f} s (the CLI's real time), bits sha256 equal to the tracked filter; usage "
        f"update of {g0.name} with genome 1 {d['cli_update_s']:.2f} s: {upd.num_bins} bins, old bins equal, "
        f"new bin {old} + j equals bin j of {g1.name}, seqids and ranges appended"
    )
    return d


def phase_tool_profile(filter_dir: Path) -> dict:
    """tools/profile_realistic.py over the saved bench filters (nothing is
    rebuilt); returns the kernel launches the tool counted in its run."""
    proc = subprocess.run(
        [sys.executable, "-m", "readbouncer_tpu_torch.tools.profile_realistic", "--cache", str(filter_dir)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=600,
    )
    for line in proc.stdout.splitlines():
        if "first call" not in line:
            say(f"  | {line}")
    check(proc.returncode == 0, f"profile_realistic exited {proc.returncode}: {proc.stderr[-2000:]}")
    check("built g" not in proc.stdout, "profile_realistic rebuilt a filter")
    m = re.search(r"^launches: (\{.*\})$", proc.stdout, re.M)
    check(m is not None, "profile_realistic printed no launches line")
    launches = json.loads(m.group(1))
    check(launches["K1"] > 0 and launches["K4"] > 0, f"profile_realistic launches {launches}")
    return launches


# ---------------------------------------------------------------- live loop


def _gru_bound(B: int, T: int, H: int) -> tuple[float, str, int, int]:
    """The least time of one GRU layer's recurrence: xg read and ys written
    once (plus the weights), or its products (6 B T H^2) and gate math
    (~12 B T H) at the fp32 rate, whichever is larger."""
    nbytes = 4 * (B * T * 3 * H + B * T * H + 3 * H * H + 3 * H)
    flops = 2 * B * T * H * 3 * H + 12 * B * T * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def _nn_gru(layer: dict, H: int, dev) -> torch.nn.GRU:
    """cuDNN's GRU with one layer's weights, gates reordered to (r, z, n)."""
    wz, wr, wn = layer["w_zrn"].split(H, dim=1)
    bz, br, bn = layer["b_zrn"].split(H)
    rz, rr = layer["r_zr"].split(H, dim=1)
    bhz, bhr = layer["b_hzr"].split(H)
    gru = torch.nn.GRU(H, H, batch_first=True).to(dev)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.cat([wr.T, wz.T, wn.T]))
        gru.bias_ih_l0.copy_(torch.cat([br, bz, bn]))
        gru.weight_hh_l0.copy_(torch.cat([rr.T, rz.T, layer["rn"].T]))
        gru.bias_hh_l0.copy_(torch.cat([bhr, bhz, layer["bhn"]]))
    return gru


def gru_config(B: int, H: int) -> dict:
    """The launch K3 makes for (B, H), as ops/csrc/gru.cu::rb_gru_config
    reports it (registers and local memory from cudaFuncGetAttributes)."""
    keys = ("rows", "slices", "threads", "blocks", "chunks", "registers", "local_bytes",
            "shared_bytes", "blocks_per_sm")
    out = (ctypes.c_int * len(keys))()
    err = load_library("gru").lib.rb_gru_config(B, H, ctypes.cast(out, ctypes.c_void_p))
    check(err == 0, f"rb_gru_config({B}, {H}) failed: CUDA error {err}")
    return dict(zip(keys, out))


def _gru_case(name: str, layer: dict, x: torch.Tensor) -> dict:
    """K3 against its plain version (both directions) on x's gate inputs,
    timed beside the plain loop and cuDNN's nn.GRU on the same x."""
    B, T, H = x.shape
    with torch.no_grad():
        xg = (x @ layer["w_zrn"] + layer["b_zrn"]).contiguous()
        err = 0.0
        for reverse in (False, True):
            got = gru_ops.gru_layer(layer, xg, reverse=reverse)
            want = gru_ops.gru_layer_plain(layer, xg, reverse=reverse)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
        check(err <= 1e-5, f"K3 {name}: max abs error {err:.3g} on ys > 1e-5")
        gru = _nn_gru(layer, H, x.device)
        lib_err = float((gru(x)[0] - gru_ops.gru_layer(layer, xg)).abs().max())
        ms = cuda_ms(lambda: gru_ops.gru_layer(layer, xg), 20)
        plain_ms = cuda_ms(lambda: gru_ops.gru_layer_plain(layer, xg), 2, warmup=1)
        lib_ms = cuda_ms(lambda: gru(x), 20)
    bound_ms, bound_by, nbytes, flops = _gru_bound(B, T, H)
    cfg = gru_config(B, H)
    check(cfg["local_bytes"] == 0, f"K3 {name}: {cfg['local_bytes']} B of local memory per thread (a spill)")
    say(f"  K3 {name}: {cfg['rows']} batch rows per block, {cfg['slices']} slices per unit, "
        f"{cfg['blocks']} blocks of {cfg['threads']} threads ({cfg['blocks_per_sm']} fit an SM), "
        f"{cfg['chunks']} float4 chunks per slice; {cfg['registers']} registers and "
        f"{cfg['local_bytes']} B local memory per thread, {cfg['shared_bytes']} B shared memory per block")
    d = dict(
        shape=f"xg f32 [{B}, {T}, {3 * H}] -> ys f32 [{B}, {T}, {H}]",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=lib_ms, library_max_abs_err=lib_err, config=cfg,
    )
    say(
        f"  K3 {name}: {d['shape']}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, nn.GRU (cuDNN, "
        f"input projection included) {lib_ms:.4f} ms, bound {bound_ms * 1e3:.1f} us ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); max abs err {err:.2e} (plain), "
        f"{lib_err:.2e} (nn.GRU)"
    )
    return d


def forward_f64(params: dict, frames: torch.Tensor) -> torch.Tensor:
    """The plain forward (models/gru.py::gru_logits, kernel=False) in
    float64: the witness both float32 forwards are held against."""
    f64 = {k: v.double() for k, v in params.items() if k != "layers"}
    x = frames.double() @ f64["w_in"] + f64["b_in"]
    for li, layer in enumerate(params["layers"]):
        lay = {k: v.double() for k, v in layer.items()}
        x = gru_ops.gru_layer_plain(lay, x @ lay["w_zrn"] + lay["b_zrn"], reverse=li % 2 == 1)
    return x @ f64["w_out"] + f64["b_out"]


def phase_gru(dev, workload) -> dict:
    """K3 on the live path's real gate inputs, the full forward against the
    plain forward, and K3's launches per full 512-chunk tick."""
    caller = GRUBasecaller(network="synth48", max_frames=LIVE_FRAMES, device=dev)
    model = caller.model
    p = model.params
    chunks = [sig[:1600] for _, sig, _, _ in workload[:LIVE_BATCH]]
    batch, _ = caller.signal_batch(chunks, LIVE_BATCH)
    with torch.no_grad():
        sig = torch.from_numpy(batch).to(dev)
        frames = frame_signal_t(sig.float(), model.window, model.frame_stride)
        x0 = frames @ p["w_in"] + p["b_in"]  # layer 0's input [512, 320, 48]
    out = {}
    for B in (256, 512):
        out[f"B{B}"] = _gru_case(f"synth48 layer 0, B={B}", p["layers"][0], x0[:B].contiguous())
    H = 96
    rng = np.random.default_rng(96)
    lim = 1.0 / np.sqrt(H)
    shapes = {"w_zrn": (H, 3 * H), "b_zrn": (3 * H,), "r_zr": (H, 2 * H), "b_hzr": (2 * H,),
              "rn": (H, H), "bhn": (H,)}
    layer96 = {k: torch.from_numpy(rng.uniform(-lim, lim, v).astype(np.float32)).to(dev)
               for k, v in shapes.items()}
    x96 = torch.from_numpy(rng.normal(size=(256, LIVE_FRAMES, H)).astype(np.float32)).to(dev)
    out["H96"] = _gru_case("H=96 seeded random weights, B=256", layer96, x96)
    with torch.no_grad():
        kern = model.logits(frames)
        plain = gru_logits(p, frames, kernel=False)
        torch.cuda.synchronize()
        lerr = float((kern - plain).abs().max())
        tk, tp = kern.argmax(-1), plain.argmax(-1)
        diff = (tk != tp).nonzero()
        top2 = plain.topk(2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1])[tk != tp]
        witness = forward_f64(p, frames)
        kerr64 = float((kern.double() - witness).abs().max())
        perr64 = float((plain.double() - witness).abs().max())
    say(
        f"  forward [512, 320, 66] -> logits [512, 320, 5]: max abs err {lerr:.2e} against the plain "
        f"forward; {len(diff)} argmax tokens differ; against the float64 forward: kernel {kerr64:.2e}, "
        f"plain {perr64:.2e}"
    )
    check(lerr <= K3_LOGITS_GATE, f"forward: max abs error {lerr:.3g} on logits > {K3_LOGITS_GATE}")
    check(bool((gaps < 1e-4).all()), f"forward: {len(diff)} tokens differ, top-2 gaps {gaps.tolist()[:8]}")
    before = gru_ops.gru_layer.launches
    caller.basecall(chunks)
    per_tick = gru_ops.gru_layer.launches - before
    check(per_tick == 8, f"K3 launches per 512-chunk tick {per_tick}, expected 2 halves x 4 layers")
    say(f"  K3 launches per full 512-chunk tick: {per_tick} (2 halves x 4 layers)")
    out.update(logits_max_abs_err=lerr, tokens_differ=len(diff), launches_per_tick=per_tick,
               logits_f64_err={"kernel": kerr64, "plain": perr64})
    return out


def _counters() -> dict:
    return {
        "K1": ibf_count.accumulate_planes.launches,
        "K2": ibf_count.planes_dual_max.launches,
        "K3": gru_ops.gru_layer.launches,
        "K4": ibf_count.accumulate_counts.launches,
        "K5": gather.xor_gather.launches,
    }


def _reset_counters() -> None:
    ibf_count.accumulate_planes.launches = 0
    ibf_count.planes_dual_max.launches = 0
    gru_ops.gru_layer.launches = 0
    ibf_count.accumulate_counts.launches = 0
    gather.xor_gather.launches = 0
    NATIVE_CALLS.clear()  # the host library's calls, counted by its callers


def profile_live_tick(basecaller, classifier, workload) -> None:
    """One full-width tick's work under torch.profiler: the GRU basecall of
    512 fresh 0.4 s chunks, then the decisions on 512 reads of two chunks'
    length (~355 bp).  Informational; checks nothing."""
    from torch.profiler import ProfilerActivity, profile

    chunks = [sig[:1600] for _, sig, _, _ in workload[:LIVE_BATCH]]
    seqs = [seq[:355] for _, _, seq, _ in workload[:LIVE_BATCH]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        basecaller.basecall(chunks)
        t1 = time.perf_counter()
        classifier.decide(seqs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    wall = (t2 - t0) * 1e3
    say(
        f"  live tick profile (512 chunks, under the profiler): wall {wall:.1f} ms (basecall "
        f"{(t1 - t0) * 1e3:.1f}, decide {(t2 - t1) * 1e3:.1f}), device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%)"
    )
    for ms, count, key in _listed(rows, 8):
        say(f"    {ms:8.3f} ms {count:5d}x {key[:100]}")


def sharded_live_run(dev, filters, workload, basecaller, mesh: Mesh):
    """run_bench_live's loop with ShardedLiveClassifier over ``mesh``: the
    same warm-ups, counters reset before the first tick.  Returns (stats,
    replayed reads, warm-up s, first tick s, wall s)."""
    src = ReplaySource(
        reads=[ReplayRead(rid, sig, seq) for rid, sig, seq, _ in workload], channels=LIVE_CHANNELS
    )
    cfg = LiveConfig(batch_size=LIVE_BATCH, profile_ticks=True)
    classifier = ShardedLiveClassifier(filters[:3], filters[3:], cfg, mesh)
    with tempfile.TemporaryDirectory() as td:
        sampler = AdaptiveSampler(src, basecaller, classifier, output_dir=td, cfg=cfg)
        t0 = time.monotonic()
        classifier.decide(["ACGT" * (w // 4) for w in classifier.bucket_lens])
        if isinstance(basecaller, GRUBasecaller):
            b = 32
            while b <= LIVE_CHANNELS:
                basecaller.basecall([np.zeros(1600, np.float32)] * b)
                b *= 2
        torch.cuda.synchronize()
        warm = time.monotonic() - t0
        _reset_counters()
        t0 = time.monotonic()
        sampler.step()
        first = time.monotonic() - t0
        stats = sampler.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return stats, src.reads, warm, first, wall


def phase_live(dev, filters, workload, caller_name: str, mesh: Mesh | None = None) -> dict:
    """The live loop on bench_live's workload: tools.bench_live's run or,
    with ``mesh``, sharded_live_run; the counters read from the first tick
    on.  Checks every read's action by its origin and that the path's
    kernels launched (over a mesh, K1 and K2 once per owned cell and
    batch)."""
    origin = {rid: g for rid, _, _, g in workload}
    gru = caller_name == "synth48"
    basecaller = make_caller(caller_name, LIVE_FRAMES, dev)
    if mesh is not None:
        stats, reads, warm, first, wall = sharded_live_run(dev, filters, workload, basecaller, mesh)
        launches = _counters()
        caller_name = f"{caller_name}, mesh {','.join(f'{a}:{n}' for a, n in mesh.shape.items())}"
    else:
        out = run_bench_live(filters[:3], filters[3:], workload, basecaller, dev, LIVE_CHANNELS, LIVE_BATCH,
                             before_timed=_reset_counters)
        launches = _counters()
        print(json.dumps(out["line"]), flush=True)
        stats, reads, warm, first = out["stats"], out["reads"], out["warmup_s"], out["first_tick_s"]
        wall = first + out["line"]["wall_seconds"]
        if gru:
            profile_live_tick(basecaller, out["classifier"], workload)
    lat = np.array(stats.tick_latencies[1:])
    prof = stats.tick_profile[1:]
    bc = [q["basecall_ms"] for q in prof if "basecall_ms" in q]
    cl = [q["classify_ms"] for q in prof if "classify_ms" in q]
    wrong = [r.read_id for r in reads if r.unblocked != (origin[r.read_id] == 3)]
    d = dict(
        ticks=stats.ticks, unblocked=stats.unblocked, stop_received=stats.stop_received,
        unclassified=stats.unclassified, actions_failed=stats.actions_failed,
        p50_ms=float(np.median(lat)) * 1e3, p95_ms=float(np.percentile(lat, 95)) * 1e3,
        max_ms=float(lat.max()) * 1e3, within_budget=float((lat < TICK_BUDGET_S).mean()),
        basecall_ms=float(np.mean(bc)), classify_ms=float(np.mean(cl)),
        first_tick_s=first, warmup_s=warm, wall_s=wall, launches=launches,
    )
    say(
        f"live ({caller_name}): {stats.ticks} ticks in {wall:.2f} s; unblocked {stats.unblocked}, "
        f"stop_receiving {stats.stop_received}, unclassified {stats.unclassified}, actions failed "
        f"{stats.actions_failed}; tick latency p50 {d['p50_ms']:.2f} ms, p95 {d['p95_ms']:.2f} ms, "
        f"max {d['max_ms']:.2f} ms, {100 * d['within_budget']:.1f}% within {TICK_BUDGET_S} s; mean "
        f"basecall {d['basecall_ms']:.2f} ms and classify {d['classify_ms']:.2f} ms per tick; "
        f"first tick {first:.2f} s, warm-up {warm:.2f} s; launches {launches}"
    )
    check(stats.unblocked == LIVE_READS // 2, f"live {caller_name}: unblocked {stats.unblocked}")
    check(stats.stop_received == LIVE_READS // 2, f"live {caller_name}: stop_receiving {stats.stop_received}")
    check(not wrong, f"live {caller_name}: {len(wrong)} reads acted on against their origin: {wrong[:5]}")
    check(stats.unclassified == 0 and stats.actions_failed == 0,
          f"live {caller_name}: unclassified {stats.unclassified}, failed {stats.actions_failed}")
    needed = ("K1", "K2", "K3") if gru else ("K1", "K2")
    check(all(launches[k] > 0 for k in needed), f"live {caller_name}: kernel counters {launches}")
    check(NATIVE_CALLS["encode_batch"] > 0, f"live {caller_name}: no native encode_batch call")
    if mesh is not None:
        cells = int((mesh.ranks == distributed.process_index()).sum())
        check(launches["K1"] == launches["K2"] and launches["K1"] % cells == 0,
              f"live {caller_name}: K1 and K2 not launched once per cell and batch: {launches}")
    return d


def phase_cli_live(filter_dir: Path, dev, workload) -> None:
    """usage target through the CLI against an in-process run of the same
    config, then usage test."""
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        fasta = td / "replay.fasta"
        fasta.write_text("".join(f">{rid}\n{seq}\n" for rid, _, seq, _ in workload[:CLI_LIVE_READS]))
        q = lambda ps: ", ".join(f'"{filter_dir / f"{bench_name(i)}.ribf"}"' for i in ps)

        def config(name, usage, tpu=""):
            cfg = td / f"{name}.toml"
            cfg.write_text(
                f'usage = "{usage}"\noutput_directory = "{td / name}"\nlog_directory = "{td / "log"}"\n\n'
                f"[IBF]\nkmer_size = 13\nexp_seq_error_rate = {ERROR_RATE}\n"
                f"target_files = [{q(range(3))}]\ndeplete_files = [{q([3])}]\n\n"
                f'[Basecaller]\ncaller = "DeepNano"\nnetwork = "synth48"\n\n'
                f'[TPU]\nbatch_size = {LIVE_BATCH}\nreplay_file = "{fasta}"\n{tpu}'
            )
            return cfg

        cfg = config("cli", "target")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.run(
            [sys.executable, "-m", "readbouncer_tpu_torch", "--config", str(cfg)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        check(proc.returncode == 0, f"CLI target exited {proc.returncode}: {proc.stderr[-2000:]}")
        config_in = ConfigReader(config("inproc", "target")).parse()
        source = make_replay_source(config_in)
        live = live_config(config_in)
        sampler = AdaptiveSampler(
            source, make_basecaller(config_in, source, dev),
            LiveClassifier(*[[IBFData.load(p) for p in ps] for ps in (config_in.ibf.target_files,
                                                                       config_in.ibf.deplete_files)],
                           live, device=dev),
            output_dir=config_in.output_dir, cfg=live,
        )
        stats = sampler.run()

        def untimed(text):
            return [ln for ln in text.splitlines() if "time" not in ln and "latency" not in ln]

        def outputs(d):
            rows = (d / "read_until_decision_stats.csv").read_text().splitlines()
            return ([r.rsplit(";", 1)[0] for r in rows], (d / "TargetReads.fasta").read_text(),
                    (d / "DepletedReads.fasta").read_text())

        cli_report = proc.stdout[proc.stdout.index("-" * 99):proc.stdout.index("Real time")]
        check(untimed(cli_report) == untimed(stats.report() + "\n"),
              f"CLI target counters differ from the in-process run:\n{cli_report}\n{stats.report()}")
        check(outputs(td / "cli") == outputs(td / "inproc"), "CLI target outputs differ from the in-process run")
        check(stats.unblocked + stats.stop_received == CLI_LIVE_READS and stats.unclassified == 0,
              f"CLI target: {stats.unblocked} + {stats.stop_received} of {CLI_LIVE_READS}")
        # [TPU] mesh_shape on the one card: bins:1 decides as the run
        # without a mesh; bins:2 needs two cards and must fail
        mesh_proc = run_cli(config("mesh", "target", 'mesh_shape = "bins:1"\n'), "target (mesh bins:1)")
        check(outputs(td / "mesh") == outputs(td / "cli"), "CLI target over mesh bins:1 differs from the run without")
        check(untimed(mesh_proc.stdout[mesh_proc.stdout.index("-" * 99):mesh_proc.stdout.index("Real time")])
              == untimed(cli_report), "CLI target over mesh bins:1: counters differ")
        proc2 = subprocess.run(
            [sys.executable, "-m", "readbouncer_tpu_torch", "--config",
             str(config("mesh2", "target", 'mesh_shape = "bins:2"\n'))],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        check(proc2.returncode != 0 and "needs 2 devices, have 1" in proc2.stderr,
              f"CLI target over mesh bins:2 on one card: exit {proc2.returncode}, {proc2.stderr[-500:]}")
        proc = subprocess.run(
            [sys.executable, "-m", "readbouncer_tpu_torch", "--config", str(config("conn", "test"))],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        check(proc.returncode == 0 and "successful" in proc.stdout
              and f"{CLI_LIVE_READS} chunks in first window" in proc.stdout,
              f"CLI test exited {proc.returncode}: {proc.stdout[-1000:]} {proc.stderr[-1000:]}")
    say(
        f"cli live: python -m readbouncer_tpu_torch target (DeepNano, synth48) on {CLI_LIVE_READS} reads: "
        f"unblocked {stats.unblocked}, stop_receiving {stats.stop_received}; FASTAs, decision CSV and "
        f"counters equal to the in-process run, and over mesh bins:1; mesh bins:2 exits "
        f"{proc2.returncode} (needs 2 devices, have 1); usage test reports {CLI_LIVE_READS} chunks"
    )


K5_KERNELS = ("parity_kernel", "compact_kernel", "xor_gather_kernel")  # what xor_gather launches


def gather_cases(dev) -> dict:
    """K5 at the probe's defaults against its plain version on blocks and
    rows, timed, with the kernels one call launches (the profiler's device
    time per launch, and kernels per call)."""
    out = {}
    for exp in ("cuda_block", "cuda_row"):
        tab, idx = dma_gather_probe.experiment_inputs(exp, GATHER_M, dma_gather_probe.ROWS, dev)
        got = gather.xor_gather(tab, idx, GATHER_CH, GATHER_NBUF)
        want = gather.xor_gather_plain(tab, idx)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        check(torch.equal(got, want), f"K5 {exp} differs from its plain version in {err} words")
        S = tab.shape[1] * tab.shape[2]
        hits = torch.bincount(idx.long(), minlength=tab.shape[0])
        distinct, odd = int((hits > 0).sum()), int((hits & 1).sum())
        # XOR cancels pairs: the least work reads each slice hit an odd
        # number of times once and XORs it in, reads the indices once and
        # writes the output once
        nbytes = odd * S * 4 + idx.numel() * 4 + S * 4
        ops = odd * S
        bound_ms, bound_by = _bound(nbytes, ops)
        out[exp] = d = dict(
            shape=f"tab int32 {list(tab.shape)}, idx int32 [{idx.numel()}], CH={GATHER_CH}, "
                  f"NBUF={GATHER_NBUF} -> int32 {list(got.shape)}",
            max_abs_err=err, distinct=distinct, odd=odd,
            # the checked call above passed these indices
            ms=cuda_ms(lambda: gather.xor_gather(tab, idx, GATHER_CH, GATHER_NBUF, check=False), 20),
            plain_ms=cuda_ms(lambda: gather.xor_gather_plain(tab, idx), 2, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            kernels=kernels_ms(lambda: gather.xor_gather(tab, idx, GATHER_CH, GATHER_NBUF, check=False)),
        )
        # each call launches one gather kernel: K5's launches over the
        # gather's, rounded, as the trace may miss a launch or two
        launched = [(name, n) for name, (_, n) in d["kernels"].items() if any(k in name for k in K5_KERNELS)]
        gathers = sum(n for name, n in launched if "xor_gather_kernel" in name)
        check(gathers > 0, f"K5 {exp}: no xor_gather_kernel in the profile")
        d["kernels_per_call"] = round(sum(n for _, n in launched) / gathers)
        say(
            f"gather: K5 {exp} {d['shape']}: kernel {d['ms']:.4f} ms, plain {d['plain_ms']:.3f} ms, bound "
            f"{bound_ms * 1e3:.1f} us ({bound_by}: {odd} of {distinct} distinct slices hit an odd number "
            f"of times, {nbytes / 1e6:.1f} MB, "
            f"{ops / 1e6:.0f} M int ops); bit-equal"
        )
        for name, (ms, n) in d["kernels"].items():
            say(f"  K5 {exp} under the profiler: {n} launches, {ms:.4f} ms each: {name[:100]}")
        say(f"  K5 {exp}: {d['kernels_per_call']:g} kernels per call")
        del tab, idx, got, want
    return out


def phase_gather(dev) -> dict:
    """K5 at the probe's defaults (gather_cases), PyTorch's index_select
    baselines, then the probe tool itself."""
    out = gather_cases(dev)
    tab, idx = dma_gather_probe.experiment_inputs("torch_block", GATHER_M, dma_gather_probe.ROWS, dev)
    out["torch_block_ms"] = cuda_ms(lambda: tab.index_select(0, idx), 20)
    block_shape = list(tab.shape)
    tab, idx = dma_gather_probe.experiment_inputs("torch_g3", GATHER_M, dma_gather_probe.ROWS, dev)
    out["torch_g3_ms"] = cuda_ms(
        lambda: tab.index_select(0, idx[0]) & tab.index_select(0, idx[1]) & tab.index_select(0, idx[2]), 20
    )
    say(f"gather: baselines torch_block (index_select of {GATHER_M} from {block_shape}) "
        f"{out['torch_block_ms']:.4f} ms, torch_g3 (3 index_select + AND from {list(tab.shape)}) "
        f"{out['torch_g3_ms']:.4f} ms")
    del tab, idx
    _reset_counters()
    for argv in [[exp] for exp in dma_gather_probe.EXPERIMENTS] + [["--check"]]:
        rc = dma_gather_probe.main(argv)
        check(rc == 0, f"dma_gather_probe {' '.join(argv)} returned {rc}")
    out["launches"] = _counters()["K5"]
    check(out["launches"] > 0, "the gather probe launched no K5")
    say(f"gather: the probe tool's four experiments and --check returned 0; K5 launches {out['launches']}")
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh(shape: str, dev):
    """A mesh of ``shape`` over ``dev`` named once per cell."""
    return make_mesh(shape, [dev] * math.prod(parse_mesh_shape(shape).values()))


def phase_a_batches(seqs: list[str], dev) -> tuple[list, list]:
    """Chunk 0 of every read (classify's phase A) in batches of BATCH on
    ``dev``: the engine's threshold tables (base, retry) and per batch
    (reads, lengths, base thresholds, retry thresholds)."""
    cl = COUNTS_CHUNK
    tabs = [torch.from_numpy(threshold_table(cl, 13, rate, 0.95).astype(np.int32)).to(dev)
            for rate in (ERROR_RATE, ERROR_RATE - 0.02)]
    batches = []
    for s0 in range(0, len(seqs), BATCH):
        enc, lens = encode_batch([q[:cl] for q in seqs[s0 : s0 + BATCH]], cl)
        r, l = host_tensor(enc).to(dev), torch.from_numpy(lens.astype(np.int64)).to(dev)
        batches.append((r, l, tabs[0].index_select(0, l), tabs[1].index_select(0, l)))
    return tabs, batches


def unsharded_maxima(engine: ClassifyEngine, seqs: list[str]) -> tuple[list, list, float]:
    """Phase A's batches and their per-filter maxima (mb, mr) on the
    merged stack, and the ms per batch."""
    tabs, batches = phase_a_batches(seqs, engine.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [stack_dual_max(engine._plan[0], r, l, *tabs) for r, l, _, _ in batches]
    torch.cuda.synchronize()
    return batches, want, (time.perf_counter() - t0) * 1e3 / len(batches)


def phase_sharded(engine: ClassifyEngine, seqs: list[str]) -> dict:
    """ShardedFilterStack over cuda:0 repeated (bins:2, data:2,bins:2) on
    chunk 0 of every read (classify's phase A) in batches of 1,024:
    maxima bit-equal to the unsharded stack_dual_max, K1 and K2 launched
    once per cell and batch."""
    stack, _ = engine._plan
    dev = engine.device
    batches, want, unsharded_ms = unsharded_maxima(engine, seqs)
    out = {"batches": len(batches), "unsharded_ms_per_batch": unsharded_ms}
    for shape in SHARD_MESHES:
        mesh = _mesh(shape, dev)
        sharded = ShardedFilterStack(stack, mesh)
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        got = [sharded.max_counts_dual(*b) for b in batches]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _counters()
        same = all(torch.equal(g[0], w[0]) and torch.equal(g[1], w[1]) for g, w in zip(got, want))
        check(same, f"sharded {shape}: maxima differ from the unsharded stack")
        cells = mesh.size * len(batches)
        check(launches["K1"] == cells and launches["K2"] == cells,
              f"sharded {shape}: launches {launches}, expected {cells} of K1 and K2")
        out[shape] = dict(ms_per_batch=dt * 1e3 / len(batches), launches=launches,
                          blocks=[[w0, w1, len(segs)] for w0, w1, segs, _ in sharded.shards])
        say(f"sharded {shape}: {len(batches)} batches of {BATCH} phase-A chunks bit-equal to the unsharded "
            f"stack; {out[shape]['ms_per_batch']:.2f} ms per batch (unsharded "
            f"{out['unsharded_ms_per_batch']:.2f}); word blocks {out[shape]['blocks']}; K1 {launches['K1']}, "
            f"K2 {launches['K2']} launches")
    return out


def phase_multiprocess(filter_dir: Path, seqs: list[str], classified, best, filters) -> dict:
    """The CLI's classify in two processes under [TPU] coordinator, both on
    the card, over every read: rank 0 reports 20,493 / 40,960, the .h0 /
    .h1 FASTAs are disjoint and together the single-process run's."""
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        reads = td / "reads.fasta"
        reads.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
        out_dir = td / "out"
        q = lambda ps: ", ".join(f'"{filter_dir / f"{bench_name(i)}.ribf"}"' for i in ps)
        port = _free_port()
        procs = []
        for rank in range(MP_PROCESSES):
            cfg = td / f"h{rank}.toml"
            cfg.write_text(
                f'usage = "classify"\noutput_directory = "{out_dir}"\nlog_directory = "{td / f"log{rank}"}"\n\n'
                f"[IBF]\nkmer_size = 13\nexp_seq_error_rate = {ERROR_RATE}\nchunk_length = 250\nmax_chunks = 5\n"
                f'target_files = [{q(range(3))}]\ndeplete_files = [{q([3])}]\nread_files = ["{reads}"]\n\n'
                f'[TPU]\nbatch_size = {BATCH}\ncoordinator = "127.0.0.1:{port}"\n'
                f"num_processes = {MP_PROCESSES}\nprocess_id = {rank}\n"
            )
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "readbouncer_tpu_torch", "--config", str(cfg)], cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            ))
        t0 = time.monotonic()
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.monotonic() - t0
        for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"multi-process classify rank {rank} exited {p.returncode}: {err[-2000:]}")
        report = outs[0][0]
        found = re.search(r"Number of classified reads\s*:\s*(\d+)", report)
        total = re.search(r"Number of all reads\s*:\s*(\d+)", report)
        check(found is not None and total is not None, f"no aggregate report from rank 0: {report[-2000:]}")
        check((int(found.group(1)), int(total.group(1))) == (EXPECT_CLASSIFIED, N_READS),
              f"rank 0 reports {found.group(1)} / {total.group(1)}, expected {EXPECT_CLASSIFIED} / {N_READS}")
        check("Final Results" not in outs[1][0], "rank 1 printed a report")

        def ids(path):
            return {ln[1:] for ln in path.read_text().splitlines() if ln.startswith(">")}

        for t, f in enumerate(filters[:3]):
            h = [ids(out_dir / f"{f.name}.h{r}.fasta") for r in range(MP_PROCESSES)]
            want = {f"r{i}" for i in np.nonzero(classified & (best == t))[0]}
            check(not (h[0] & h[1]), f"{f.name}: .h0 and .h1 overlap")
            check(h[0] | h[1] == want, f"{f.name}: .h0 | .h1 differs from the single-process run")
            check(all(int(r[1:]) % MP_PROCESSES == k for k in range(MP_PROCESSES) for r in h[k]),
                  f"{f.name}: a read in another process's file")
        for r in range(MP_PROCESSES):
            check((out_dir / f"unclassified.h{r}.fasta").read_text() == "", "unclassified output not empty")
    d = dict(processes=MP_PROCESSES, classified=int(found.group(1)), reads=int(total.group(1)), wall_s=wall)
    say(f"multi-process: CLI classify in {MP_PROCESSES} processes (gloo, one card) classified "
        f"{d['classified']}/{d['reads']} in {wall:.2f} s wall; .h0/.h1 FASTAs disjoint, their union the "
        f"single-process run's")
    return d


def timed_collective(seconds: list):
    """``sharded``'s max all-reduce wrapped to append its seconds (after a
    synchronise, so the card's work of the call is not counted in)."""
    inner = sharded_module.allreduce_max

    def timed(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(t)
        seconds.append(time.perf_counter() - t0)
        return out

    return timed


def mesh_worker(rank: int, port: int, work: Path) -> int:
    """One rank of phase 17 (``--mesh-rank``): joins the gloo group, loads
    the bench filters phase 3 saved, draws bench's reads and bench_live's
    workload from the seeds, runs mesh_rank and prints its RESULT line."""
    dev = torch.device("cuda", 0)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.TIMEOUT = MESH_GROUP_TIMEOUT
    t0 = time.monotonic()
    distributed.init_distributed(f"127.0.0.1:{port}", MP_PROCESSES, rank)
    filters, genomes = bench_filters(dev, cache=work / "cache")
    seqs = bench_reads(genomes, N_READS, READ_LEN)
    workload = live_workload(genomes, LIVE_READS, LIVE_READ_LEN)
    want = np.load(work / "want.npz")
    setup_s = time.monotonic() - t0
    out = mesh_rank(dev, filters, seqs, workload, want["mb"], want["mr"])
    out.update(rank=rank, setup_s=setup_s, seconds=time.monotonic() - t0)
    print("RESULT " + json.dumps(out), flush=True)
    distributed.shutdown_distributed()
    return 0


def mesh_rank(dev, filters, seqs: list[str], workload, want_b: np.ndarray, want_r: np.ndarray) -> dict:
    """This rank's part of phase 17, in a group of MP_PROCESSES: the merged
    stack's phase-A maxima over each of CROSS_MESHES (a warm-up call, then
    every batch, timed, its collectives timed apart) held to ``want_b`` /
    ``want_r`` [batches, BATCH, F], K1 and K2 once per owned cell and
    batch; then the synth48 live loop over the first mesh (phase_live's
    checks)."""
    stack, _ = plan_stacks(FilterStack(filters[:3], "cpu"), FilterStack(filters[3:], "cpu"))
    _, batches = phase_a_batches(seqs, dev)
    out = {"all_bits": stack.bits.numel() * 4}
    for shape in CROSS_MESHES:
        per_rank = math.prod(parse_mesh_shape(shape).values()) // MP_PROCESSES
        sharded = ShardedFilterStack(stack, make_mesh(shape, distributed.global_devices([dev] * per_rank)))
        sharded.max_counts_dual(*batches[0])
        collective: list[float] = []
        sharded_module.allreduce_max = timed_collective(collective)
        try:
            torch.cuda.synchronize()
            torch.distributed.barrier()
            _reset_counters()
            t1 = time.perf_counter()
            got = [sharded.max_counts_dual(*b) for b in batches]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
        finally:
            sharded_module.allreduce_max = distributed.allreduce_max
        launches = _counters()
        same = all(np.array_equal(mb.cpu().numpy(), want_b[k]) and np.array_equal(mr.cpu().numpy(), want_r[k])
                   for k, (mb, mr) in enumerate(got))
        n = len(batches)
        out[shape] = dict(
            same=same, cells=[list(c) for c in sharded.cells], bits_bytes=sharded.bits_bytes,
            ms_per_call=dt * 1e3 / n, collective_ms_per_call=sum(collective) * 1e3 / n,
            device_ms_per_call=(dt - sum(collective)) * 1e3 / n, collectives=len(collective), launches=launches,
        )
        check(same, f"mesh {shape}: maxima differ from the unsharded stack")
        expect = len(sharded.cells) * n
        check(launches["K1"] == expect and launches["K2"] == expect and len(collective) == n,
              f"mesh {shape}: launches {launches}, {len(collective)} collectives; expected {expect} of K1 "
              f"and K2 and {n} collectives")
    mesh = make_mesh(CROSS_MESHES[0], distributed.global_devices([dev]))
    live = phase_live(dev, filters, workload, "synth48", mesh=mesh)
    out["live"] = {k: live[k] for k in ("ticks", "unblocked", "stop_received", "unclassified", "actions_failed",
                                        "p50_ms", "p95_ms", "max_ms", "wall_s", "launches")}
    return out


def wait_all(procs: list, timeout: float) -> None:
    """Wait for every process; kill them all as soon as one exits non-zero
    or the time is up."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def phase_mesh(engine: ClassifyEngine, seqs: list[str], cache: Path, in_process_ms: float | None) -> dict:
    """Phase 17: two processes on the card in one gloo group, each naming
    cuda:0, each holding only its cells' word blocks (mesh_worker).  On
    CROSS_MESHES the maxima of phase A's batches are bit-equal to the
    unsharded stack's in both ranks, K1 and K2 launch once per owned cell
    and batch in each; the synth48 live loop over the cross-process
    bins:2 mesh unblocks 1,024 and stops 1,024 reads in each rank."""
    t0 = time.monotonic()
    _, want, unsharded_ms = unsharded_maxima(engine, seqs)
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        (work / "cache").symlink_to(cache)
        np.savez(work / "want.npz", mb=torch.stack([w[0] for w in want]).cpu().numpy(),
                 mr=torch.stack([w[1] for w in want]).cpu().numpy())
        port = _free_port()
        logs = [(open(work / f"rank{r}.out", "w"), open(work / f"rank{r}.err", "w")) for r in range(MP_PROCESSES)]
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r), str(port),
                                   str(work)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                                  stdout=out, stderr=err)
                 for r, (out, err) in enumerate(logs)]
        wait_all(procs, MESH_PHASE_TIMEOUT_S)
        for out, err in logs:
            out.close()
            err.close()
        texts = [((work / f"rank{r}.out").read_text(), (work / f"rank{r}.err").read_text())
                 for r in range(MP_PROCESSES)]
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        check(not failed, "; ".join(f"mesh rank {r} exited {procs[r].returncode}: {texts[r][0][-800:]}\n"
                                    f"{texts[r][1][-2500:]}" for r in failed))
        results = []
        for r, (text, _) in enumerate(texts):
            lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            check(len(lines) == 1, f"mesh rank {r} printed {len(lines)} RESULT lines: {text[-1500:]}")
            results.append(json.loads(lines[0][len("RESULT "):]))
    out = {"seconds": time.monotonic() - t0, "unsharded_ms_per_batch": unsharded_ms,
           "in_process_bins2_ms_per_batch": in_process_ms, "ranks": results}
    for res in results:
        r = res["rank"]
        for shape in CROSS_MESHES:
            d = res[shape]
            check(d["same"] and d["launches"]["K1"] > 0 and d["launches"]["K2"] > 0,
                  f"mesh rank {r}, {shape}: {d}")
            say(f"mesh across processes {shape}, rank {r}: cells {d['cells']}, resident bits "
                f"{d['bits_bytes'] / 1e6:.1f} of {res['all_bits'] / 1e6:.1f} MB; {len(want)} batches bit-equal to "
                f"the unsharded stack; {d['ms_per_call']:.2f} ms per max_counts_dual call = device "
                f"{d['device_ms_per_call']:.2f} + collective {d['collective_ms_per_call']:.2f} "
                f"({d['collectives']} all-reduces); K1 {d['launches']['K1']}, K2 {d['launches']['K2']}")
        live = res["live"]
        check(live["unblocked"] == LIVE_READS // 2 and live["stop_received"] == LIVE_READS // 2,
              f"mesh rank {r}: live {live}")
        say(f"mesh across processes live (synth48, {CROSS_MESHES[0]}), rank {r}: unblocked {live['unblocked']}, "
            f"stop_receiving {live['stop_received']}, {live['ticks']} ticks in {live['wall_s']:.2f} s, p50 "
            f"{live['p50_ms']:.2f} ms, p95 {live['p95_ms']:.2f} ms; launches {live['launches']}; rank's phase "
            f"{res['seconds']:.2f} s (set-up {res['setup_s']:.2f} s)")
    ref = f"in-process bins:2 {in_process_ms:.2f}, " if in_process_ms is not None else ""
    say(f"mesh across processes: per batch {ref}unsharded {unsharded_ms:.2f} ms; phase {out['seconds']:.2f} s")
    return out


def phase_remote(dev, filter_dir: Path, workload) -> dict:
    """The CLI's target with caller = "remote" on bench_live's reads (their
    recorded signals), against serve_basecalls in a thread of this process
    running the synth48 GRU on the card (K3): every depletion read
    unblocked, every other read stopped."""
    caller = GRUBasecaller(network="synth48", max_frames=LIVE_FRAMES, device=dev)
    caller.basecall([np.zeros(1600, np.float32)])  # warm the library and the B=1 bucket
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    served = []

    def serve():
        with srv:
            served.append(serve_basecalls(srv, caller.basecall))

    reads = workload[:REMOTE_READS]
    if REMOTE_READS < LIVE_READS:
        say(f"  remote: cut to the first {REMOTE_READS} reads over {REMOTE_CHANNELS} channels")
    origin = {rid: g for rid, _, _, g in reads}
    thread = threading.Thread(target=serve, daemon=True)
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        # ReplaySource.save_signals's layout, uncompressed: 295 MB of noisy
        # float32 signal is slow to deflate and compresses little
        npz = td / "signals.npz"
        t0 = time.monotonic()
        np.savez(npz, **{rid: sig for rid, sig, _, _ in reads},
                 **{f"__seq__/{rid}": np.frombuffer(seq.encode("ascii"), np.uint8) for rid, _, seq, _ in reads})
        say(f"  remote: {len(reads)} reads' signals recorded in {time.monotonic() - t0:.2f} s")
        q = lambda ps: ", ".join(f'"{filter_dir / f"{bench_name(i)}.ribf"}"' for i in ps)
        cfg = td / "remote.toml"
        cfg.write_text(
            f'usage = "target"\noutput_directory = "{td / "out"}"\nlog_directory = "{td / "log"}"\n\n'
            f"[IBF]\nkmer_size = 13\nexp_seq_error_rate = {ERROR_RATE}\n"
            f"target_files = [{q(range(3))}]\ndeplete_files = [{q([3])}]\n\n"
            f"[MinKNOW]\nchannels = [1, {REMOTE_CHANNELS}]\n\n"
            f'[Basecaller]\ncaller = "remote"\nhost = "127.0.0.1"\nport = "{srv.getsockname()[1]}"\n\n'
            f'[TPU]\nbatch_size = {LIVE_BATCH}\nreplay_signals = "{npz}"\n'
        )
        thread.start()
        _reset_counters()
        t0 = time.monotonic()
        proc = run_cli(cfg, "target (remote caller)")
        wall = time.monotonic() - t0
        thread.join(60)
        launches = _counters()
        rows = (td / "out" / "read_until_decision_stats.csv").read_text().splitlines()[1:]
    decided = {r.split(";")[0]: r.split(";")[4] for r in rows}
    wrong = [rid for rid, g in origin.items() if decided.get(rid) != ("unblock" if g == 3 else "stop_receiving")]
    unblocked = int(re.search(r"Reads unblocked\s*:\s*(\d+)", proc.stdout).group(1))
    stopped = int(re.search(r"Reads stop_receiving\s*:\s*(\d+)", proc.stdout).group(1))
    d = dict(reads=len(reads), channels=REMOTE_CHANNELS, unblocked=unblocked, stop_receiving=stopped,
             served=served[0] if served else None, wall_s=wall, launches=launches)
    say(f"remote: CLI target (caller remote) on {len(reads)} reads over {REMOTE_CHANNELS} channels in "
        f"{wall:.2f} s: unblocked {unblocked}, stop_receiving {stopped}; the server basecalled {d['served']} "
        f"chunks one per request through the card's GRU, K3 launched {launches['K3']} times")
    check(not thread.is_alive(), "remote: the basecall server did not finish")
    check(not wrong, f"remote: {len(wrong)} reads decided against their origin: {wrong[:5]}")
    check(unblocked == stopped == len(reads) // 2, f"remote: unblocked {unblocked}, stop_receiving {stopped}")
    check(launches["K3"] > 0, f"remote: kernel counters {launches}")
    return d


def _flat(params) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in param_leaves(params)])


def phase_train(dev) -> dict:
    """The CTC trainer at train_basecaller's shape (rnn48: H=48, 4 layers,
    window 66; batch 64 of 160 bases): step 1 on the card against the CPU,
    20 steps of the tool's optimizer lowering the loss with no K3 launch,
    the data:2 step over cuda:0 twice against the single step, and the
    tracked synth48 net's read identity through the basecaller."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1234)
    batches = [train_basecaller.make_batch(rng, TRAIN_BATCH, TRAIN_BASES)[:4] for _ in range(TRAIN_STEPS)]
    init = host_params(init_gru_params(torch.Generator().manual_seed(0)))

    def adam(leaves):
        return torch.optim.Adam(leaves, lr=TRAIN_LR)

    # step 1's loss is the loss of the initial params: the CPU needs the
    # forward only
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_loss = float(ctc_loss(param_tree(init, "cpu"), *batches[0]))
    cpu_s = time.perf_counter() - t0
    params = param_tree(init, dev)
    step = make_train_step(adam, max_grad_norm=1.0)
    opt = step.init(params)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(TRAIN_STEPS, alpha=0.05))
    k3 = gru_ops.gru_layer.launches
    losses, step_ms = [], []
    for i, b in enumerate(batches):
        # the last step runs under the profiler, for its launches and
        # device busy time
        last = i == len(batches) - 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if last else nullcontext() as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, b)
            sched.step()
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
    k3_moved = gru_ops.gru_layer.launches - k3
    first = {"cpu": cpu_loss, str(dev): losses[0]}
    rel = abs(first[str(dev)] - first["cpu"]) / abs(first["cpu"])
    prof_wall_ms = step_ms[-1]
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    ctc_kernels = sorted({m.group(0) for r in rows if (m := re.search(r"ctc_\w+", r[2]))})
    # data:2 over cuda:0 twice against the single step, both SGD (Adam's
    # first step is about lr * sign(g): it would amplify a rounding of a
    # gradient near 0 into a difference of 2 * lr)
    sgd = {}
    for name, make in (("single", make_train_step),
                       ("data:2", lambda f: make_sharded_train_step(_mesh("data:2", dev), f))):
        p = param_tree(init, dev)
        s = make(lambda leaves: torch.optim.SGD(leaves, lr=0.1))
        p, _, loss = s(p, s.init(p), batches[0])
        sgd[name] = (float(loss), _flat(p))
    sh_rel = abs(sgd["data:2"][0] - sgd["single"][0]) / abs(sgd["single"][0])
    sh_err = float((sgd["data:2"][1] - sgd["single"][1]).abs().max())
    # tests/test_basecaller_e2e.py's draw, through the port's basecaller
    caller = GRUBasecaller(network="synth48", device=dev)
    erng = np.random.default_rng(777)
    seqs = ["".join("ACGT"[i] for i in erng.integers(0, 4, int(erng.integers(150, 400)))) for _ in range(12)]
    signals = [sequence_to_signal(s, rng=erng) for s in seqs]
    ident = batch_identity(seqs, caller.basecall(signals))
    d = dict(step1_loss_card=first[str(dev)], step1_loss_cpu=first["cpu"], step1_rel_err=rel,
             losses=losses, ms_per_step=float(np.median(step_ms[1:-1])), k3_launches_in_training=k3_moved,
             cpu_forward_s=cpu_s, profiled_step_wall_ms=prof_wall_ms, profiled_step_device_busy_ms=busy_ms,
             profiled_step_launches=sum(r[1] for r in rows), ctc_kernels=ctc_kernels, sharded_loss_rel_err=sh_rel, sharded_param_max_err=sh_err,
             synth48_identity=ident)
    say(f"train: rnn48 (H=48, 4 layers), batch {TRAIN_BATCH} x {TRAIN_BASES} bases: step-1 loss card "
        f"{first[str(dev)]:.6f} / CPU {first['cpu']:.6f} (rel {rel:.2e}); {TRAIN_STEPS} steps loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, {d['ms_per_step']:.1f} ms per step on {card(dev)} (one step "
        f"under the profiler: {d['profiled_step_launches']} kernel launches, device busy {busy_ms:.1f} of "
        f"{prof_wall_ms:.1f} ms); CPU forward {cpu_s:.1f} s; K3 "
        f"launches in training {k3_moved}; CTC kernels {ctc_kernels}; data:2 step vs single: loss rel "
        f"{sh_rel:.2e}, params {sh_err:.2e}; synth48 identity {ident:.4f}")
    check(rel <= 1e-4, f"train: step-1 loss on the card {first[str(dev)]} vs CPU {first['cpu']}")
    check(losses[-1] < losses[0], f"train: loss did not fall over {TRAIN_STEPS} steps: {losses}")
    check(k3_moved == 0, f"train: K3 launched {k3_moved} times in training")
    check(sh_rel <= 1e-5 and sh_err <= 1e-5, f"train: data:2 step vs single: loss {sh_rel}, params {sh_err}")
    check(ident >= 0.95, f"train: synth48 identity {ident:.4f} < 0.95")
    return d



def phase_tools(dev, filters, seqs: list[str], classified, best, attempts) -> dict:
    """tools.profile_classify, tools.bench_toy and tools.bench_build (bench
    and bench_live ran as the main and live phases) on the filters and
    reads this run already holds; each tool's kernel launches counted
    from 0 over its call, and its JSON line printed."""
    targets, depletes = filters[:3], filters[3:]
    out, launches = {}, {}

    def tool(key, fn):
        _reset_counters()
        t0 = time.monotonic()
        res = fn()
        launches[key] = _counters()
        say(f"tools: {key} {time.monotonic() - t0:.2f} s, launches {launches[key]}")
        print(json.dumps(res["line"]), flush=True)
        out[key] = res
        return res

    p = tool("tool_profile_classify",
             lambda: profile_classify.run_profile_classify(targets, depletes, seqs[:PROFILE_READS], dev))
    main_decisions = (classified, best, attempts)
    check(all(np.array_equal(p[k], m[:PROFILE_READS]) for k, m in zip(("classified", "best", "attempts"), main_decisions)),
          f"tools.profile_classify: decisions on the first {PROFILE_READS} reads differ from tools.bench's")

    toy_genomes, toy_seqs = bench_toy.toy_workload()
    toy = bench_toy.toy_filters(toy_genomes, dev)
    t = tool("tool_bench_toy", lambda: bench_toy.run_bench_toy(toy[:3], toy[3:], toy_seqs, dev))
    # the same reads decided on the CPU, by the kernels' plain versions
    cpu = ClassifyEngine(toy[:3], toy[3:], error_rate=ERROR_RATE, batch_size=BATCH, device="cpu")
    want = cpu.classify_sequences(toy_seqs[:TOY_CPU_READS])
    got = [t[k][:TOY_CPU_READS] for k in ("classified", "best", "attempts")]
    differ = int(np.logical_or.reduce([g != w for g, w in zip(got, want)]).sum())
    check(differ == 0, f"tools.bench_toy: {differ} of {TOY_CPU_READS} reads decided otherwise than on the CPU")
    say(f"tools: bench_toy classified {int(got[0].sum())}/{TOY_CPU_READS} of its first reads on the card, "
        f"read by read as the CPU run ({int(want[0].sum())}); all {int(t['classified'].sum())}/{len(toy_seqs)}")

    genome = bench_build.build_genome()
    bb = tool("tool_bench_build", lambda: bench_build.run_bench_build(genome, dev))
    t0 = time.monotonic()
    before = NATIVE_CALLS["insert_fragments"]
    ref = bench_build.run_bench_build(genome, "cpu", runs=1)["bits_sha"][0]
    out["cpu_build_s"] = time.monotonic() - t0
    check(NATIVE_CALLS["insert_fragments"] > before, "tools.bench_build: the CPU build did not take the native insert")
    check(bb["bits_sha"] == [ref] * len(bb["bits_sha"]),
          f"tools.bench_build: the card's runs' bits {bb['bits_sha']} differ from the CPU build's {ref}")
    say(f"tools: bench_build's {len(bb['bits_sha'])} builds on the card equal the CPU build of the same genome "
        f"({out['cpu_build_s']:.2f} s on the CPU: native insert, {IBFParams().threads} threads)")
    needed = {"tool_profile_classify": ("K1", "K2"), "tool_bench_toy": ("K1", "K2")}
    for key, ks in needed.items():
        check(all(launches[key][k] > 0 for k in ks), f"tools: {key} launched {launches[key]}")
    out["launches"] = launches
    return out


def phase_probes(dev) -> dict:
    """The four probe tools and the graft-entry contract on the card: each
    tool's JSON line printed; the launches of proto_counts_layout, of the
    contract's forward and of its dryrun counted from 0 over their calls."""
    t_phase = time.monotonic()
    out, launches = {}, {}
    P = proto_counts_layout

    _reset_counters()
    t0 = time.monotonic()
    proto = P.run_proto_counts_layout(dev, P.R, P.L, P.W, P.ROWS, reps=PROTO_REPS)
    launches["tool_proto_counts_layout"] = _counters()
    print(json.dumps(proto["line"]), flush=True)
    check(set(proto["matches"]) == set(P.VARIANTS[1:]) and all(proto["matches"].values()),
          f"proto_counts_layout: a layout differs from {P.VARIANTS[0]}: {proto['matches']}")
    k1_runs = launches["tool_proto_counts_layout"]["K1"]
    check(k1_runs == PROTO_REPS + 1, f"proto_counts_layout: K1 launched {k1_runs} times, not {PROTO_REPS + 1}")
    # K1's least bytes at this shape (anded words in, planes out), as in
    # phase_kernels, and the whole counts function's (reads, lengths and
    # the filter's bits in, counts out)
    n = P.L - P.K + 1
    R2, planes = 2 * P.R, max(n.bit_length(), 1)
    k1_bound, k1_by = _bound(R2 * n * P.W * 4 + R2 * planes * P.W * 4, R2 * n * P.W * 2)
    counts_bound, _ = _bound(P.R * P.L + P.R * 4 + P.ROWS * P.W * 4 + R2 * P.W * 32 * 4, 0)
    out["proto_counts_layout"] = {
        "ms": {name: d["ms"] for name, d in proto["variants"].items()},
        "first_s": {name: d["first_s"] for name, d in proto["variants"].items()},
        "k1_bound_ms": k1_bound, "k1_bound_by": k1_by, "counts_bound_ms": counts_bound,
        "seconds": time.monotonic() - t0,
    }
    say(f"probes: proto_counts_layout all {len(P.VARIANTS)} layouts equal, K1 launched {k1_runs}; K1's bound at "
        f"[{R2}, {n}, {P.W}] {k1_bound:.4f} ms ({k1_by}), the counts function's {counts_bound:.4f} ms (bytes); "
        f"{out['proto_counts_layout']['seconds']:.2f} s")

    t0 = time.monotonic()
    inv = dedup_probe.run_dedup_probe("invgather", dev)
    print(json.dumps(inv["line"]), flush=True)
    cnt = dedup_probe.run_dedup_probe("counts", dev, dup=0.5)
    print(json.dumps(cnt["line"]), flush=True)
    check(cnt["line"]["sums_equal"], "dedup_probe: the dedup sums differ from the baseline's")
    out["dedup_probe"] = {"invgather": inv["line"], "counts": cnt["line"], "seconds": time.monotonic() - t0}

    t0 = time.monotonic()
    exps = {}
    for exp in gather_probe.EXPERIMENTS:
        res = gather_probe.run_gather_probe(exp, dev)
        if exp == "gprod_nobar":  # gprod's program, run once untimed
            check(res["line"]["same_as"] == "gprod", f"gather_probe {exp}: {res['line']}")
        else:
            check(math.isfinite(res["ms"]) and res["ms"] > 0, f"gather_probe {exp}: {res['ms']} ms")
        exps[exp] = {k: res[k] for k in ("ms", "rate", "unit")}
    torch.cuda.empty_cache()
    out["gather_probe"] = {"experiments": exps, "seconds": time.monotonic() - t0}
    print(json.dumps({"metric": "gather_probe_ms", "experiments": exps, "device": card(dev)}), flush=True)
    check(set(exps) == set(gather_probe.EXPERIMENTS), "gather_probe: an experiment did not run")

    t0 = time.monotonic()
    tr = transfer_probe.run_transfer_probe(dev, transfer_probe.H2D_SIZES, transfer_probe.D2H_SIZES)
    print(json.dumps(tr["line"]), flush=True)
    out["transfer_probe"] = {**tr["line"], "seconds": time.monotonic() - t0}

    t0 = time.monotonic()
    _reset_counters()
    fn, (frames,) = graft_entry.entry()
    zeros_out = fn(frames)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 128, 66), dtype=np.float32)).to(dev)
    got = fn(x)
    launches["graft_entry"] = _counters()
    with torch.no_grad():
        plain = gru_logits(fn.args[0], x, kernel=False)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(tuple(zeros_out.shape) == tuple(got.shape) == (8, 128, 5) and bool(torch.isfinite(got).all()),
          f"graft_entry: logits of shape {tuple(got.shape)}")
    check(launches["graft_entry"]["K3"] == 8, f"graft_entry: K3 launched {launches['graft_entry']['K3']}, not 2 x 4 layers")
    check(err <= K3_LOGITS_GATE, f"graft_entry: logits {err:.3g} from the plain forward > {K3_LOGITS_GATE}")
    out["graft_entry"] = {"logits_max_abs_err": err, "seconds": time.monotonic() - t0}

    t0 = time.monotonic()
    # the dryrun seeds its net on the card; the CPU's reference run takes
    # the same values (a CPU generator draws others)
    cpu_params = param_tree(host_params(init_gru_params(torch.Generator(device=dev).manual_seed(0))), "cpu")
    _reset_counters()
    d = graft_entry.dryrun_steps(GRAFT_DRYRUN_DEVICES)
    launches["graft_dryrun"] = _counters()
    ref = graft_entry.dryrun_steps(GRAFT_DRYRUN_DEVICES, "cpu", params=cpu_params)
    rel = abs(d["loss"] - ref["loss"]) / abs(ref["loss"])
    check(launches["graft_dryrun"]["K1"] > 0 and launches["graft_dryrun"]["K2"] > 0,
          f"graft dryrun: launches {launches['graft_dryrun']}")
    check(math.isfinite(d["loss"]), f"graft dryrun: loss {d['loss']}")
    check(torch.equal(d["mb"].cpu(), ref["mb"]) and torch.equal(d["mr"].cpu(), ref["mr"])
          and np.array_equal(d["decisions"], ref["decisions"]),
          "graft dryrun: the card's maxima or decisions differ from the CPU's")
    check(rel <= 1e-4, f"graft dryrun: loss {d['loss']} on the card vs {ref['loss']} on the CPU")
    out["graft_dryrun"] = {"mesh": d["mesh"], "loss": d["loss"], "cpu_loss": ref["loss"], "loss_rel": rel,
                           "seconds": time.monotonic() - t0}
    say(f"probes: graft_entry logits {err:.2e} from the plain forward, launches {launches['graft_entry']}; "
        f"dryrun on {d['mesh']} loss {d['loss']:.6f} (CPU {ref['loss']:.6f}), launches {launches['graft_dryrun']}")
    out["seconds"] = time.monotonic() - t_phase
    out["launches"] = launches
    say(f"probes phase: {out['seconds']:.2f} s")
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if len(argv) == 4 and argv[0] == "--mesh-rank":
        return mesh_worker(int(argv[1]), int(argv[2]), Path(argv[3]))
    if argv not in ([], ["--k2-only"], ["--k4-k5-only"], ["--probes-only"], ["--mesh-only"]):
        print("usage: python3 chip_smoke.py [--k2-only | --k4-k5-only | --probes-only | --mesh-only]",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as cache:
        return run(argv, Path(cache))


def run(argv: list[str], cache: Path) -> int:
    """The phases; ``cache`` holds the bench filters phase 3 saves."""
    dev = torch.device("cuda")
    torch.set_float32_matmul_precision("highest")  # the reference's precision="highest"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.monotonic()

    t0 = time.monotonic()
    card_text = card(dev)
    check("power limit not read" not in card_text, f"nvidia-smi did not read the card: {card_text}")
    say(f"card: {card_text}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"({time.monotonic() - t0:.2f} s)")

    t0 = time.monotonic()
    phase_build()
    say(f"build phase: {time.monotonic() - t0:.2f} s")

    if argv == ["--probes-only"]:
        probes = phase_probes(dev)
        print(json.dumps({k: v for k, v in probes.items() if k != "launches"}), flush=True)
        print(card_text, flush=True)
        return 0

    t0 = time.monotonic()
    filters, genomes = phase_state(dev, cache)
    engine = ClassifyEngine(filters[:3], filters[3:], error_rate=ERROR_RATE, batch_size=BATCH, device=dev)
    stack, n_t = engine._plan
    check(stack is not None and stack.words == 72 and n_t == 3, "merged stack of 3+1 filters, W=72")
    say(f"state phase: merged stack rows={stack.rows} W={stack.words} "
        f"({stack.bits.numel() * 4 / 1e6:.0f} MB on the card): {time.monotonic() - t0:.2f} s")

    t0 = time.monotonic()
    seqs = bench_reads(genomes, N_READS, READ_LEN)
    say(f"reads: bench.py's {len(seqs)} reads of {READ_LEN} bp: {time.monotonic() - t0:.2f} s")

    t0 = time.monotonic()
    workload = live_workload(genomes, LIVE_READS, LIVE_READ_LEN)
    live_seqs = [seq for _, _, seq, _ in workload]
    say(f"live reads: bench_live's {len(workload)} reads of {LIVE_READ_LEN} bp: {time.monotonic() - t0:.2f} s")

    if argv == []:
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory() as work:
            host = phase_host(genomes, seqs, engine.chunk_length * engine.max_chunks, Path(work))
        host["seconds"] = time.monotonic() - t0
        say(f"host phase: {host['seconds']:.2f} s")

    if argv == ["--mesh-only"]:
        mesh = phase_mesh(engine, seqs, cache, None)
        say("mesh across processes: " + json.dumps(mesh))
        print(card_text, flush=True)
        return 0

    if argv == ["--k4-k5-only"]:
        t0 = time.monotonic()
        k4 = phase_counts(engine, seqs)
        a_t = torch.zeros((72, 256, 2 * COUNTS_READS), dtype=torch.int32, device=dev)
        k4["kernels"] = kernels_ms(lambda: ibf_count.accumulate_counts(a_t))
        k4["sass"] = sass_loops(load_library("ibf_count").path, "accumulate_counts")
        for name, d in k4["sass"].items():
            say(f"  K4 SASS {name}: {d['registers']} registers, {d['total_instructions']} instructions; "
                f"window loop {d['loop']}")
        del a_t
        say(f"counts phase: {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        k5 = gather_cases(dev)
        say(f"gather phase: {time.monotonic() - t0:.2f} s")
        keys = ("shape", "ms", "bound_ms", "max_abs_err", "kernels")
        print(json.dumps({
            "k4": {k: k4[k] for k in keys + ("zeros_ms", "sass")},
            "k5": {exp: {k: k5[exp][k] for k in keys + ("odd", "distinct", "kernels_per_call")}
                   for exp in ("cuda_block", "cuda_row")},
        }), flush=True)
        print(card_text, flush=True)
        return 0

    t0 = time.monotonic()
    kern = phase_kernels(engine, seqs, live_seqs)
    say(f"kernels phase: {time.monotonic() - t0:.2f} s")
    if argv == ["--k2-only"]:
        keys = ("shape", "ms", "launch_ms", "call_ms", "max_abs_err")
        print(json.dumps({"k2": {lab: {k: kern[("K2", lab)][k] for k in keys} for lab in "ABL"}}), flush=True)
        print(card_text, flush=True)
        return 0

    t0 = time.monotonic()
    k4 = phase_counts(engine, seqs)
    say(f"counts phase: {time.monotonic() - t0:.2f} s")

    t0 = time.monotonic()
    classified, best, attempts, launches, main_line = phase_main(dev, engine, filters, seqs)
    say(f"main phase: {time.monotonic() - t0:.2f} s")

    t0 = time.monotonic()
    phase_profile(engine, seqs)
    say(f"profile phase: {time.monotonic() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as filter_dir:
        t0 = time.monotonic()
        filter_dir = Path(filter_dir)
        paths = save_filters(filters, filter_dir)
        phase_cli(paths, filters, seqs, classified, best)
        (filter_dir / "genomes").mkdir()
        genome_paths = write_genomes(genomes, filter_dir / "genomes")
        phase_cli(genome_paths, filters, seqs, classified, best, inputs="genome FASTAs")
        say(f"cli phase: {time.monotonic() - t0:.2f} s")

        t0 = time.monotonic()
        built = phase_cli_build(dev, genome_paths, filters, filter_dir)
        say(f"cli build/update phase: {time.monotonic() - t0:.2f} s")

        t0 = time.monotonic()
        profile_launches = phase_tool_profile(filter_dir)
        say(f"tool profile phase: {time.monotonic() - t0:.2f} s")

        t0 = time.monotonic()
        gru = phase_gru(dev, workload)
        say(f"gru phase: {time.monotonic() - t0:.2f} s")

        live = {}
        for caller in ("synth48", "oracle"):
            t0 = time.monotonic()
            live[caller] = phase_live(dev, filters, workload, caller)
            say(f"live phase ({caller}): {time.monotonic() - t0:.2f} s")

        t0 = time.monotonic()
        phase_cli_live(filter_dir, dev, workload)
        say(f"cli live phase: {time.monotonic() - t0:.2f} s")

        t0 = time.monotonic()
        sharded = phase_sharded(engine, seqs)
        live["sharded"] = phase_live(dev, filters, workload, "synth48", mesh=_mesh(LIVE_MESH, dev))
        sharded["seconds"] = time.monotonic() - t0
        say(f"sharded phase: {sharded['seconds']:.2f} s")
        say("sharded: " + json.dumps({**{k: v for k, v in sharded.items() if k not in SHARD_MESHES},
                                      **{m: {k: v for k, v in sharded[m].items() if k != "launches"}
                                         for m in SHARD_MESHES},
                                      "live": {k: v for k, v in live["sharded"].items() if k != "launches"}}))

        t0 = time.monotonic()
        multi = phase_multiprocess(filter_dir, seqs, classified, best, filters)
        multi["seconds"] = time.monotonic() - t0
        say(f"multi-process phase: {multi['seconds']:.2f} s")
        say("multi-process: " + json.dumps(multi))

        t0 = time.monotonic()
        remote = phase_remote(dev, filter_dir, workload)
        remote["seconds"] = time.monotonic() - t0
        say(f"remote phase: {remote['seconds']:.2f} s")
        say("remote: " + json.dumps({k: v for k, v in remote.items() if k != "launches"}))

    t0 = time.monotonic()
    train = phase_train(dev)
    train["seconds"] = time.monotonic() - t0
    say(f"train phase: {train['seconds']:.2f} s")
    say("train: " + json.dumps(train))

    t0 = time.monotonic()
    k5 = phase_gather(dev)
    say(f"gather phase: {time.monotonic() - t0:.2f} s")

    t0 = time.monotonic()
    tools = phase_tools(dev, filters, seqs, classified, best, attempts)
    say(f"tools phase: {time.monotonic() - t0:.2f} s")

    probes = phase_probes(dev)
    say("probes: " + json.dumps({k: v for k, v in probes.items() if k != "launches"}))

    mesh = phase_mesh(engine, seqs, cache, sharded["bins:2"]["ms_per_batch"])
    say(f"mesh across processes phase: {mesh['seconds']:.2f} s")
    say("mesh across processes: " + json.dumps(mesh))

    paths_launched = {"classify": launches, "live_synth48": live["synth48"]["launches"],
                      "live_oracle": live["oracle"]["launches"],
                      **{f"sharded_{m}": sharded[m]["launches"] for m in SHARD_MESHES},
                      f"live_synth48_sharded_{LIVE_MESH}": live["sharded"]["launches"],
                      "remote_server": remote["launches"], **tools["launches"], **probes["launches"],
                      **{f"mesh_processes_{m}_rank{res['rank']}": res[m]["launches"]
                         for res in mesh["ranks"] for m in CROSS_MESHES},
                      **{f"live_synth48_mesh_processes_{CROSS_MESHES[0]}_rank{res['rank']}": res["live"]["launches"]
                         for res in mesh["ranks"]}}
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    rows = []
    for k, name, where in (
        ("K1", "accumulate_planes", "readbouncer_tpu/ops/ibf_count_pallas.py:109"),
        ("K2", "planes_dual_max", "readbouncer_tpu/ops/ibf_count_pallas.py:200"),
    ):
        d = kern[(k, "A")]
        rows.append({
            "name": name, "route": "cuda", "source": "readbouncer_tpu_torch/ops/csrc/ibf_count.cu",
            "replaces": where, "launches": launches[k],
            "max_abs_err": max(kern[(k, lab)]["max_abs_err"] for lab in "ABL"),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None, "shape": d["shape"],
            "phase_b": {key: kern[(k, "B")][key] for key in keys},
            "live_short_bucket": {key: kern[(k, "L")][key] for key in keys},
            "launches_by_path": {path: n[k] for path, n in paths_launched.items()},
        })
        if k == "K2":  # ms from a CUDA graph; launch_ms profiled; call_ms host included
            for key in ("launch_ms", "call_ms"):
                rows[-1][key] = d[key]
                for sub, lab in (("phase_b", "B"), ("live_short_bucket", "L")):
                    rows[-1][sub][key] = kern[(k, lab)][key]
    d = gru["B256"]
    rows.append({
        "name": "gru_layer", "route": "cuda", "source": "readbouncer_tpu_torch/ops/csrc/gru.cu",
        "replaces": "readbouncer_tpu/ops/gru_pallas.py:38",
        "launches": live["synth48"]["launches"]["K3"],
        "max_abs_err": max(gru[c]["max_abs_err"] for c in ("B256", "B512", "H96")),
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": d["library_ms"], "shape": d["shape"],
        "library": "torch.nn.GRU(48, 48, batch_first=True) on cuDNN, input projection included",
        "b512": {key: gru["B512"][key] for key in keys + ("library_ms",)},
        "h96": {key: gru["H96"][key] for key in keys + ("library_ms",)},
        "launches_per_tick": gru["launches_per_tick"],
        "logits_max_abs_err": gru["logits_max_abs_err"], "tokens_differ": gru["tokens_differ"],
        "logits_f64_err": gru["logits_f64_err"],
        "launches_by_path": {**{path: n["K3"] for path, n in paths_launched.items()},
                             "train": train["k3_launches_in_training"]},
    })
    rows.append({
        "name": "accumulate_counts", "route": "cuda", "source": "readbouncer_tpu_torch/ops/csrc/ibf_count.cu",
        "replaces": "readbouncer_tpu/ops/ibf_count_pallas.py:62", "launches": profile_launches["K4"],
        "max_abs_err": k4["max_abs_err"], "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"], "library_ms": None, "shape": k4["shape"],
        "zeros_ms": k4["zeros_ms"], "launches_by_path": {"tool_profile_realistic": profile_launches["K4"]},
    })
    blk, row = k5["cuda_block"], k5["cuda_row"]
    rows.append({
        "name": "xor_gather", "route": "cuda", "source": "readbouncer_tpu_torch/ops/csrc/gather_probe.cu",
        "replaces": "scripts/dma_gather_probe.py:59", "launches": k5["launches"],
        "max_abs_err": max(blk["max_abs_err"], row["max_abs_err"]), "ms": blk["ms"], "plain_ms": blk["plain_ms"],
        "bound_ms": blk["bound_ms"], "bound_by": blk["bound_by"], "library_ms": None, "shape": blk["shape"],
        "cuda_row": {key: row[key] for key in keys + ("distinct", "odd", "kernels_per_call")}, "distinct": blk["distinct"],
        "odd": blk["odd"], "kernels_per_call": blk["kernels_per_call"],
        "baselines": {"torch_block_ms": k5["torch_block_ms"], "torch_g3_ms": k5["torch_g3_ms"]},
        "launches_by_path": {"tool_dma_gather_probe": k5["launches"]},
    })
    say(f"build: {json.dumps(built)}")
    live_line = {c: {k: v for k, v in d.items() if k != "launches"} for c, d in live.items() if c != "sharded"}
    say(f"live: {json.dumps(live_line)}")
    say("host: " + json.dumps({**host, "cpu_reference_build_s": tools["cpu_build_s"]}))
    say(f"total: {time.monotonic() - t_all:.1f} s; main path {main_line['value']} reads/s; live p50 "
        f"{live['synth48']['p50_ms']:.2f} ms per tick (synth48); one {PROFILE_READS}-read encode: native "
        f"{host['encode_ms']['native']:.2f} ms, numpy {host['encode_ms']['numpy']:.2f} ms; CPU reference build "
        f"{tools['cpu_build_s']:.2f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_text, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
