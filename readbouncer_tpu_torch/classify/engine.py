"""Offline classification engine (`classify` usage) — the torch
counterpart of readbouncer_tpu/classify/engine.py.

Same structure and the same decisions as the JAX engine:

* reads are encoded once on the host, by the native host library's
  ``encode_batch`` (``readbouncer_tpu_torch/native``);
* phase A scores chunk 0 of every read, one device pass per read batch;
* phase B scores only the reads phase A left pending, on exactly their
  remaining chunks, bucketed by how many chunks their length provides;
* a 3-stage pipeline (submit -> dispatch phase B -> collect) keeps the
  device busy across host batches;
* ``classify_sequences_waves`` keeps the JAX engine's chunk-wave route,
  one pass per chunk over the still-unclassified reads through
  ``FilterStack.counts`` / ``max_counts`` and the numpy policy: the
  semantics oracle the tests hold the two-phase path against;
* reads shorter than ``chunk_length`` are "too short"; a classified
  read's full sequence goes to its best target's FASTA, an unclassified
  one to ``unclassified.fasta`` (reference: src/main/classify.hpp:142-380).

Host-device traffic uses pinned host tensors and ``non_blocking``
copies of the encoded uint8 reads, unpacked.  ``packing``,
``transfer_mode`` and ``overlap_pool`` are accepted with the JAX engine's
values and ignored: there they shrink or overlap uploads over a slow
host link, and no choice of them changes a decision.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from readbouncer_tpu_torch.classify.fused import (
    FusedClassifier,
    pack_results,
    plan_stacks,
    unpack_results_np,
)
from readbouncer_tpu_torch.classify.math import ci_and_threshold_batch
from readbouncer_tpu_torch.classify.policy import classify_decisions
from readbouncer_tpu_torch.device import host_tensor, resolve_device, upload
from readbouncer_tpu_torch.errors import EmptyFilterError
from readbouncer_tpu_torch.fastio.fasta import FastaWriter, read_records
from readbouncer_tpu_torch.ibf.hashing import _BASE_LUT
from readbouncer_tpu_torch.ibf.query import FilterStack
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.native import CALLS, load_native

__all__ = [
    "ClassifyResults",
    "ClassifyEngine",
    "classify_read_files",
    "encode_batch",
    "encode_batch_np",
]


@dataclass
class ClassifyResults:
    """Counters matching the reference's final stats block
    (src/main/classify.hpp:349-365)."""

    found: int = 0
    failed: int = 0
    too_short: int = 0
    read_counter: int = 0
    per_target: dict[str, int] = field(default_factory=dict)
    avg_classify_seconds: float = 0.0

    def report(self, chunk_length: int) -> str:
        lines = [
            "------------------------------- Final Results -------------------------------",
            f"Number of classified reads                         :   {self.found}",
            f"Number of of too short reads (len < {chunk_length})           :   {self.too_short}",
            f"Number of all reads                                :   {self.read_counter}",
        ]
        for name, n in self.per_target.items():
            frac = (n / self.read_counter) if self.read_counter else 0.0
            lines.append(f"{name}\t : {n}\t\t{frac}")
        lines.append(
            f"Average Processing Time Read Classification        :   {self.avg_classify_seconds}"
        )
        lines.append(
            "-----------------------------------------------------------------------------------"
        )
        return "\n".join(lines)


def encode_batch(seqs: list[str], length: int, batch: int | None = None):
    """Encode + right-pad sequences to a fixed [R, length] u8 array.

    The native host library's ``encode_batch`` (``native/rbt_native.cpp``)
    packs every read in one pass; rows past ``len(seqs)`` up to ``batch``
    are zero, as in the JAX wrapper.  Returns (codes u8 [R, length],
    lengths i32 [R]) with lengths clipped to ``length``; without padding
    both arrays are read-only views of the library's buffers.
    """
    R = batch if batch is not None else len(seqs)
    buf, lens_buf = load_native().module.encode_batch(seqs, length)
    CALLS["encode_batch"] += 1
    enc = np.frombuffer(buf, dtype=np.uint8).reshape(len(seqs), length)
    enc_lens = np.frombuffer(lens_buf, dtype=np.int32)
    if R == len(seqs):
        return enc, enc_lens
    out = np.zeros((R, length), dtype=np.uint8)
    lens = np.zeros(R, dtype=np.int32)
    out[: len(seqs)] = enc
    lens[: len(seqs)] = enc_lens
    return out, lens


def encode_batch_np(seqs: list[str], length: int, batch: int | None = None):
    """``encode_batch``'s plain version, in numpy (for the tests and the
    smoke run's comparison): one ASCII buffer for all reads, one gather
    of every read's first ``length`` bases."""
    R = batch if batch is not None else len(seqs)
    out = np.zeros((R, length), dtype=np.uint8)
    lens = np.zeros(R, dtype=np.int32)
    n = len(seqs)
    if n == 0:
        return out, lens
    raw = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
    full = np.fromiter(map(len, seqs), dtype=np.int64, count=n)
    keep = np.minimum(full, length)
    lens[:n] = keep
    if raw.size == 0:
        return out, lens
    starts = np.cumsum(full) - full
    col = np.arange(length, dtype=np.int64)
    inside = col[None, :] < keep[:, None]
    idx = np.where(inside, starts[:, None] + col[None, :], 0)
    out[:n] = np.where(inside, _BASE_LUT[raw[idx]], 0)
    return out, lens


class _Transfer:
    """Host <-> device copies: pinned host memory, non_blocking on CUDA."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def put(self, arr: np.ndarray) -> torch.Tensor:
        return upload(arr, self.device)

    def get(self, tensors: list[torch.Tensor]) -> np.ndarray:
        """Concatenate device tensors and fetch them in one copy."""
        t = torch.cat(tensors) if len(tensors) > 1 else tensors[0]
        if not self.cuda:
            return t.numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        done.synchronize()
        return host.numpy()


class ClassifyEngine:
    """Batched chunk classifier over target/deplete filter stacks."""

    def __init__(
        self,
        target_filters: list[IBFData],
        deplete_filters: list[IBFData],
        error_rate: float,
        significance: float = 0.95,
        chunk_length: int = 250,
        max_chunks: int = 5,
        batch_size: int = 1024,
        overlap_pool: bool = False,
        batch_size_b: int | None = None,
        packing: str = "auto",
        device=None,
    ):
        if not target_filters and not deplete_filters:
            raise EmptyFilterError(
                "No depletion or target filters have been provided for classification!"
            )
        if not 0 < max_chunks < 255:
            # the packed result word gives attempts 8 bits (reference
            # default 5, src/config/configReader.cpp:238-243)
            raise ValueError(f"max_chunks must be in [1, 254], got {max_chunks}")
        # packing and overlap_pool are the JAX engine's upload options:
        # accepted, and ignored here (reads go up as unpacked uint8)
        if packing not in ("auto", "2bit", "base243"):
            raise ValueError(f"packing must be auto|2bit|base243, got {packing!r}")
        self.device = resolve_device(device)
        self.targets = FilterStack(target_filters, self.device) if target_filters else None
        self.depletes = FilterStack(deplete_filters, self.device) if deplete_filters else None
        self.target_names = [f.name for f in target_filters]
        self.error_rate = error_rate
        self.significance = significance
        self.chunk_length = chunk_length
        self.max_chunks = max_chunks
        self.batch_size = batch_size
        # phase-B reads carry up to (max_chunks-1) chunks each
        self.batch_size_b = batch_size_b or batch_size
        self.kmer_size = (self.targets or self.depletes).kmer_size
        self._plan = plan_stacks(self.targets, self.depletes)
        self._fused: dict[tuple[int, int], FusedClassifier] = {}
        self._io = _Transfer(self.device)

    def _classifier(self, n_chunks: int, attempt_offset: int) -> FusedClassifier:
        key = (n_chunks, attempt_offset)
        fn = self._fused.get(key)
        if fn is None:
            fn = FusedClassifier(
                self.targets, self.depletes, self.chunk_length, n_chunks,
                self.error_rate, self.significance, attempt_offset, self._plan,
            )
            self._fused[key] = fn
        return fn

    def classify_sequences(self, seqs: list[str]):
        """Classify a list of sequences (two-phase device path).

        Returns (classified[N] bool, best_target[N] int, attempts[N] int).
        Too-short filtering is the caller's concern.
        """
        return self.classify_submit(seqs).finish()

    def classify_submit(self, seqs: list[str]) -> "_ClassifyJob":
        """Encode + upload + launch phase A; returns a finishable job."""
        return _ClassifyJob(self, seqs)

    def classify_sequences_pipelined(
        self, seqs: list[str], host_batch_reads: int = 16384, depth: int = 2
    ):
        """classify_sequences over pipelined host batches: batch i+1 is
        encoded and launched, and batch i's phase B launched, before batch
        i-1's results are fetched.  Same results as classify_sequences."""
        n = len(seqs)
        classified = np.zeros(n, dtype=bool)
        best = np.full(n, -1, dtype=np.int64)
        attempts = np.zeros(n, dtype=np.int64)
        in_flight: deque = deque()  # (job, start)

        def drain_one():
            job, start = in_flight.popleft()
            c, b, a = job.finish()
            classified[start : start + job.n] = c
            best[start : start + job.n] = b
            attempts[start : start + job.n] = a

        for start in range(0, n, host_batch_reads):
            in_flight.append(
                (self.classify_submit(seqs[start : start + host_batch_reads]), start)
            )
            if len(in_flight) >= 2:
                in_flight[-2][0].dispatch_b()
            while len(in_flight) > max(1, depth):
                drain_one()
        while in_flight:
            drain_one()
        return classified, best, attempts

    def classify_fragments(self, frags: np.ndarray, lens: np.ndarray):
        """One wave: decisions for a batch of chunk fragments (u8 [R, L]
        codes, [R] lengths), each stack counted by ``FilterStack.counts``
        and reduced by ``max_counts`` at both error rates.

        Returns (classified[R] bool, best_target[R] int).
        """
        maxima = {}
        for kind, stack in (("t", self.targets), ("d", self.depletes)):
            if stack is None:
                maxima[kind] = (None, None)
                continue
            cnt = stack.counts(host_tensor(frags), host_tensor(lens))
            maxima[kind] = tuple(
                stack.max_counts(cnt, torch.from_numpy(
                    ci_and_threshold_batch(lens, stack.kmer_size, rate, self.significance).astype(np.int32)
                )).cpu().numpy()
                for rate in (self.error_rate, self.error_rate - 0.02)
            )
        (t_base, t_retry), (d_base, d_retry) = maxima["t"], maxima["d"]
        return classify_decisions(t_base, d_base, t_retry, d_retry)

    def classify_sequences_waves(self, seqs: list[str]):
        """Chunk-wave route: wave ``i`` classifies chunk ``i`` of every read
        still unclassified and long enough, in batches of ``batch_size``.

        The reference's control flow, kept as the semantics oracle of the
        two-phase path (same results).  Returns (classified[N] bool,
        best_target[N] int, attempts[N] int).
        """
        n = len(seqs)
        classified = np.zeros(n, dtype=bool)
        best = np.full(n, -1, dtype=np.int64)
        attempts = np.zeros(n, dtype=np.int64)
        seq_lens = np.array([len(s) for s in seqs], dtype=np.int64)
        cl = self.chunk_length
        for i in range(self.max_chunks):
            active = np.flatnonzero(~classified & (seq_lens > i * cl))
            if active.size == 0:
                break
            for start in range(0, active.size, self.batch_size):
                idx = active[start : start + self.batch_size]
                frags, lens = encode_batch([seqs[j][i * cl : (i + 1) * cl] for j in idx], cl,
                                           batch=self.batch_size)
                ok, b = self.classify_fragments(frags, lens)
                ok, b = ok[: idx.size], b[: idx.size]
                classified[idx] |= ok
                best[idx] = np.where(ok, b, best[idx])
                attempts[idx] += 1
        return classified, best, attempts


class _ClassifyJob:
    """One submitted host batch: phase A launched, phase B on finish()."""

    def __init__(self, engine: ClassifyEngine, seqs: list[str]):
        self.engine = engine
        self.n = n = len(seqs)
        self.futs_b = None  # set by dispatch_b
        cl, C = engine.chunk_length, engine.max_chunks
        B = engine.batch_size
        if n == 0:
            return
        enc, lens = encode_batch(seqs, cl * C)
        self.enc, self.lens = enc, lens
        io = engine._io
        n_pad = -(-n // B) * B

        # --- phase A: chunk 0 of every read ----------------------------
        fn_a = engine._classifier(1, 0)
        reads_a = np.zeros((n_pad, cl), dtype=np.uint8)
        reads_a[:n] = enc[:, :cl]
        lens_a = np.zeros(n_pad, dtype=np.int32)
        lens_a[:n] = lens
        dev_a, dev_lens = io.put(reads_a), io.put(lens_a)
        self.futs_a = []
        for s in range(0, n_pad, B):
            lb = dev_lens[s : s + B]
            c, b, a = fn_a(dev_a[s : s + B], lb)
            self.futs_a.append((pack_results(c, b, a), ~c & (lb > cl)))

    def dispatch_b(self):
        """Fetch the pending flags and launch phase B (idempotent)."""
        if self.n == 0 or self.futs_b is not None:
            return
        engine = self.engine
        cl, C = engine.chunk_length, engine.max_chunks
        B = engine.batch_size_b
        io = engine._io
        pend = io.get([p for _, p in self.futs_a])[: self.n]
        pidx = np.nonzero(pend)[0]
        futs_b = []
        if pidx.size:
            plens = self.lens[pidx]
            n_rest = np.minimum(-(-plens // cl), C) - 1  # chunks left, 1..C-1
            for c_rest in np.unique(n_rest):
                c_rest = int(c_rest)
                sel = np.nonzero(n_rest == c_rest)[0]
                u = sel.size
                u_pad = -(-u // B) * B
                L_b = cl * c_rest
                fn_b = engine._classifier(c_rest, 1)
                lb = np.zeros(u_pad, dtype=np.int32)
                lb[:u] = plens[sel] - cl
                reads_b = np.zeros((u_pad, L_b), dtype=np.uint8)
                reads_b[:u] = self.enc[pidx[sel], cl : cl + L_b]
                dev_b, dev_lb = io.put(reads_b), io.put(lb)
                futs = []
                for s in range(0, u_pad, B):
                    c, b, a = fn_b(dev_b[s : s + B], dev_lb[s : s + B])
                    futs.append(pack_results(c, b, a))
                futs_b.append((pidx[sel], u, futs))
        self.futs_b = futs_b

    def finish(self):
        """Collect both phases: (classified[N] bool, best_target[N] int,
        attempts[N] int)."""
        n = self.n
        classified = np.zeros(n, dtype=bool)
        best = np.full(n, -1, dtype=np.int64)
        attempts = np.zeros(n, dtype=np.int64)
        if n == 0:
            return classified, best, attempts
        self.dispatch_b()
        flat = [r for r, _ in self.futs_a] + [f for _, _, futs in self.futs_b for f in futs]
        res = self.engine._io.get(flat)
        n_a = len(self.futs_a) * self.engine.batch_size
        classified[:], best[:], attempts[:] = unpack_results_np(res[:n])
        pos = n_a
        for out_idx, u, futs in self.futs_b:
            ok, bb, att = unpack_results_np(res[pos : pos + u])
            pos += len(futs) * self.engine.batch_size_b
            classified[out_idx] = ok
            best[out_idx] = bb
            attempts[out_idx] = att
        return classified, best, attempts


def classify_read_files(
    read_files: list[str | Path],
    target_filters: list[IBFData],
    deplete_filters: list[IBFData],
    error_rate: float,
    output_dir: str | Path,
    significance: float = 0.95,
    chunk_length: int = 250,
    max_chunks: int = 5,
    batch_size: int = 1024,
    host_batch_reads: int = 16384,
    verbose: bool = True,
    shard: tuple[int, int] = (0, 1),
    output_suffix: str = "",
    transfer_mode: str = "serial",
    pipeline_depth: int = 2,
    packing: str = "auto",
    device=None,
) -> ClassifyResults:
    """Classify read files, writing per-target FASTAs and
    unclassified.fasta (reference: classify_reads,
    src/main/classify.hpp:142-380).  ``pipeline_depth`` host batches are
    in flight: batch i+1 is encoded and launched, and batch i-1's FASTAs
    written, while the device computes batch i.  ``transfer_mode``
    ("serial" | "overlap" | "auto") is accepted and ignored, as
    ``packing`` is by ClassifyEngine.

    ``shard=(i, n)``: only records whose index % n == i are read — the
    process's input shard in a multi-process run
    (parallel/distributed.py); the counters then cover this shard (sum
    them with aggregate_counters).  ``output_suffix`` keeps the
    processes' FASTAs apart: ``<name>{output_suffix}.fasta``."""
    from readbouncer_tpu_torch.utils.logging import get_logger

    engine = ClassifyEngine(
        target_filters, deplete_filters, error_rate, significance,
        chunk_length, max_chunks, batch_size, packing=packing, device=device,
    )
    if (transfer_mode or "serial").lower() not in ("serial", "overlap", "auto"):
        raise ValueError(f"transfer_mode must be serial|overlap|auto, got {transfer_mode!r}")
    log = get_logger("ClassifyLog")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    results = ClassifyResults()
    results.per_target = {name: 0 for name in engine.target_names}
    target_writers = [
        FastaWriter(output_dir / f"{name}{output_suffix}.fasta")
        for name in engine.target_names
    ]
    unclassified = FastaWriter(output_dir / f"unclassified{output_suffix}.fasta")
    t_start = time.monotonic()
    # a still-unclassified read FAILS once its chunk loop reaches a
    # fragment shorter than k (reference: src/IBF/IBFClassify.cpp:218-225,
    # 290-294 via src/main/classify.hpp:300-310): len < (C-1)*cl + k
    fail_below = (max_chunks - 1) * chunk_length + engine.kmer_size
    depth = max(1, pipeline_depth)
    in_flight: deque = deque()  # (job, ids, seqs)
    processed = [0]

    def write_outputs(job, ids, seqs):
        classified, best, _ = job.finish()
        for j in range(len(seqs)):
            if classified[j]:
                results.found += 1
                if best[j] >= 0:
                    results.per_target[engine.target_names[best[j]]] += 1
                    target_writers[best[j]].write(ids[j], seqs[j])
            elif len(seqs[j]) < fail_below:
                results.failed += 1
            else:
                unclassified.write(ids[j], seqs[j])
        processed[0] += len(seqs)
        dt = time.monotonic() - t_start
        log.info(
            "intermediate: %d reads processed, %d classified, "
            "avg classification time per read: %.6f s",
            processed[0], results.found, dt / max(1, processed[0]),
        )

    def submit(ids, seqs):
        if not seqs:
            return
        in_flight.append((engine.classify_submit(seqs), ids, seqs))
        if len(in_flight) >= 2:
            in_flight[-2][0].dispatch_b()
        while len(in_flight) >= depth + 1:
            write_outputs(*in_flight.popleft())

    try:
        for read_file in read_files:
            ids: list[str] = []
            seqs: list[str] = []
            shard_i, shard_n = shard
            for rec_idx, rec in enumerate(read_records(read_file)):
                if shard_n > 1 and rec_idx % shard_n != shard_i:
                    continue
                results.read_counter += 1
                if len(rec.seq) < chunk_length:
                    results.too_short += 1
                    continue
                ids.append(rec.id)
                seqs.append(rec.seq)
                if len(seqs) >= host_batch_reads:
                    submit(ids, seqs)
                    ids, seqs = [], []
            submit(ids, seqs)
        while in_flight:
            write_outputs(*in_flight.popleft())
    finally:
        for w in target_writers:
            w.close()
        unclassified.close()
    elapsed = time.monotonic() - t_start
    n_processed = results.read_counter - results.too_short
    results.avg_classify_seconds = elapsed / n_processed if n_processed else 0.0
    if verbose:
        print(results.report(chunk_length))
    return results
