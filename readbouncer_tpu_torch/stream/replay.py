"""Replayed-signal streaming harness — the MinKNOW stand-in.

A copy of readbouncer_tpu/stream/replay.py (the port imports nothing of the JAX
package).

Replaces the reference's gRPC bidirectional stream to a live sequencer
(readuntil::Data, src/minknow/Data.cpp:291-436) with a deterministic
replay source that honors the same protocol contract:

* signal chunks are emitted per channel every ``break_reads_after_seconds``
  (0.4 s; src/main/adaptive_sampling.hpp:633-634) — in replay "ticks",
  with optional wall-clock pacing for latency benchmarking,
* an ``unblock`` action ejects the read from its channel after the
  0.1 s voltage-flip (src/minknow/Data.cpp:171): remaining chunks are
  dropped and the channel starts its next read,
* a ``stop_receiving_data`` action keeps the read sequencing but stops
  streaming its chunks (MinKNOW semantics of stop_further_data),
* channels are 1..512 (src/minknow/Data.cpp:299-321).

Signal synthesis: reads are drawn from a FASTA (or generated), converted
to a squiggle with a simple pore model (per-base Gaussian current levels,
``samples_per_base`` dwell, noise) — enough to exercise the full
basecall->classify->action loop deterministically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from readbouncer_tpu_torch.fastio.fasta import read_records

__all__ = [
    "SignalChunk",
    "ReplayRead",
    "ReplaySource",
    "sequence_to_signal",
    "NearestLevelBasecaller",
    "CHUNK_CLASS_STRAND",
    "CHUNK_CLASS_ADAPTER",
    "DEFAULT_ACCEPTED_CLASSES",
]

# idealized pore current levels per base (pA), loosely r9.4.1-shaped
_BASE_LEVELS = {"A": 80.0, "C": 95.0, "G": 110.0, "T": 125.0, "N": 100.0}


def sequence_to_signal(
    seq: str,
    samples_per_base: int = 9,
    noise: float = 2.0,
    rng: np.random.Generator | None = None,
    dwell_jitter: int = 0,
    drift: float = 0.0,
) -> np.ndarray:
    """Squiggle synthesis: per-base level + Gaussian noise, optionally
    with nanopore-like timing/baseline imperfections.

    ``dwell_jitter=j``: each base dwells a uniform-random
    ``samples_per_base ± j`` samples (min 1) instead of exactly
    ``samples_per_base`` — real pores translocate at ~7-12 samples/base
    around the nominal rate.  ``drift``: slow baseline wander as a
    Gaussian random walk of the given per-sample sigma (pA) added on
    top — the low-frequency level drift med/MAD normalization must
    absorb.  Defaults keep the clean round-1..3 model (bit-identical
    output for the same rng stream).
    """
    rng = rng or np.random.default_rng(0)
    levels = np.array([_BASE_LEVELS.get(c, 100.0) for c in seq], dtype=np.float32)
    if dwell_jitter > 0:
        dwells = rng.integers(
            max(1, samples_per_base - dwell_jitter),
            samples_per_base + dwell_jitter + 1,
            size=levels.shape[0],
        )
        sig = np.repeat(levels, dwells)
    else:
        sig = np.repeat(levels, samples_per_base)
    sig = sig + rng.normal(0.0, noise, sig.shape[0]).astype(np.float32)
    if drift > 0.0:
        sig = sig + np.cumsum(
            rng.normal(0.0, drift, sig.shape[0])
        ).astype(np.float32)
    return sig.astype(np.float32)


class NearestLevelBasecaller:
    """Oracle basecaller for the synthetic pore model.

    Inverts :func:`sequence_to_signal` by nearest-level classification
    plus per-base majority vote — exact for the synthesis noise levels.
    Used to exercise the live pipeline deterministically (scheduler /
    state-machine / action tests) independent of GRU accuracy, and as
    the upper-bound reference when scoring the GRU basecaller.
    """

    def __init__(self, samples_per_base: int = 9):
        self.samples_per_base = samples_per_base
        self._bases = np.array(list("ACGT"))
        self._levels = np.array([_BASE_LEVELS[b] for b in "ACGT"], dtype=np.float32)

    def basecall(self, signals: list[np.ndarray]) -> list[str]:
        out = []
        for sig in signals:
            n = sig.shape[0] // self.samples_per_base
            if n == 0:
                out.append("")
                continue
            s = sig[: n * self.samples_per_base].reshape(n, self.samples_per_base)
            ids = np.abs(s[:, :, None] - self._levels).argmin(-1)  # [n, spb]
            maj = np.apply_along_axis(lambda r: np.bincount(r, minlength=4).argmax(), 1, ids)
            out.append("".join(self._bases[maj]))
        return out


# MinKNOW chunk classifications accepted by the reference's signal
# consumer (strand=83, adapter=65; src/minknow/Data.cpp:55-66,378-391)
CHUNK_CLASS_STRAND = 83
CHUNK_CLASS_ADAPTER = 65
DEFAULT_ACCEPTED_CLASSES = frozenset({CHUNK_CLASS_STRAND, CHUNK_CLASS_ADAPTER})


@dataclass
class SignalChunk:
    channel: int
    read_number: int
    read_id: str
    signal: np.ndarray  # float32 raw samples for this 0.4 s window
    chunk_index: int
    classification: int = CHUNK_CLASS_STRAND


@dataclass
class ReplayRead:
    read_id: str
    signal: np.ndarray
    true_seq: str = ""
    emitted: int = 0  # samples streamed so far
    number: int = 0
    unblocked: bool = False
    stopped: bool = False  # stop_receiving: sequencing continues silently


@dataclass
class ReplaySource:
    """Deterministic per-tick chunk generator with action feedback."""

    reads: list[ReplayRead]
    channels: int = 512
    sample_rate: int = 4000
    break_seconds: float = 0.4
    seed: int = 0
    # chunk-classification filter (reference: the consumer drops chunks
    # whose classifications are not strand/adapter,
    # src/minknow/Data.cpp:55-66,378-391).  ``chunk_classifier`` maps
    # (read, chunk_index) -> MinKNOW classification id; chunks whose id
    # is not in ``accepted_classes`` are suppressed (the read's signal
    # still advances, exactly like the reference skipping the channel).
    chunk_classifier: object = None  # callable | None
    accepted_classes: frozenset = DEFAULT_ACCEPTED_CLASSES

    def __post_init__(self):
        self.chunk_samples = int(self.sample_rate * self.break_seconds)
        self._queue = list(reversed(self.reads))  # pop() from the front
        self._active: dict[int, ReplayRead] = {}
        self._next_number = 0
        self._rng = np.random.default_rng(self.seed)
        self.stats = {
            "reads_started": 0,
            "reads_completed": 0,
            "unblocked": 0,
            "stop_received": 0,
            "samples_saved": 0,
            "chunks_filtered": 0,
        }

    @classmethod
    def from_signals(
        cls,
        path: str | Path,
        seed: int = 0,
        **kw,
    ) -> "ReplaySource":
        """Replay RECORDED raw signal from an ``.npz`` archive.

        The file-backed counterpart of the reference's MinKNOW playback
        run (a simulated device replaying a recorded bulk FAST5,
        reference README.md:266-323): each archive entry is one read —
        key = read id, value = a 1-D float array of raw current samples
        — streamed in archive order.  Channel assignment follows the
        same round-robin queue as every other constructor
        (``_fill_channels``).  Entries named ``__seq__/<read_id>`` are
        optional uint8 ASCII ground-truth sequences (as written by
        :func:`save_signals`), attached as ``true_seq`` for oracle
        callers and accuracy scoring — a reserved PREFIX, so no legal
        read id (which would have to start with ``__seq__/``) can be
        mistaken for a ground-truth entry.
        """
        with np.load(path) as npz:
            names = [n for n in npz.files if not n.startswith("__seq__/")]
            reads = [
                ReplayRead(
                    read_id=name,
                    signal=np.asarray(npz[name], dtype=np.float32).reshape(-1),
                    true_seq=(
                        bytes(
                            np.asarray(npz[f"__seq__/{name}"], dtype=np.uint8)
                        ).decode()
                        if f"__seq__/{name}" in npz.files
                        else ""
                    ),
                )
                for name in names
            ]
        return cls(reads=reads, seed=seed, **kw)

    def save_signals(self, path: str | Path) -> Path:
        """Write this source's queued reads to a ``from_signals`` ``.npz``
        (signals + ``__seq__/<id>`` ground truth when present) — the
        "record a run, replay it later" round trip."""
        path = Path(path)
        arrays: dict[str, np.ndarray] = {}
        for r in self.reads:
            if r.read_id.startswith("__seq__/"):
                raise ValueError(
                    f"read id {r.read_id!r} collides with the reserved "
                    "__seq__/ ground-truth namespace"
                )
            arrays[r.read_id] = np.asarray(r.signal, dtype=np.float32)
            if r.true_seq:
                arrays[f"__seq__/{r.read_id}"] = np.frombuffer(
                    r.true_seq.encode("ascii"), dtype=np.uint8
                )
        np.savez_compressed(path, **arrays)
        return path

    @classmethod
    def from_fasta(
        cls,
        paths: list[str | Path],
        samples_per_base: int = 9,
        noise: float = 2.0,
        seed: int = 0,
        dwell_jitter: int = 0,
        drift: float = 0.0,
        **kw,
    ) -> "ReplaySource":
        rng = np.random.default_rng(seed)
        reads = [
            ReplayRead(
                read_id=rec.id,
                signal=sequence_to_signal(
                    rec.seq, samples_per_base, noise, rng,
                    dwell_jitter=dwell_jitter, drift=drift,
                ),
                true_seq=rec.seq,
            )
            for p in paths
            for rec in read_records(p)
        ]
        return cls(reads=reads, seed=seed, **kw)

    @property
    def finished(self) -> bool:
        return not self._queue and not self._active

    def _fill_channels(self) -> None:
        for ch in range(1, self.channels + 1):
            if ch not in self._active and self._queue:
                read = self._queue.pop()
                read.number = self._next_number
                self._next_number += 1
                read.emitted = 0
                self._active[ch] = read
                self.stats["reads_started"] += 1

    def tick(self) -> list[SignalChunk]:
        """Advance one 0.4 s window; return the new chunks.

        Mirrors the live stream's per-channel chunk delivery
        (src/minknow/Data.cpp:338-424); chunks for stop_receiving reads
        are suppressed but the read still occupies the channel until its
        signal runs out (the pore keeps sequencing it).
        """
        self._fill_channels()
        chunks: list[SignalChunk] = []
        done: list[int] = []
        for ch, read in self._active.items():
            start = read.emitted
            end = min(start + self.chunk_samples, read.signal.shape[0])
            read.emitted = end
            if not read.stopped and end > start:
                ci = start // self.chunk_samples
                cls = (
                    int(self.chunk_classifier(read, ci))
                    if self.chunk_classifier is not None
                    else CHUNK_CLASS_STRAND
                )
                if cls in self.accepted_classes:
                    chunks.append(
                        SignalChunk(
                            channel=ch,
                            read_number=read.number,
                            read_id=read.read_id,
                            signal=read.signal[start:end],
                            chunk_index=ci,
                            classification=cls,
                        )
                    )
                else:
                    self.stats["chunks_filtered"] += 1
            if end >= read.signal.shape[0]:
                done.append(ch)
                self.stats["reads_completed"] += 1
        for ch in done:
            del self._active[ch]
        return chunks

    # -- action feedback (the consumer half of the bidi stream) ---------
    def unblock(self, channel: int, read_number: int) -> bool:
        """Eject a read (reference action: src/minknow/Data.cpp:74-103).

        Returns False when the read already left the pore — the analog of
        MinKNOW's failed_to_apply responses (src/minknow/Data.cpp:362-370).
        """
        read = self._active.get(channel)
        if read is None or read.number != read_number:
            return False
        self.stats["unblocked"] += 1
        self.stats["samples_saved"] += read.signal.shape[0] - read.emitted
        read.unblocked = True
        del self._active[channel]
        return True

    def stop_receiving(self, channel: int, read_number: int) -> bool:
        read = self._active.get(channel)
        if read is None or read.number != read_number:
            return False
        self.stats["stop_received"] += 1
        read.stopped = True
        return True
