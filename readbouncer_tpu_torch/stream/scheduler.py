"""Live adaptive-sampling engine — the torch counterpart of
readbouncer_tpu/stream/scheduler.py.

Rebuild of the reference's 7-task thread pipeline
(adaptive_sampling, src/main/adaptive_sampling.hpp:555-774) as a
tick-driven host scheduler feeding fixed-shape device batches:

reference thread            | here
----------------------------|------------------------------------------
T2 Data::getLiveSignals     | ReplaySource.tick() chunk batch
T3 basecall_live_reads      | one batched GRU forward per tick
T4xN classify_live_reads    | one batched IBF count + policy per tick
T5 Data::sendActions        | ActionSender.flush() (pacing + CSV)
T6 compute_average_durations| IntervalStats
T7/T8 writeReads            | FastaWriter per decision class
T1 watchdog                 | source.finished

Per-read state machines preserved exactly:

* basecall pending: chunks whose basecalled (concatenated) sequence is
  still under ``basecall_min_len`` (250 bp) are parked and prepended to
  the read's next chunk (src/basecaller/DeepNano/DeepNanoBasecaller.cpp:52-97),
* once_seen: an unclassified read is remembered; its next chunk is
  classified on the CONCATENATED sequence inside the same per-tick
  device batch (the reference concatenates before check_unblock,
  src/main/adaptive_sampling.hpp:283-311 — no extra device pass); past
  ``give_up_len`` (1500 bp) the read is assumed on-target and gets
  stop_receiving (src/main/adaptive_sampling.hpp:313-325).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

import torch

from readbouncer_tpu_torch.classify.engine import encode_batch, pack_codes
from readbouncer_tpu_torch.classify.fused import LiveFused, plan_stacks
from readbouncer_tpu_torch.classify.policy import (
    DECISION_STOP_RECEIVING,
    DECISION_UNBLOCK,
)
from readbouncer_tpu_torch.device import resolve_device, upload
from readbouncer_tpu_torch.fastio.fasta import FastaWriter
from readbouncer_tpu_torch.ibf.query import FilterStack
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.stream.actions import Action, ActionSender
from readbouncer_tpu_torch.stream.replay import ReplaySource, SignalChunk
from readbouncer_tpu_torch.utils.timing import Durations, OnlineMean, TimeMeasures

__all__ = [
    "LiveConfig",
    "LiveClassifier",
    "AdaptiveSampler",
    "LiveStats",
    "IntervalStats",
    "live_bucket_widths",
    "live_bucket_batches",
]


@dataclass
class LiveConfig:
    error_rate: float = 0.1
    significance: float = 0.95
    max_seq_len: int = 2048  # width of the longest live bucket
    batch_size: int = 512  # reads per short-bucket device batch
    # extra length bucket between the short (512) and long (max_seq_len)
    # ones: once_seen FIRST retries carry ~700-1100 bp concatenated
    # sequences, and padding them to max_seq_len doubles their window
    # count.  0 disables (two buckets).  An out-of-range value is
    # ignored without a word, as in the reference (live_bucket_widths).
    mid_len: int = 0
    basecall_min_len: int = 250  # DeepNanoBasecaller.cpp:52
    give_up_len: int = 1500  # adaptive_sampling.hpp:315
    interval_seconds: float = 60.0
    # cross-tick pipelining: dispatch basecall(t) at tick t but decide
    # its reads during tick t+1, overlapping the basecall transfers
    # with classify compute.  OFF by default on purpose: both stages
    # share one chip, so overlap hides only transfers while delaying
    # every decision by a full tick of wall time — usually the wrong
    # trade for adaptive sampling (BENCHMARKS.md live section).
    overlap_ticks: bool = False
    # record a per-tick composition dict in LiveStats.tick_profile
    # (chunk/item/long-bucket counts + stage times) — the p95-tail
    # attribution used by scripts/bench_live.py; negligible overhead
    profile_ticks: bool = False


def live_bucket_widths(cfg: "LiveConfig") -> list[int]:
    """Length-bucket widths: 512, optional mid, max.

    A ``mid_len`` outside (512, max_seq_len) is dropped silently, as the
    reference does (scheduler.py:100); the port keeps that for parity.
    """
    short = min(512, cfg.max_seq_len)
    widths = [short]
    mid = getattr(cfg, "mid_len", 0)
    if short < mid < cfg.max_seq_len:
        widths.append(mid)
    if cfg.max_seq_len > widths[-1]:
        widths.append(cfg.max_seq_len)
    return widths


def live_bucket_batches(cfg: "LiveConfig", widths: list[int]) -> dict[int, int]:
    """Per-width batch sizes: scale inversely with width so every
    bucket's batch covers ~the same window count per launch."""
    short = widths[0]
    return {w: max(32, cfg.batch_size * short // w) for w in widths}


class LiveClassifier:
    """Batched check_unblock (reference: src/main/adaptive_sampling.hpp:35-113).

    One ``LiveFused`` per length bucket: most ticks decide on single fresh
    chunks (~250-500 bp) in the short bucket; only once_seen retries carry
    concatenated sequences into the longer ones.  Reads go up base-243
    packed (the native ``pack_codes``, three bases a byte) and are
    unpacked on the device.  Each bucket's decisions stay on the device
    until the end of ``decide``, which fetches them all in one copy.
    """

    def __init__(
        self,
        target_filters: list[IBFData],
        deplete_filters: list[IBFData],
        cfg: LiveConfig,
        device=None,
    ):
        if not target_filters and not deplete_filters:
            raise ValueError("live classification needs at least one filter")
        self.device = resolve_device(device)
        self.targets = FilterStack(target_filters, self.device) if target_filters else None
        self.depletes = FilterStack(deplete_filters, self.device) if deplete_filters else None
        self.cfg = cfg
        plan = plan_stacks(self.targets, self.depletes)
        widths = live_bucket_widths(cfg)
        self.short_len = widths[0]
        self.bucket_lens = widths
        self._fused = {
            w: LiveFused(self.targets, self.depletes, w, cfg.error_rate, cfg.significance, packed=True, plan=plan)
            for w in widths
        }
        self._batch = live_bucket_batches(cfg, widths)

    def _dispatch(self, seqs, idx, width, batch, fn, parts):
        for start in range(0, len(idx), batch):
            part_idx = idx[start : start + batch]
            enc, lens = encode_batch([seqs[j][:width] for j in part_idx], width)
            packed, _ = pack_codes(enc, "base243")
            parts.append((part_idx, fn(upload(packed, self.device), upload(lens, self.device))))

    def decide(self, seqs: list[str]) -> np.ndarray:
        """Batched decisions: 0 continue / 1 unblock / 2 stop_receiving."""
        if not seqs:
            return np.zeros(0, dtype=np.int64)
        out = np.zeros(len(seqs), dtype=np.int64)
        lens = np.array([len(s) for s in seqs])
        parts: list = []
        lo = -1  # first bucket includes empty sequences
        for w in self.bucket_lens:
            hi = w if w != self.bucket_lens[-1] else np.inf
            idx = np.nonzero((lens > lo) & (lens <= hi))[0]
            lo = w
            self._dispatch(seqs, idx, w, self._batch[w], self._fused[w], parts)
        # ONE device-to-host copy per tick, whatever the number of buckets
        # and batches, as the reference's scheduler fetches them
        fetched = torch.cat([d for _, d in parts]).cpu().numpy()
        out[np.concatenate([i for i, _ in parts])] = fetched
        return out


class IntervalStats:
    """Rolling + per-interval duration statistics with periodic dumps.

    Mirror of the reference's stats task (compute_average_durations,
    src/main/adaptive_sampling.hpp:368-498): consumes one Durations
    record per completed read, maintains total and current-interval
    running means, and every ``interval_seconds`` emits the
    "Intermediate Results" block — total/interval classified and
    unclassified counts, active channels (per-channel read counters,
    reset each interval; reference channel_stats,
    adaptive_sampling.hpp:708-712 populated at
    DeepNanoBasecaller.cpp:48-49), average read length, interval average
    durations, and queue depths.
    """

    def __init__(self, interval_seconds: float = 60.0, logger=None):
        self.interval_seconds = interval_seconds
        self.logger = logger
        self.total_classified = 0
        self.total_unclassified = 0
        self.cur_classified = 0
        self.cur_unclassified = 0
        self.avg_complete_classified = OnlineMean()
        self.avg_complete_unclassified = OnlineMean()
        self.avg_basecall = OnlineMean()
        self.avg_classify = OnlineMean()
        self.cur_complete_classified = OnlineMean()
        self.cur_complete_unclassified = OnlineMean()
        self.cur_basecall = OnlineMean()
        self.cur_classify = OnlineMean()
        self.channel_stats: dict[int, int] = {}
        self.avg_read_len = OnlineMean()
        self._begin = time.monotonic()
        self.dumps = 0

    def record_chunk(self, channel: int) -> None:
        """One basecalled chunk on *channel* (DeepNanoBasecaller.cpp:48-49)."""
        self.channel_stats[channel] = self.channel_stats.get(channel, 0) + 1

    def push(self, dur: Durations) -> None:
        if dur.complete_classified > -1:
            self.cur_classified += 1
            self.avg_complete_classified.add(dur.complete_classified)
            self.cur_complete_classified.add(dur.complete_classified)
        else:
            self.cur_unclassified += 1
            self.avg_complete_unclassified.add(dur.complete_unclassified)
            self.cur_complete_unclassified.add(dur.complete_unclassified)
        self.avg_basecall.add(dur.basecalling)
        self.cur_basecall.add(dur.basecalling)
        self.avg_classify.add(dur.classification)
        self.cur_classify.add(dur.classification)

    def maybe_dump(self, queue_depths: dict[str, int] | None = None) -> bool:
        """Emit the interval block when the interval elapsed."""
        now = time.monotonic()
        if now - self._begin <= self.interval_seconds:
            return False
        active = sum(1 for v in self.channel_stats.values() if v > 0)
        self.total_classified += self.cur_classified
        self.total_unclassified += self.cur_unclassified
        lines = [
            "----------------------------- Intermediate Results -------------------------------------------------------",
            f"Total Number of classified reads                            :\t{self.total_classified}",
            f"Total Number of unclassified reads                          :\t{self.total_unclassified}",
            f"Number of active sequencing channels                        :\t{active}",
            f"Number of classified reads during last interval             :\t{self.cur_classified}",
            f"Number of unclassified reads during last interval           :\t{self.cur_unclassified}",
            f"Total Average Read Length                                   :\t{self.avg_read_len.mean:.1f}",
            f"Average Processing Time for classified Reads (interval)     :\t{self.cur_complete_classified.mean:.6f}",
            f"Average Processing Time for unclassified Reads (interval)   :\t{self.cur_complete_unclassified.mean:.6f}",
            f"Average Processing Time Read Basecalling (interval)         :\t{self.cur_basecall.mean:.6f}",
            f"Average Processing Time Read Classification (interval)      :\t{self.cur_classify.mean:.6f}",
        ]
        for name, depth in (queue_depths or {}).items():
            lines.append(f"Size of {name} Queue                            :\t{depth}")
        lines.append(
            "----------------------------------------------------------------------------------------------------------"
        )
        if self.logger is not None:
            for line in lines:
                self.logger.info(line)
        self.channel_stats = {}
        self.cur_classified = 0
        self.cur_unclassified = 0
        self.cur_complete_classified = OnlineMean()
        self.cur_complete_unclassified = OnlineMean()
        self.cur_basecall = OnlineMean()
        self.cur_classify = OnlineMean()
        self._begin = now
        self.dumps += 1
        return True

    def final_report(self) -> str:
        """The end-of-run averages block (adaptive_sampling.hpp:484-496)."""
        self.total_classified += self.cur_classified
        self.total_unclassified += self.cur_unclassified
        self.cur_classified = 0
        self.cur_unclassified = 0
        return "\n".join(
            [
                f"Number of classified reads\t\t\t\t:\t{self.total_classified}",
                f"Number of unclassified reads\t\t\t\t:\t{self.total_unclassified}",
                f"Average Processing Time for classified Reads\t\t:\t{self.avg_complete_classified.mean:.6f}",
                f"Average Processing Time for unclassified Reads\t:\t{self.avg_complete_unclassified.mean:.6f}",
                f"Average Processing Time Read Basecalling\t\t:\t{self.avg_basecall.mean:.6f}",
                f"Average Processing Time Read Classification\t\t:\t{self.avg_classify.mean:.6f}",
            ]
        )


@dataclass
class LiveStats:
    classified: int = 0
    unclassified: int = 0
    unblocked: int = 0
    stop_received: int = 0
    ticks: int = 0
    avg_read_len: OnlineMean = field(default_factory=OnlineMean)
    tick_latencies: list[float] = field(default_factory=list)
    basecall_seconds: float = 0.0
    classify_seconds: float = 0.0
    reads_processed: int = 0
    # end-of-run action delivery counts (reference: Data's final success/
    # failed unblock report from MinKNOW action responses,
    # src/minknow/Data.cpp:404-421)
    actions_succeeded: int = 0
    actions_failed: int = 0
    # per-tick composition records (LiveConfig.profile_ticks)
    tick_profile: list = field(default_factory=list)

    def p50_latency(self) -> float:
        return float(np.median(self.tick_latencies)) if self.tick_latencies else 0.0

    def report(self) -> str:
        return "\n".join(
            [
                "-" * 99,
                f"Number of classified reads\t\t\t\t:\t{self.classified}",
                f"Number of unclassified reads\t\t\t\t:\t{self.unclassified}",
                f"Reads unblocked\t\t\t\t\t\t:\t{self.unblocked}",
                f"Reads stop_receiving\t\t\t\t\t:\t{self.stop_received}",
                f"Number of successfully applied actions\t\t\t:\t{self.actions_succeeded}",
                f"Number of actions failed to apply\t\t\t:\t{self.actions_failed}",
                f"Average read length\t\t\t\t\t:\t{self.avg_read_len.mean:.1f}",
                f"p50 per-batch decision latency\t\t\t\t:\t{self.p50_latency()*1000:.2f} ms",
                f"Average basecall time / read\t\t\t\t:\t{self.basecall_seconds/max(1,self.reads_processed):.6f} s",
                f"Average classify time / read\t\t\t\t:\t{self.classify_seconds/max(1,self.reads_processed):.6f} s",
            ]
        )


class AdaptiveSampler:
    """Runs the live pipeline, one tick at a time."""

    def __init__(
        self,
        source: ReplaySource,
        basecaller,
        classifier: LiveClassifier,
        output_dir: str | Path = ".",
        cfg: LiveConfig | None = None,
        wall_clock: bool = False,
        logger=None,
    ):
        self.source = source
        self.basecaller = basecaller
        self.classifier = classifier
        self.cfg = cfg or classifier.cfg
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.sender = ActionSender(
            source, self.output_dir, wall_clock=wall_clock
        )
        self.stats = LiveStats()
        self.interval = IntervalStats(self.cfg.interval_seconds, logger=logger)
        # per-read stopwatches (the reference's RTPair TimeMeasures,
        # src/interfaces/ont_read.hpp:61): complete starts at first chunk
        # receipt, basecall/classify accumulate batch-attributed spans,
        # complete stops at action creation (Data.cpp:173-187)
        self.measures: dict[str, TimeMeasures] = {}
        self.pending_bc: dict[str, str] = {}
        self.once_seen: dict[str, tuple[str, int]] = {}
        # reads already decided whose stale chunks may still arrive: a
        # chunk captured before the read's unblock/stop action applies
        # (one tick later with overlap_ticks; several when ActionSender
        # pacing/batching defers the action) must be dropped, not parked
        # in pending_bc or re-classified — otherwise every decided read
        # is also counted unclassified at run end, or re-emitted with a
        # duplicate action/FASTA record.  read_id -> tick decided;
        # pruned once no stale chunk can still be in flight.
        self._decided: dict[str, int] = {}
        self._stop_requested = False
        self._bc_pending = None  # overlap_ticks: (chunks, basecall handle)
        self._tick_prof: dict = {}
        self.depleted_writer = FastaWriter(self.output_dir / "DepletedReads.fasta")
        self.target_writer = FastaWriter(self.output_dir / "TargetReads.fasta")

    # -- single-read decision application -------------------------------
    def _emit(self, chunk: SignalChunk, seq: str, unblock: bool) -> None:
        self.stats.avg_read_len.add(len(seq))
        self.interval.avg_read_len.add(len(seq))
        tm = self.measures.pop(chunk.read_id, None) or TimeMeasures()
        tm.complete.stop()
        dt = tm.complete.elapsed()  # per-read complete time (Data.cpp:174-187)
        self.interval.push(
            Durations(
                complete_classified=dt,
                basecalling=tm.basecall.elapsed(),
                classification=tm.classify.elapsed(),
            )
        )
        if unblock:
            self.stats.unblocked += 1
            self.depleted_writer.write(chunk.read_id, seq)
        else:
            self.stats.stop_received += 1
            self.target_writer.write(chunk.read_id, seq)
        self.stats.classified += 1
        self._decided[chunk.read_id] = self.stats.ticks
        self.sender.queue(
            Action(
                channel=chunk.channel,
                read_number=chunk.read_number,
                read_id=chunk.read_id,
                unblock=unblock,
                seq_length=len(seq),
                processing_seconds=dt,
            )
        )

    def _process_basecalled(self, chunks, seqs) -> None:
        """Classify + decide one tick's basecalled chunks.

        Assembles ONE classification batch per tick.  A read already
        in once_seen is checked on its CONCATENATED sequence — the
        reference's semantics (it concatenates before check_unblock,
        adaptive_sampling.hpp:283-311) — so the old "second pass"
        device round trip per tick is gone entirely.
        """
        items: list[tuple[SignalChunk, str, str, int]] = []
        for c, s in zip(chunks, seqs):
            if c.read_id in self._decided:
                # stale chunk of an already-decided read (captured before
                # its action applied); drop it and any parked fragment
                self.pending_bc.pop(c.read_id, None)
                continue
            s = self.pending_bc.pop(c.read_id, "") + s
            if len(s) < self.cfg.basecall_min_len:
                self.pending_bc[c.read_id] = s
                continue
            prev, iterstep = self.once_seen.pop(c.read_id, ("", 0))
            items.append((c, s, prev + s, iterstep))
        if not items:
            return
        t0 = time.monotonic()
        fulls = [full for _, _, full, _ in items]
        if self.cfg.profile_ticks:
            short_len = getattr(self.classifier, "short_len", 512)
            self._tick_prof.update(
                items=len(items),
                long_items=sum(1 for f in fulls if len(f) > short_len),
                retry_items=sum(1 for it in items if it[3] > 0),
            )
        decisions = self.classifier.decide(fulls)
        for (c, s, full, iterstep), d in zip(items, decisions):
            if d == DECISION_UNBLOCK:
                self._emit(c, full, True)
            elif d == DECISION_STOP_RECEIVING:
                self._emit(c, full, False)
            elif iterstep > 0 and len(full) > self.cfg.give_up_len:
                # assume on-target (adaptive_sampling.hpp:313-325)
                self._emit(c, full, False)
            else:
                self.once_seen[c.read_id] = (full, iterstep + 1)
        cl_dt = time.monotonic() - t0
        if self.cfg.profile_ticks:
            self._tick_prof["classify_ms"] = cl_dt * 1e3
        self.stats.classify_seconds += cl_dt
        for c, _, _, _ in items:  # batch-attributed classify span
            tm = self.measures.get(c.read_id)
            if tm is not None:
                tm.classify.add(cl_dt / len(items))
        self.stats.reads_processed += len(items)

    def _collect_pending_basecall(self) -> None:
        """Overlap mode: decide the PREVIOUS tick's reads now."""
        if self._bc_pending is None:
            return
        pchunks, handle = self._bc_pending
        self._bc_pending = None
        t0 = time.monotonic()
        seqs = self.basecaller.basecall_collect(handle)
        bc_dt = time.monotonic() - t0
        if self.cfg.profile_ticks:
            self._tick_prof["basecall_ms"] = bc_dt * 1e3
            self._tick_prof["chunks"] = len(pchunks)
        self.stats.basecall_seconds += bc_dt
        for c in pchunks:
            tm = self.measures.get(c.read_id)
            if tm is not None:
                tm.basecall.add(bc_dt / len(pchunks))
        self._process_basecalled(pchunks, seqs)

    def step(self) -> int:
        """One 0.4 s tick; returns number of chunks processed."""
        t_tick = time.monotonic()
        chunks = self.source.tick()
        self.stats.ticks += 1
        if self._decided:
            # drop stale chunks of already-decided reads at CAPTURE time:
            # they must not re-create measures entries (a leak — _emit
            # already popped them) nor count into channel stats.  The
            # guard inside _process_basecalled still covers overlap mode,
            # where a chunk is captured before the same step's decision.
            kept = []
            for c in chunks:
                if c.read_id in self._decided:
                    self.pending_bc.pop(c.read_id, None)
                else:
                    kept.append(c)
            chunks = kept
        if self.stats.ticks % 64 == 0 and self._decided:
            # bound the decided-read guard: an action applies within a
            # few paced flushes (adaptive batch grows with backlog), so
            # no stale chunk survives 64 ticks (~26 s at 0.4 s cadence).
            # Kept as the reference has it (scheduler.py:511), for parity:
            # a read whose action waits longer than that loses the guard
            horizon = self.stats.ticks - 64
            self._decided = {
                r: t for r, t in self._decided.items() if t > horizon
            }
        overlap = self.cfg.overlap_ticks and hasattr(
            self.basecaller, "basecall_submit"
        )
        if chunks:
            for c in chunks:
                tm = self.measures.get(c.read_id)
                if tm is None:
                    tm = TimeMeasures()
                    tm.complete.start()  # signal receipt (Data.cpp:376-377)
                    self.measures[c.read_id] = tm
                self.interval.record_chunk(c.channel)
        if overlap:
            # dispatch tick t's basecall, decide tick t-1's reads while
            # the device chews on it (cross-tick pipelining; opt-in —
            # see LiveConfig.overlap_ticks)
            if self.cfg.profile_ticks:
                # "captured" = THIS tick's capture; "chunks" (the batch
                # the latency/stage times describe) is set to the
                # PREVIOUS tick's batch in _collect_pending_basecall —
                # overlap mode decides t-1's chunks during tick t
                self._tick_prof = {"captured": len(chunks)}
            handle = (
                self.basecaller.basecall_submit([c.signal for c in chunks])
                if chunks
                else None
            )
            had_pending = self._bc_pending is not None
            self._collect_pending_basecall()
            if handle is not None:
                self._bc_pending = (chunks, handle)
            if chunks or had_pending:
                lat = time.monotonic() - t_tick
                self.stats.tick_latencies.append(lat)
                if self.cfg.profile_ticks:
                    self._tick_prof["latency_ms"] = lat * 1e3
                    self.stats.tick_profile.append(self._tick_prof)
                    self._tick_prof = {}
        elif chunks:
            if self.cfg.profile_ticks:
                self._tick_prof = {"chunks": len(chunks)}
            t0 = time.monotonic()
            seqs = self.basecaller.basecall([c.signal for c in chunks])
            bc_dt = time.monotonic() - t0
            if self.cfg.profile_ticks:
                self._tick_prof["basecall_ms"] = bc_dt * 1e3
            self.stats.basecall_seconds += bc_dt
            for c in chunks:  # batch-attributed per-read basecall span
                self.measures[c.read_id].basecall.add(bc_dt / len(chunks))
            self._process_basecalled(chunks, seqs)
            lat = time.monotonic() - t_tick
            self.stats.tick_latencies.append(lat)
            if self.cfg.profile_ticks:
                self._tick_prof["latency_ms"] = lat * 1e3
                self.stats.tick_profile.append(self._tick_prof)
                self._tick_prof = {}
        self.sender.flush()
        self.interval.maybe_dump(
            {
                "Action": len(self.sender._queue),
                "Pending-Basecall": len(self.pending_bc),
                "Once-Seen": len(self.once_seen),
            }
        )
        return len(chunks)

    def request_stop(self) -> None:
        """Ask the run loop to stop after the current tick (graceful:
        queued actions are drained and the final block is still produced
        — the reference's SIGINT handler analog, src/main/main.cpp:69-78,
        minus its hard exit)."""
        self._stop_requested = True

    def run(
        self, max_ticks: int | None = None, handle_sigint: bool = False
    ) -> LiveStats:
        """Drive ticks until the source finishes (or stop is requested).

        ``handle_sigint=True`` installs a SIGINT handler for the duration
        of the loop: the first Ctrl-C requests a graceful stop (drain +
        final report), a second one falls through to KeyboardInterrupt.
        """
        import signal as _signal

        prev_handler = None
        if handle_sigint:

            def _on_sigint(signum, frame):
                if self._stop_requested:  # second Ctrl-C: give up
                    raise KeyboardInterrupt
                self.request_stop()

            try:
                prev_handler = _signal.signal(_signal.SIGINT, _on_sigint)
            except ValueError:  # not the main thread
                prev_handler = None
        try:
            ticks = 0
            while not self.source.finished and not self._stop_requested:
                self.step()
                ticks += 1
                if max_ticks is not None and ticks >= max_ticks:
                    break
        finally:
            if prev_handler is not None:
                _signal.signal(_signal.SIGINT, prev_handler)
        self._collect_pending_basecall()  # overlap_ticks: trailing tick
        self.sender.drain()
        # reads whose chunks ran out while unclassified (a read can sit in
        # both maps: once_seen from an earlier chunk, pending from its last)
        unresolved = set(self.once_seen) | set(self.pending_bc)
        self.stats.unclassified = len(unresolved)
        for rid in unresolved:
            tm = self.measures.pop(rid, None)
            if tm is None:
                continue
            tm.complete.stop()
            self.interval.push(
                Durations(
                    complete_unclassified=tm.complete.elapsed(),
                    basecalling=tm.basecall.elapsed(),
                    classification=tm.classify.elapsed(),
                )
            )
        self.depleted_writer.close()
        self.target_writer.close()
        self.stats.actions_succeeded = self.sender.succeeded
        self.stats.actions_failed = self.sender.failed
        self.sender.close()
        return self.stats
