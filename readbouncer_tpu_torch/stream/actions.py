"""Action batching, pacing and the per-decision CSV log.

A copy of readbouncer_tpu/stream/actions.py (the port imports nothing of the JAX
package).

Mirrors readuntil::Data's action consumer (src/minknow/Data.cpp:137-257):

* actions are sent in batches of at most ``batch_size`` (initial 50,
  src/minknow/Data.hpp:81),
* adaptive batch sizing: grow by the queue backlog when the queue is
  longer than the batch, decay by x0.8 otherwise
  (adaptActionBatchSize, src/minknow/Data.cpp:265-275),
* at least ``pacing_seconds`` (0.4 s) between requests
  (src/minknow/Data.cpp:245-252) — enforced in wall-clock mode, counted
  in replay-tick mode,
* unblock actions carry the 0.1 s voltage-flip duration
  (src/minknow/Data.cpp:171),
* every decision is appended to ``read_until_decision_stats.csv`` with
  {read_id, channel, read_nr, sequence length, decision, duration}
  (src/minknow/Data.cpp:143-146,174-187),
* transient delivery failures (exceptions from the action sink) are
  retried up to 5x with 0.4 s backoff, then raised
  (src/minknow/Data.cpp:229-243); a ``False`` return is the permanent
  failed_to_apply case (read already gone) and is only counted,
* reads whose complete processing time exceeds 100 s are flagged to
  stderr (the latency outlier alarm, src/minknow/Data.cpp:197-213).
"""

from __future__ import annotations

import csv
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Action", "ActionSender"]

UNBLOCK_DURATION_SECONDS = 0.1  # reference: src/minknow/Data.cpp:171
LATENCY_ALARM_SECONDS = 100.0  # reference: src/minknow/Data.cpp:197-199


@dataclass
class Action:
    channel: int
    read_number: int
    read_id: str
    unblock: bool  # True: unblock; False: stop_receiving_data
    seq_length: int = 0
    queued_at: float = 0.0
    processing_seconds: float = 0.0


class ActionSender:
    """Batches actions to the (replayed) device with pacing + CSV log."""

    def __init__(
        self,
        source,
        output_dir: str | Path = ".",
        batch_size: int = 50,
        pacing_seconds: float = 0.4,
        wall_clock: bool = False,
        max_retries: int = 5,
    ):
        self.source = source
        self.batch_size = batch_size
        self.pacing_seconds = pacing_seconds
        self.wall_clock = wall_clock
        self.max_retries = max_retries
        self.retries = 0
        self._queue: list[Action] = []
        self._last_send = 0.0
        self.succeeded = 0
        self.failed = 0
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        self._csv_file = open(out / "read_until_decision_stats.csv", "w", newline="")
        self._csv = csv.writer(self._csv_file, delimiter=";")
        self._csv.writerow(
            ["read_id", "channel", "read_nr", "sequence_length", "decision", "duration"]
        )

    def queue(self, action: Action) -> None:
        action.queued_at = time.monotonic()
        self._queue.append(action)

    def _adapt_batch_size(self) -> None:
        qsize = len(self._queue)
        if qsize > self.batch_size:
            self.batch_size += qsize
        else:
            self.batch_size = max(1, int(self.batch_size * 0.8))

    def flush(self) -> int:
        """Send one paced batch; returns the number of actions applied."""
        if not self._queue:
            return 0
        if self.wall_clock:
            wait = self.pacing_seconds - (time.monotonic() - self._last_send)
            if wait > 0:
                time.sleep(wait)
        self._adapt_batch_size()
        batch, self._queue = self._queue[: self.batch_size], self._queue[self.batch_size :]
        applied = 0
        for a in batch:
            ok = self._deliver(a)
            applied += ok
            self.succeeded += ok
            self.failed += not ok
            if a.processing_seconds > LATENCY_ALARM_SECONDS:
                print(
                    f"Classification of Read {a.read_id} took "
                    f"{a.processing_seconds:.1f} seconds",
                    file=sys.stderr,
                )
            self._csv.writerow(
                [
                    a.read_id,
                    a.channel,
                    a.read_number,
                    a.seq_length,
                    "unblock" if a.unblock else "stop_receiving",
                    f"{a.processing_seconds:.6f}",
                ]
            )
        self._last_send = time.monotonic()
        return applied

    def _deliver(self, a: Action) -> bool:
        """Apply one action with transient-failure retries.

        Exceptions from the sink are transient (gRPC write failures in
        the reference): retried up to max_retries with pacing backoff,
        then re-raised (src/minknow/Data.cpp:229-243).  False is the
        permanent failed_to_apply response (read left the pore).
        """
        for attempt in range(self.max_retries):
            try:
                if a.unblock:
                    return self.source.unblock(a.channel, a.read_number)
                return self.source.stop_receiving(a.channel, a.read_number)
            except Exception:
                self.retries += 1
                if attempt == self.max_retries - 1:
                    raise
                if self.wall_clock:
                    time.sleep(self.pacing_seconds)
        return False  # pragma: no cover - unreachable

    def drain(self) -> int:
        total = 0
        while self._queue:
            total += self.flush()
        return total

    def close(self) -> None:
        self._csv_file.close()
