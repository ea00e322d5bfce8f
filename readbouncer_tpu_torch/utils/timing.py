"""Per-read timing instrumentation.

A copy of readbouncer_tpu/utils/timing.py (the port imports nothing of the JAX
package).

Equivalent of the reference's StopClock / TimeMeasures / Durations
(src/util/StopClock.hpp:10-96): every read carries three stopwatches
(complete, basecall, classify); chunk-merging keeps the earliest start
(the reference's decrementStart/setBegin bookkeeping,
src/util/StopClock.hpp:33-42).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["StopClock", "TimeMeasures", "Durations", "OnlineMean"]


@dataclass
class StopClock:
    begin: float = 0.0
    end: float = 0.0
    _accum: float = 0.0
    running: bool = False

    def start(self) -> None:
        self.begin = time.monotonic()
        self.running = True

    def stop(self) -> None:
        self.end = time.monotonic()
        if self.running:
            self._accum += self.end - self.begin
            self.running = False

    def elapsed(self) -> float:
        if self.running:
            return self._accum + (time.monotonic() - self.begin)
        return self._accum

    def set_begin(self, other: "StopClock") -> None:
        """Adopt an earlier start (chunk merge)."""
        self.begin = other.begin
        if not self.running:
            self._accum = 0.0
            self.running = True

    def add(self, seconds: float) -> None:
        """Accumulate an externally-measured span (batched attribution:
        the scheduler brackets one device batch and divides the span over
        the reads in it — the batched analog of the reference's per-read
        bracketing, DeepNanoBasecaller.cpp:41-44)."""
        self._accum += seconds


@dataclass
class TimeMeasures:
    complete: StopClock = field(default_factory=StopClock)
    basecall: StopClock = field(default_factory=StopClock)
    classify: StopClock = field(default_factory=StopClock)


@dataclass
class Durations:
    """Plain record pushed to the stats aggregation
    (reference: src/util/StopClock.hpp:90-96)."""

    complete_classified: float = -1.0
    complete_unclassified: float = -1.0
    basecalling: float = 0.0
    classification: float = 0.0


class OnlineMean:
    """Numerically-stable running mean (the reference's
    ``avg += (x - avg) / ++n`` pattern)."""

    def __init__(self) -> None:
        self.n = 0
        self.mean = 0.0

    def add(self, x: float) -> float:
        self.n += 1
        self.mean += (x - self.mean) / self.n
        return self.mean
