"""Basecaller accuracy metrics — a copy of readbouncer_tpu/models/eval.py.

The reference never measures its basecaller in-tree (deepnano2 is a
prebuilt binary).  Read identity = 1 - levenshtein / len(truth), the
standard basecaller metric, is what the trainer's eval loop
(tools/train_basecaller.py) and the card's smoke run hold the GRU to.
"""

from __future__ import annotations

import numpy as np

__all__ = ["levenshtein", "sequence_identity", "batch_identity"]


def levenshtein(a: str, b: str) -> int:
    """Edit distance, vectorized one row at a time (O(len(a)*len(b)))."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    bb = np.frombuffer(b.encode(), dtype=np.uint8)
    prev = np.arange(len(b) + 1, dtype=np.int32)
    for i, ca in enumerate(a.encode()):
        cur = np.empty_like(prev)
        cur[0] = i + 1
        sub = prev[:-1] + (bb != ca)
        # cur[j] = min(prev[j] + 1, sub[j-1], cur[j-1] + 1); the cur[j-1]
        # dependency is resolved with a running minimum scan
        best = np.minimum(prev[1:] + 1, sub)
        run = cur[0]
        for j in range(len(b)):  # pragma: no branch - tight scalar scan
            run = min(run + 1, best[j])
            cur[j + 1] = run
        prev = cur
    return int(prev[-1])


def sequence_identity(truth: str, called: str) -> float:
    """1 - edit_distance / len(truth); 0.0 when the truth is empty."""
    if not truth:
        return 0.0
    return max(0.0, 1.0 - levenshtein(truth, called) / len(truth))


def batch_identity(truths: list[str], calls: list[str]) -> float:
    """Length-weighted mean identity over a batch."""
    total = sum(len(t) for t in truths)
    if total == 0:
        return 0.0
    s = sum(sequence_identity(t, c) * len(t) for t, c in zip(truths, calls))
    return s / total
