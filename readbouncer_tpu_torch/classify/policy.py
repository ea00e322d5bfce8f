"""Classification decision policies, vectorized over read batches.

A copy of readbouncer_tpu/classify/policy.py (numpy; the device ports of
both policies, classify and live, are in classify/fused.py).

Inputs are per-(read, filter) maximum matched k-mer counts (from
``FilterStack.max_counts``) evaluated at two error rates: the configured
``error_rate`` ("base") and ``error_rate - 0.02`` ("retry").  Counts do
not depend on the error rate, so the retry is a re-threshold of the same
counts pass — decisions are identical to the reference's second full
count pass (src/main/classify.hpp:67-69, src/main/adaptive_sampling.hpp:55-59).

Two policy asymmetries from the reference are preserved exactly:

* **classify mode** calls the dual-filter overload target-first
  (p.first = target count; src/main/classify.hpp:62), and picks the best
  target by re-classifying at the *base* error rate after the retry
  (src/main/classify.hpp:77 runs after error_rate was restored).
* **adaptive-sampling mode** calls it deplete-first
  (p.first = deplete count; src/main/adaptive_sampling.hpp:47).

Best-filter selection is strict-greater argmax with first-index
tie-breaking and -1 when all counts are zero
(reference: src/IBF/IBFClassify.cpp:262-273).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "best_filter_index",
    "classify_decisions",
    "live_decisions",
    "DECISION_NONE",
    "DECISION_UNBLOCK",
    "DECISION_STOP_RECEIVING",
]

DECISION_NONE = 0
DECISION_UNBLOCK = 1
DECISION_STOP_RECEIVING = 2


def best_filter_index(counts: np.ndarray) -> np.ndarray:
    """First-max argmax per read; -1 where the max is 0.

    counts: int array [R, F].  Reference: src/IBF/IBFClassify.cpp:262-273.
    """
    counts = np.asarray(counts)
    best = np.argmax(counts, axis=1)
    return np.where(counts.max(axis=1) > 0, best, -1)


def classify_decisions(
    target_base: np.ndarray | None,
    deplete_base: np.ndarray | None,
    target_retry: np.ndarray | None,
    deplete_retry: np.ndarray | None,
) -> tuple[np.ndarray, np.ndarray]:
    """Offline-classify decision for a batch (one chunk attempt per read).

    Arguments are per-filter max counts [R, F] (None when that filter kind
    is absent).  Returns ``(classified[R] bool, best_target[R] int)``;
    best_target is -1 for unclassified reads and for deplete-only mode.

    Reference policy: classify_deplete_target (src/main/classify.hpp:58-111)
    when both kinds present; r.classify(Depletion) > -1 for deplete-only
    (src/main/classify.hpp:281); best-target argmax for target-only
    (src/main/classify.hpp:284-291).
    """
    have_t = target_base is not None and target_base.shape[1] > 0
    have_d = deplete_base is not None and deplete_base.shape[1] > 0
    if have_t and have_d:
        tmax = target_base.max(axis=1)
        dmax = deplete_base.max(axis=1)
        tmax2 = target_retry.max(axis=1)
        dmax2 = deplete_retry.max(axis=1)
        # p.first (=target) > 0 is required in every classified branch
        both = (tmax > 0) & (dmax > 0)
        # retry outcome when both matched: classified iff target-only remains
        retry_ok = (tmax2 > 0) & (dmax2 == 0)
        classified = ((tmax > 0) & (dmax == 0)) | (both & retry_ok)
        best = best_filter_index(target_base)  # base error rate, see docstring
        best = np.where(classified, best, -1)
        classified = classified & (best >= 0)
        return classified, best
    if have_d:
        dbest = best_filter_index(deplete_base)
        return dbest > -1, np.full(deplete_base.shape[0], -1, dtype=np.int64)
    if have_t:
        best = best_filter_index(target_base)
        return best != -1, best
    raise ValueError("no filters provided")


def live_decisions(
    deplete_base: np.ndarray | None,
    target_base: np.ndarray | None,
    deplete_retry: np.ndarray | None,
    target_retry: np.ndarray | None,
) -> np.ndarray:
    """check_unblock for a batch: 0=continue, 1=unblock, 2=stop_receiving.

    Reference: src/main/adaptive_sampling.hpp:35-113.
    """
    have_t = target_base is not None and target_base.shape[1] > 0
    have_d = deplete_base is not None and deplete_base.shape[1] > 0
    if have_t and have_d:
        dmax = deplete_base.max(axis=1)
        tmax = target_base.max(axis=1)
        dmax2 = deplete_retry.max(axis=1)
        tmax2 = target_retry.max(axis=1)
        out = np.zeros(dmax.shape[0], dtype=np.int64)
        # deplete matched, target not -> unblock
        out = np.where((dmax > 0) & (tmax == 0), DECISION_UNBLOCK, out)
        # both matched -> retry at lower error rate; unblock iff deplete-only
        both = (dmax > 0) & (tmax > 0)
        out = np.where(both & (dmax2 > 0) & (tmax2 == 0), DECISION_UNBLOCK, out)
        # target matched, deplete not -> stop receiving
        out = np.where((dmax == 0) & (tmax > 0), DECISION_STOP_RECEIVING, out)
        return out
    if have_d:
        dmax = deplete_base.max(axis=1)
        return np.where(dmax > 0, DECISION_UNBLOCK, DECISION_NONE)
    if have_t:
        tmax = target_base.max(axis=1)
        # target-only mode unblocks everything off-target
        return np.where(tmax > 0, DECISION_STOP_RECEIVING, DECISION_UNBLOCK)
    raise ValueError("no filters provided")
