"""Decision mathematics — exact reproduction of the reference semantics.

A copy of readbouncer_tpu/classify/math.py (the port imports nothing of
the JAX package).

This is the "kernel of truth": every numeric decision the framework makes
goes through the functions in this module (host, float64) or their
vectorized numpy equivalents.  The semantics mirror the reference
implementation exactly, including its integer-conversion quirks:

* ``rational_approximation`` / ``normal_cdf_inverse`` — the
  Abramowitz-Stegun 26.2.23 approximation of the inverse normal CDF
  (reference: src/IBF/IBF.hpp:268-308).
* ``calculate_ci`` — the Blanca et al. confidence interval on the number
  of mutated k-mers (reference: src/IBF/IBF.hpp:320-338).
* ``match_threshold`` / ``ci_and_threshold_batch`` — (scalar / batched)
  the minimum k-mer count for a bin to match, ``readlen - k + 1 - ci_high``,
  through the reference's uint16(readlen) -> int16(threshold) ->
  uint16(parameter) conversion chain (reference:
  src/IBF/IBFClassify.cpp:105,109,51).  A negative threshold wraps to
  ~65529 and therefore matches nothing — this is production behavior.

float64 is mandatory: f32 shifts thresholds by +-1 k-mer.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "rational_approximation",
    "normal_cdf_inverse",
    "calculate_ci",
    "match_threshold",
    "ci_and_threshold_batch",
]


def rational_approximation(t: float) -> float:
    """Abramowitz-Stegun formula 26.2.23 (|error| < 4.5e-4).

    Reference: src/IBF/IBF.hpp:268-277.
    """
    c = (2.515517, 0.802853, 0.010328)
    d = (1.432788, 0.189269, 0.001308)
    return t - ((c[2] * t + c[1]) * t + c[0]) / (
        ((d[2] * t + d[1]) * t + d[0]) * t + 1.0
    )


def normal_cdf_inverse(p: float) -> float:
    """Inverse normal CDF via the rational approximation.

    Reference: src/IBF/IBF.hpp:284-308.
    """
    if p <= 0.0 or p >= 1.0:
        raise ValueError(
            f"Invalid input argument ({p}); must be larger than 0 but less than 1."
        )
    if p < 0.5:
        return -rational_approximation(math.sqrt(-2.0 * math.log(p)))
    return rational_approximation(math.sqrt(-2.0 * math.log(1.0 - p)))


def _var_n(q: float, r: float, k: float, L: float) -> float:
    """Variance of the number of mutated k-mers (Blanca et al.).

    Reference: src/IBF/IBF.hpp:328-330.
    """
    return (
        L * (1.0 - q) * (q * (2.0 * k + (2.0 / r) - 1.0) - 2.0 * k)
        + k * (k - 1.0) * (1.0 - q) ** 2.0
        + (2.0 * (1.0 - q) / (r**2.0)) * ((1.0 + (k - 1.0) * (1.0 - q)) * r - q)
    )


def calculate_ci(
    r: float, kmer_size: int, readlen: int, confidence: float
) -> tuple[int, int]:
    """Confidence interval for the number of erroneous k-mers in a read.

    Returns ``(low, high)`` with the reference's uint16 wrap semantics.
    Reference: src/IBF/IBF.hpp:320-338.
    """
    q = 1.0 - (1.0 - r) ** float(kmer_size)
    L = float(readlen) - float(kmer_size) + 1.0
    var_n = _var_n(q, r, float(kmer_size), L)
    alpha = 1.0 - confidence
    z = normal_cdf_inverse(1.0 - alpha / 2.0)
    if var_n < 0.0:
        # tiny reads make the variance model negative; the reference takes
        # sqrt(<0) = NaN and the x86 double->uint16 cast of NaN yields 0
        # (cvttsd2si indefinite 0x80000000, truncated).  Reproduced.
        return (0, 0)
    sd = math.sqrt(var_n)
    low = int(math.floor(L * q - z * sd)) & 0xFFFF
    high = int(math.ceil(L * q + z * sd)) & 0xFFFF
    return (low, high)


def match_threshold(
    readlen: int, kmer_size: int, error_rate: float, significance: float
) -> int:
    """Effective uint16 per-bin match threshold for a read.

    ``threshold = readlen - k + 1 - ci_high`` through the reference's
    uint16(readlen) -> int16 -> uint16 conversion chain.  The returned
    value is what the per-bin count comparison actually uses; a read whose
    raw threshold is negative gets a value near 65535 and matches nothing.
    Reference: src/IBF/IBFClassify.cpp:102-113.
    """
    _, ci_high = calculate_ci(error_rate, kmer_size, readlen, significance)
    readlen_u16 = readlen & 0xFFFF
    return (readlen_u16 - kmer_size + 1 - ci_high) & 0xFFFF


def ci_and_threshold_batch(
    readlens: np.ndarray,
    kmer_size: int,
    error_rate: float,
    significance: float,
) -> np.ndarray:
    """Vectorized uint16 thresholds for a batch of read lengths.

    float64 numpy implementation of :func:`match_threshold`; bit-identical
    to the scalar path (verified by tests).  Lengths below ``kmer_size``
    get threshold 0xFFFF (no bin can ever match; callers treat such reads
    as un-classifiable, mirroring the reference's skip/throw behavior at
    src/IBF/IBFClassify.cpp:251,318).
    """
    readlens = np.asarray(readlens, dtype=np.int64)
    k = float(kmer_size)
    r = float(error_rate)
    q = 1.0 - (1.0 - r) ** k
    L = readlens.astype(np.float64) - k + 1.0
    var_n = _var_n(q, r, k, L)
    alpha = 1.0 - significance
    z = normal_cdf_inverse(1.0 - alpha / 2.0)
    # tiny reads make the variance model negative; the reference's
    # sqrt(<0) = NaN casts to uint16 0 on x86 — reproduce as high = 0
    # (see calculate_ci).
    sd = np.sqrt(np.maximum(var_n, 0.0))
    high = np.where(
        var_n < 0.0,
        np.int64(0),
        np.ceil(L * q + z * sd).astype(np.int64) & 0xFFFF,
    )
    thr = ((readlens & 0xFFFF) - kmer_size + 1 - high) & 0xFFFF
    return np.where(readlens < kmer_size, 0xFFFF, thr).astype(np.uint32)
