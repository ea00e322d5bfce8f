"""IBF sizing and configuration parameters.

A copy of readbouncer_tpu/ibf/params.py.

Reproduces the reference's filter geometry exactly:

* ``bin_size_bits`` — bits per bin slice, from the max false-positive
  rate, hash count and fragment length
  (reference: src/IBF/IBFBuild.cpp:404-413).
* bins are padded up to the next multiple of 64 — the interleaved layout
  stores one 64-bin block per hash row in the reference; we keep the same
  logical padding so filter-bit parity is meaningful
  (reference: src/IBF/IBFBuild.cpp:407).
* default constants k=13, 3 hash functions, max_fp=0.01, overlap 1500
  (reference: src/IBF/IBFConfig.hpp:67-77).

Golden: 2 bins, k=13, fragment_length=100000, h=3, fp=0.01
=> 79_121_216 total bits (reference: src/test/libIBFTests/createfilter.hpp:139-152).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

from readbouncer_tpu_torch.errors import InvalidParamsError

__all__ = [
    "IBFParams",
    "bin_size_bits",
    "blocked_rows_for_fp",
    "blocked_fp",
    "optimal_bins",
    "filter_size_bits",
]


def bin_size_bits(
    fragment_length: int, kmer_size: int, hash_functions: int, max_fp: float
) -> int:
    """Bits per bin slice (= number of hash rows).

    ``ceil(-1 / ((1 - max_fp^(1/h))^(1/(h*(fragLen-k+1))) - 1))``
    Reference: src/IBF/IBFBuild.cpp:406-409.
    """
    max_kmer_count = fragment_length - kmer_size + 1
    inner = math.pow(
        1.0 - math.pow(max_fp, 1.0 / hash_functions),
        1.0 / (hash_functions * max_kmer_count),
    )
    return int(math.ceil(-1.0 / (inner - 1.0)))


def blocked_fp(
    rows: int,
    n_keys: int,
    hash_functions: int,
    block: int = 8,
    kmers_per_key: int = 1,
) -> float:
    """Exact false-positive rate of one rbt2/rbt3 bin column.

    Model: the column has ``rows`` bits in ``rows/block`` blocks; each of
    ``n_keys`` inserted keys picks a uniform block and sets
    ``kmers_per_key`` groups of ``hash_functions`` DISTINCT bits of it
    (rbt2: one k-mer per block key; rbt3: each (k-3)-mer key carries its
    4 containing k-mers).  A uniform query is a false positive iff its
    own h-subset of its block is fully set.  Occupancy of a block follows
    a Markov chain over the number of set bits u: inserting one k-mer
    moves u -> u + t with hypergeometric
    P(t | u) = C(block-u, t) * C(u, h-t) / C(block, h); keys per block are
    Poisson(lambda = n_keys * block / rows).  Conditioned on j keys (=
    j * kmers_per_key k-mer insertions) with occupancy u,
    P(false positive) = C(u, h) / C(block, h).
    """
    h = hash_functions
    lam = n_keys * block / rows
    if lam > 64.0:
        # >=64 expected keys per 8-bit block: saturated, exp(-lam) would
        # underflow the Poisson mixture to a bogus 0
        return 1.0
    # occupancy distribution after j key insertions (kmers_per_key k-mer
    # events each), j up to a Poisson tail cut
    j_max = max(8, int(lam + 12.0 * math.sqrt(lam) + 12)) * kmers_per_key
    occ = [0.0] * (block + 1)
    occ[0] = 1.0
    denom = math.comb(block, h)
    fp_given_j = []  # E[C(u,h)]/C(block,h) after j k-mer events
    fp_given_j.append(sum(p * math.comb(u, h) for u, p in enumerate(occ)) / denom)
    for _ in range(j_max):
        nxt = [0.0] * (block + 1)
        for u, p in enumerate(occ):
            if p == 0.0:
                continue
            for t in range(0, h + 1):
                if t > block - u or h - t > u:
                    continue
                q = math.comb(block - u, t) * math.comb(u, h - t) / denom
                nxt[u + t] += p * q
        occ = nxt
        fp_given_j.append(sum(p * math.comb(u, h) for u, p in enumerate(occ)) / denom)
    # Poisson mixture over j keys; key j contributes at event index
    # j * kmers_per_key
    pj = math.exp(-lam)
    fp = pj * fp_given_j[0]
    j = 1
    while j * kmers_per_key <= j_max:
        pj *= lam / j
        fp += pj * fp_given_j[j * kmers_per_key]
        j += 1
    return fp


def blocked_rows_for_fp(
    n_keys: int,
    hash_functions: int,
    max_fp: float,
    block: int = 8,
    kmers_per_key: int = 1,
) -> int:
    """Smallest rows (multiple of ``block``) with blocked_fp <= max_fp.

    The rbt2/rbt3 analog of bin_size_bits: blocked filters trade extra
    bits for one-gather-per-window (rbt2) or one-gather-per-4-windows
    (rbt3) queries (ibf.hashing module doc).
    """
    # blocked fp >= unblocked fp at equal size, so the reference formula
    # (rows for an ideal h-hash Bloom over all inserted k-mer events)
    # seeds the lower bound
    events = n_keys * kmers_per_key
    ideal = -1.0 / (
        math.pow(1.0 - math.pow(max_fp, 1.0 / hash_functions), 1.0 / (hash_functions * events))
        - 1.0
    )
    lo = max(block, int(ideal) // block * block)
    hi = lo
    while blocked_fp(hi, n_keys, hash_functions, block, kmers_per_key) > max_fp:
        lo = hi
        hi *= 2
        if hi > (1 << 34):
            raise InvalidParamsError("blocked sizing diverged")
    while lo + block < hi:
        mid = (lo + hi) // 2 // block * block
        if mid <= lo:
            break
        if blocked_fp(mid, n_keys, hash_functions, block, kmers_per_key) > max_fp:
            lo = mid
        else:
            hi = mid
    return hi


def optimal_bins(num_bins: int) -> int:
    """Bins padded to the next multiple of 64.

    The reference computes ``floor(bins/64 + 1) * 64`` — note this pads an
    exact multiple of 64 up by another 64 (floor semantics with +1);
    reproduced verbatim.  Reference: src/IBF/IBFBuild.cpp:407.
    """
    return int(math.floor(num_bins / 64.0 + 1.0)) * 64


def filter_size_bits(
    num_bins: int,
    fragment_length: int,
    kmer_size: int = 13,
    hash_functions: int = 3,
    max_fp: float = 0.01,
) -> int:
    """Total filter size in bits. Reference: src/IBF/IBFBuild.cpp:404-413."""
    return bin_size_bits(fragment_length, kmer_size, hash_functions, max_fp) * optimal_bins(
        num_bins
    )


@dataclass
class IBFParams:
    """Build/query parameters (reference: src/IBF/IBFConfig.hpp:48-145)."""

    kmer_size: int = 13
    fragment_length: int = 100_000
    hash_functions: int = 3
    max_fp: float = 0.01
    overlap_length: int = 1500  # only applied to fragment 0 in the reference
    # "rbt1" (independent hash rows, reference-shaped sizing; the
    # 79_121_216-bit golden) is the production scheme: measured on v5e,
    # the XLA gather engine gives blocked/wide layouts no per-index
    # discount, so rbt2 (and the evaluated-and-rejected rbt3) spend bits
    # without beating rbt1's fused h-gather.  See ibf.hashing module doc
    # and docs/PERF_NOTES.md.
    hash_scheme: str = "rbt1"
    # worker threads of the native insert (ibf/build.py's host route,
    # insert_fragments); 0 = all available cores.  The card's route does
    # not read it.  Reference analog: IBF_Params.threads
    # (src/IBF/IBFConfig.hpp:98-105).
    build_threads: int = 0

    @property
    def threads(self) -> int:
        return self.build_threads if self.build_threads > 0 else (os.cpu_count() or 1)

    def validate(self) -> "IBFParams":
        from readbouncer_tpu_torch.ibf.hashing import SUPPORTED_SCHEMES

        if self.kmer_size < 1 or self.kmer_size > 15:
            raise InvalidParamsError(
                f"kmer_size must be in [1, 15] (base-5 k-mer codes), got {self.kmer_size}"
            )
        if self.fragment_length <= self.kmer_size:
            raise InvalidParamsError("fragment_length must exceed kmer_size")
        if self.hash_functions < 1 or self.hash_functions > 5:
            raise InvalidParamsError("hash_functions must be in [1, 5]")
        if not (0.0 < self.max_fp < 1.0):
            raise InvalidParamsError("max_fp must be in (0, 1)")
        if self.hash_scheme not in SUPPORTED_SCHEMES:
            raise InvalidParamsError(
                f"hash_scheme must be one of {SUPPORTED_SCHEMES}, got {self.hash_scheme!r}"
            )
        return self

    @property
    def rows(self) -> int:
        """Hash rows = bits per bin slice (scheme-dependent sizing)."""
        if self.hash_scheme == "rbt2":
            return blocked_rows_for_fp(
                self.fragment_length - self.kmer_size + 1,
                self.hash_functions,
                self.max_fp,
            )
        return bin_size_bits(
            self.fragment_length, self.kmer_size, self.hash_functions, self.max_fp
        )

    def total_bits(self, num_bins: int) -> int:
        return self.rows * optimal_bins(num_bins)
