"""k-mer encoding and Bloom hashing — the "rbt1" hash scheme.

A copy of readbouncer_tpu/ibf/hashing.py (the port imports nothing of
the JAX package); the numpy hashers here are the query oracle's.

The reference delegates k-mer hashing to its pinned SeqAn fork (not part
of the reference tree; see SURVEY.md §7 Hard Parts #1).  That scheme is
built on 64-bit multiplies, which TPUs do not execute natively.  We
therefore define our own documented, versioned scheme ("rbt1") that is

* **all-uint32** — every op maps to native TPU VPU instructions,
* **semantically equivalent** — N is a 5th symbol like the reference's
  Dna5 alphabet, every window is counted (including N-containing ones),
  forward and reverse-complement strands are two separate query passes
  merged per bin exactly like seqan::count fwd + revcomp
  (reference: src/IBF/IBFClassify.cpp:97-98,149-150),
* **count-equivalent at the reference's sizing** — with max_fp=0.01 the
  per-bin Bloom counts equal exact k-mer containment counts up to
  O(max_fp) noise, so classification decisions match the reference's for
  any well-distributed hash family (validated against an exact-count
  oracle in tests/test_query.py).

Scheme definition (version "rbt1"):

* base encoding (Dna5 ordValue): A=0, C=1, G=2, T=3, everything else=4.
* forward k-mer code of window j:   sum_t base[j+t] * 5^(k-1-t)  mod 2^32
* revcomp k-mer code of window j:   sum_t comp(base[j+t]) * 5^t  mod 2^32
  (equal to the forward code of the reverse-complemented window, so
  counting rc codes over forward windows == counting fwd codes over the
  reverse-complemented read; comp(b) = 3-b for b<4 else 4)
* Bloom hash i (i < h):  z = code * SEED[i]; z = fmix32(z);
  row = (z * rows) >> 32      (Lemire fastrange, 32x32->hi32)
* bit position of (row, bin):  word = row*W + bin//32, bit = bin % 32
  where W = padded_bins/32 — bin-interleaved like the reference layout
  (64-bin-padded rows; reference: src/IBF/IBFBuild.cpp:407).

fmix32 is the MurmurHash3 finalizer.  SEED[i] are odd 32-bit constants
(xxhash primes), so code -> z is a bijection per hash function.

Scheme "rbt2" (blocked rows — the TPU-native default for new builds):

rbt1's h row lookups per k-mer are h independent random rows, and on TPU
every row gather moves a full (8 sublane x 128 lane) HBM tile whatever
the row width — measured 62.5 Mrows/s on v5e, i.e. the query kernel pays
3 tile fetches per window.  rbt2 constrains the h rows of a k-mer to one
aligned block of 8 consecutive rows so the query gathers ONE tile per
window (scripts/gather_probe.py; docs/PERF_NOTES.md):

* rows is a multiple of 8; block count B = rows/8.
* block(c)  = (fmix32(c * SEED[0]) * B) >> 32          (fastrange)
* offsets(c): h DISTINCT row offsets in [0, 8) drawn from
  v = fmix32(c * SEED[1]):
    pick_0 = v & 7
    pick_i (i>=1): t = (v >> 3i) % (8 - i), then t is mapped into
    [0,8) minus {pick_0..pick_{i-1}} by bumping t past each previously
    chosen offset in ascending order (order statistics insertion).
* row_i = block(c)*8 + offset_i(c).

Within-block rows are not independent across the full bit space, so a
blocked filter needs more rows for the same false-positive bound; the
exact occupancy Markov model and sizing solver live in
ibf.params.blocked_rows_for_fp.  Bit/word interleaving, forward-only
insertion and fwd+rc querying are identical to rbt1.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "HASH_SCHEME",
    "SUPPORTED_SCHEMES",
    "BLOCK_ROWS",
    "SEEDS",
    "encode_bases",
    "complement",
    "kmer_codes_np",
    "hash_rows_np",
    "block_offsets_np",
    "POW5",
]

HASH_SCHEME = "rbt1"  # default for new builds; rbt2 stays load/query-able
SUPPORTED_SCHEMES = ("rbt1", "rbt2")
BLOCK_ROWS = 8  # rbt2: rows per gather block (= one TPU sublane tile)

# xxhash 32-bit primes + two more odd constants; index = hash function id.
SEEDS = np.array(
    [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1],
    dtype=np.uint32,
)

# 5^i mod 2^32 for i in [0, 16)
POW5 = np.array([pow(5, i, 1 << 32) for i in range(16)], dtype=np.uint32)

_BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_LUT[_c] = _i
for _i, _c in enumerate(b"acgt"):
    _BASE_LUT[_c] = _i


def encode_bases(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 ordValues (A=0 C=1 G=2 T=3 other=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    arr = np.frombuffer(bytes(seq), dtype=np.uint8) if not isinstance(seq, np.ndarray) else seq
    return _BASE_LUT[arr]


def complement(bases: np.ndarray) -> np.ndarray:
    """Dna5 complement of encoded bases: 3-b for ACGT, N stays N."""
    return np.where(bases < 4, 3 - bases, np.uint8(4)).astype(np.uint8)


def kmer_codes_np(bases: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(fwd, rc) uint32 k-mer codes for every window of an encoded read.

    Returns two arrays of length ``len(bases) - k + 1`` (empty if the read
    is shorter than k).
    """
    bases = np.asarray(bases, dtype=np.uint32)
    n = bases.shape[0] - k + 1
    if n <= 0:
        return (np.zeros(0, dtype=np.uint32), np.zeros(0, dtype=np.uint32))
    comp = np.where(bases < 4, 3 - bases, np.uint32(4))
    fwd = np.zeros(n, dtype=np.uint32)
    rc = np.zeros(n, dtype=np.uint32)
    for t in range(k):
        fwd += bases[t : t + n] * POW5[k - 1 - t]
        rc += comp[t : t + n] * POW5[t]
    return fwd, rc


def _fmix32(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint32)
    z ^= z >> np.uint32(16)
    z *= np.uint32(0x85EBCA6B)
    z ^= z >> np.uint32(13)
    z *= np.uint32(0xC2B2AE35)
    z ^= z >> np.uint32(16)
    return z


def hash_rows_np(
    codes: np.ndarray, hash_functions: int, rows: int, scheme: str = "rbt1"
) -> np.ndarray:
    """uint32 row indices, shape ``codes.shape + (hash_functions,)``.

    rbt1: row_i = fastrange32(fmix32(code * SEED[i]), rows)
    rbt2: row_i = block(code) * 8 + offset_i(code)   (see module doc)
    """
    codes = np.asarray(codes, dtype=np.uint32)
    if scheme == "rbt2":
        block, offs = block_offsets_np(codes, hash_functions, rows)
        return block[..., None] * np.uint32(BLOCK_ROWS) + offs
    if scheme != "rbt1":
        raise ValueError(f"unknown hash scheme {scheme!r}")
    out = np.empty(codes.shape + (hash_functions,), dtype=np.uint32)
    for i in range(hash_functions):
        z = _fmix32(codes * SEEDS[i])
        out[..., i] = ((z.astype(np.uint64) * np.uint64(rows)) >> np.uint64(32)).astype(
            np.uint32
        )
    return out


def block_offsets_np(
    codes: np.ndarray, hash_functions: int, rows: int
) -> tuple[np.ndarray, np.ndarray]:
    """rbt2 (block, offsets) per code: block u32 [...], offsets u32 [..., h].

    Offsets are h distinct values in [0, BLOCK_ROWS); see module doc for
    the order-statistics construction (reproduced bit-exactly on device in
    ibf.query).
    """
    if rows % BLOCK_ROWS:
        raise ValueError(f"rbt2 needs rows % {BLOCK_ROWS} == 0, got {rows}")
    if hash_functions > BLOCK_ROWS:
        raise ValueError("rbt2 needs hash_functions <= 8")
    codes = np.asarray(codes, dtype=np.uint32)
    n_blocks = np.uint64(rows // BLOCK_ROWS)
    z0 = _fmix32(codes * SEEDS[0])
    block = ((z0.astype(np.uint64) * n_blocks) >> np.uint64(32)).astype(np.uint32)
    v = _fmix32(codes * SEEDS[1])
    offs = np.empty(codes.shape + (hash_functions,), dtype=np.uint32)
    offs[..., 0] = v & np.uint32(7)
    for i in range(1, hash_functions):
        t = ((v >> np.uint32(3 * i)) % np.uint32(BLOCK_ROWS - i)).astype(np.uint32)
        # bump past previously chosen offsets in ascending order
        prior = np.sort(offs[..., :i], axis=-1)
        for j in range(i):
            t = t + (t >= prior[..., j]).astype(np.uint32)
        offs[..., i] = t
    return block, offs
