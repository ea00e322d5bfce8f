"""Batched IBF query on the device — the torch counterpart of
readbouncer_tpu/ibf/query.py.

For a padded batch of encoded reads it computes the per-bin k-mer match
counts against a stack of filters, forward and reverse-complement, and
reduces them to per-filter maximum matched counts under a per-read
threshold:

    reads [R, L] u8 -> k-mer codes [R, 2, n]            (k shifted MACs)
                    -> hash rows  h x [R, 2, n]          (fmix32 + fastrange)
                    -> row gather -> AND over h          (anded_windows)
                    -> bit-plane counters [2R, P, W]     (kernel K1)
                    -> counts [R, 2, B] or per-filter maxima (kernel K2)

``counts`` also keeps the JAX package's two XLA accumulation routes
(``accum="ripple"`` and ``"tree"``, over chunks of ``WINDOW_CHUNK``
windows), which ``tools/proto_counts_layout.py`` times against K1.

u32 values are held in int64 tensors (torch's uint32 lacks shifts and
comparisons on both CPU and CUDA); every product of two u32 values is
split into 16-bit limbs so no int64 product passes 2^63, and results are
masked to 32 bits.  Bits, membership words and planes are int32 tensors
read as u32 words (bitwise ops do not care about the sign).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.errors import EmptyFilterError, FilterGeometryError
from readbouncer_tpu_torch.ibf.hashing import BLOCK_ROWS, POW5, SEEDS
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.ops.ibf_count import (
    accumulate_planes,
    expand_planes,
    pack_bin_mask,
)

__all__ = [
    "umulhi_u32",
    "mul_u32",
    "fmix32",
    "kmer_codes",
    "block_offsets",
    "hash_rows_all",
    "FilterSegment",
    "FilterStack",
    "anded_windows",
    "counts_planes",
    "add_planes",
    "counts",
    "max_counts",
]

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF

ACCUMS = ("k1", "ripple", "tree")  # counts' accumulation routes
WINDOW_CHUNK = 128  # windows per step of the ripple and tree routes


def umulhi_u32(a: torch.Tensor, b: torch.Tensor | int) -> torch.Tensor:
    """High 32 bits of a 32x32 unsigned multiply (int64 in, int64 out).

    ``(a*b) >> 32 == (ah*b + ((al*b) >> 16)) >> 16`` with ``a = ah*2^16 +
    al``: each partial product stays below 2^48.
    """
    a = a.to(torch.int64)
    al, ah = a & _M16, a >> 16
    return (ah * b + ((al * b) >> 16)) >> 16


def mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for u32 ``a`` (int64) and a u32 constant ``c``."""
    lo = a * (c & _M16)
    hi = (a * (c >> 16)) & _M16
    return (lo + (hi << 16)) & _M32


def fmix32(z: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 finalizer (matches hashing._fmix32), int64 in and out."""
    z = z & _M32
    z = z ^ (z >> 16)
    z = mul_u32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = mul_u32(z, 0xC2B2AE35)
    return z ^ (z >> 16)


def kmer_codes(reads: torch.Tensor, k: int) -> torch.Tensor:
    """(fwd, rc) base-5 window codes for a padded read batch.

    reads: [R, L] uint8 in {0..4} (padding irrelevant: callers mask
    windows by length).  Returns int64 [R, 2, L-k+1] holding u32 codes;
    axis 1 is strand (0 = fwd, 1 = revcomp).
    """
    b = reads.to(torch.int64)
    comp = torch.where(b < 4, 3 - b, torch.full_like(b, 4))
    n = reads.shape[1] - k + 1
    fwd = torch.zeros((reads.shape[0], n), dtype=torch.int64, device=reads.device)
    rc = torch.zeros_like(fwd)
    for t in range(k):
        fwd += b[:, t : t + n] * int(POW5[k - 1 - t])
        rc += comp[:, t : t + n] * int(POW5[t])
    return torch.stack([fwd & _M32, rc & _M32], dim=1)


def block_offsets(
    codes: torch.Tensor, h: int, rows: int
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """rbt2 (block, offset list) per code — port of
    hashing.block_offsets_np (bit-identical; see ibf/hashing.py doc)."""
    n_blocks = rows // BLOCK_ROWS
    block = umulhi_u32(fmix32(mul_u32(codes, int(SEEDS[0]))), n_blocks)
    v = fmix32(mul_u32(codes, int(SEEDS[1])))
    offs = [v & 7]
    for i in range(1, h):
        t = (v >> (3 * i)) % (BLOCK_ROWS - i)
        prior = torch.sort(torch.stack(offs, dim=-1), dim=-1).values
        for j in range(i):
            t = t + (t >= prior[..., j]).to(torch.int64)
        offs.append(t)
    return block, offs


def hash_rows_all(
    codes: torch.Tensor, h: int, rows: int, scheme: str
) -> list[torch.Tensor]:
    """Per-hash int64 row indices (list of h tensors shaped like codes)."""
    if scheme == "rbt2":
        block, offs = block_offsets(codes, h, rows)
        base = block * BLOCK_ROWS
        return [base + o for o in offs]
    if scheme != "rbt1":
        raise ValueError(f"unknown hash scheme {scheme!r}")
    return [
        umulhi_u32(fmix32(mul_u32(codes, int(SEEDS[i]))), rows) for i in range(h)
    ]


@dataclass(frozen=True)
class FilterSegment:
    """One filter's bin range inside a stacked bits matrix."""

    name: str
    bin_offset: int  # multiple of 64
    num_bins: int  # declared bins (max_matches scans only these)
    padded_bins: int


class FilterStack:
    """Compatible filters concatenated on the bin axis, bits on the device.

    Filters must share (kmer_size, hash_functions, rows, scheme).  Each
    keeps its own 64-padded bin block, so word offsets stay aligned.
    ``bits`` is an int32 [rows, W] device tensor, ``bin_mask`` a bool
    [W*32] tensor of declared bins and ``mask_words`` its packed int32
    [W] form (the K2 operand).
    """

    def __init__(self, filters: list[IBFData], device=None):
        if not filters:
            raise EmptyFilterError("FilterStack needs at least one filter")
        k = filters[0].kmer_size
        h = filters[0].hash_functions
        rows = filters[0].rows
        scheme = filters[0].scheme
        for f in filters:
            if (f.kmer_size, f.hash_functions, f.rows, f.scheme) != (k, h, rows, scheme):
                raise FilterGeometryError(
                    "all filters in a stack must share kmer_size/hash_functions/rows/scheme; "
                    f"got {(f.kmer_size, f.hash_functions, f.rows, f.scheme)} vs "
                    f"{(k, h, rows, scheme)}"
                )
        segments, off = [], 0
        for f in filters:
            segments.append(FilterSegment(f.name, off, f.num_bins, f.padded_bins))
            off += f.padded_bins
        bits_np = np.concatenate([f.bits for f in filters], axis=1)
        self._init(
            k, h, rows, scheme, segments,
            torch.from_numpy(bits_np.view(np.int32)),
            resolve_device(device),
        )

    def _init(self, k, h, rows, scheme, segments, bits, device):
        self.kmer_size = k
        self.hash_functions = h
        self.rows = rows
        self.scheme = scheme
        self.device = device
        self.segments = list(segments)
        self.total_bins = sum(s.padded_bins for s in self.segments)
        self.words = self.total_bins // 32
        self.bits = bits.to(device).contiguous()
        bmask = np.zeros(self.total_bins, dtype=bool)
        for s in self.segments:
            bmask[s.bin_offset : s.bin_offset + s.num_bins] = True
        self.bin_mask = torch.from_numpy(bmask).to(device)
        self.mask_words = torch.from_numpy(pack_bin_mask(bmask).view(np.int32)).to(device)
        self.seg_spec = tuple((s.bin_offset, s.padded_bins) for s in self.segments)

    @classmethod
    def concat(cls, a: "FilterStack", b: "FilterStack") -> "FilterStack":
        """One stack holding ``a``'s filters then ``b``'s (same geometry)."""
        if (a.kmer_size, a.hash_functions, a.rows, a.scheme) != (
            b.kmer_size, b.hash_functions, b.rows, b.scheme
        ):
            raise FilterGeometryError("stacks differ in kmer_size/hash_functions/rows/scheme")
        out = cls.__new__(cls)
        segs = list(a.segments) + [
            FilterSegment(s.name, s.bin_offset + a.total_bins, s.num_bins, s.padded_bins)
            for s in b.segments
        ]
        out._init(
            a.kmer_size, a.hash_functions, a.rows, a.scheme, segs,
            torch.cat([a.bits, b.bits.to(a.device)], dim=1), a.device,
        )
        return out

    @property
    def num_filters(self) -> int:
        return len(self.segments)

    def counts(self, reads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Per-bin match counts, int32 [R, 2, total_bins]."""
        return counts(
            self.bits, reads.to(self.device), lengths.to(self.device),
            k=self.kmer_size, h=self.hash_functions, rows=self.rows,
            scheme=self.scheme,
        )

    def max_counts(self, cnt: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
        """Per-filter max matched count, int32 [R, F]."""
        return max_counts(
            cnt, thresholds.to(self.device), self.bin_mask, segments=self.seg_spec
        )


def anded_windows(
    bits: torch.Tensor,
    reads: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    h: int,
    rows: int,
    scheme: str,
) -> torch.Tensor:
    """Window-masked AND-of-h-hashes membership words, int32 [R, 2, n, W].

    Flat 1-D ``index_select`` gathers of whole filter rows, ANDed over the
    h hashes; windows at or past ``lengths - k + 1`` are zeroed (windows
    holding N are counted, as the reference counts them).
    """
    n_valid = torch.clamp(lengths.to(torch.int64) - (k - 1), min=0)
    return _gather_and(bits, kmer_codes(reads, k), n_valid, 0, h=h, rows=rows, scheme=scheme)


def _gather_and(bits, codes, n_valid, start: int, *, h: int, rows: int, scheme: str) -> torch.Tensor:
    """Membership words int32 [R, 2, m, W] of the windows ``start ..
    start+m`` whose codes are ``codes`` [R, 2, m]: the h row gathers ANDed,
    windows at or past ``n_valid`` [R] zeroed."""
    R, _, m = codes.shape
    W = bits.shape[-1]
    anded = None
    for ridx in hash_rows_all(codes, h, rows, scheme):
        g = bits.index_select(0, ridx.reshape(-1)).reshape(R, 2, m, W)
        anded = g if anded is None else anded.bitwise_and_(g)
    valid = (start + torch.arange(m, device=codes.device))[None, :] < n_valid[:, None]
    return anded.masked_fill_(~valid[:, None, :, None], 0)


def counts_planes(
    bits: torch.Tensor,
    reads: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    h: int,
    rows: int,
    scheme: str = "rbt1",
) -> torch.Tensor:
    """Packed bit-plane counters int32 [2R, P, W] (P = bit_length(n)):
    bit p of plane j of row 2r+s is bit j of the count of bin ``w*32+p``
    of read r, strand s.  Kernel K1 does the accumulation."""
    R, L = reads.shape
    W = bits.shape[-1]
    n = L - k + 1
    anded = anded_windows(bits, reads, lengths, k=k, h=h, rows=rows, scheme=scheme)
    return accumulate_planes(anded.reshape(2 * R, n, W), max(int(n).bit_length(), 1))


def add_planes(a: list, b: list) -> list:
    """Add two bit-plane numbers (lists of int32 word tensors, least
    significant plane first): plane i of the result is bit i of the per-lane
    sum, one full adder per plane.  Counterpart of the JAX package's
    ``_add_planes``."""
    out = []
    carry = None
    for j in range(max(len(a), len(b))):
        terms = [t for t in (a[j] if j < len(a) else None, b[j] if j < len(b) else None, carry) if t is not None]
        if len(terms) == 3:
            x, y, z = terms
            out.append(x ^ y ^ z)
            carry = (x & y) | (z & (x ^ y))
        elif len(terms) == 2:
            x, y = terms
            out.append(x ^ y)
            carry = x & y
        else:
            out.append(terms[0])
            carry = None
    if carry is not None:
        out.append(carry)
    return out


def tree_sum_planes(planes: list) -> list:
    """Planes [R, 2, m, W] (m a power of two) summed over their axis 2 by a
    carry-save adder tree (log2(m) levels of ``add_planes``, the axis
    halving at each): planes [R, 2, W], one more per level."""
    m = planes[0].shape[2]
    while m > 1:
        m //= 2
        planes = add_planes([p[:, :, :m] for p in planes], [p[:, :, m:] for p in planes])
    return [p[:, :, 0, :] for p in planes]


def chunked_codes(reads: torch.Tensor, lengths: torch.Tensor, k: int, chunk: int = WINDOW_CHUNK):
    """(codes int64 [R, 2, n_pad], n_valid int64 [R], wc): the window codes
    zero-padded to a multiple of the chunk ``wc`` (a power of two, at most
    ``chunk``, at least 2) and each read's count of valid windows."""
    n = reads.shape[1] - k + 1
    wc = min(chunk, 1 << max(n - 1, 1).bit_length())
    codes = torch.nn.functional.pad(kmer_codes(reads, k), (0, -(-n // wc) * wc - n))
    return codes, torch.clamp(lengths.to(torch.int64) - (k - 1), min=0), wc


def _counts_chunked(bits, reads, lengths, *, k, h, rows, scheme, accum) -> torch.Tensor:
    """The ripple and tree routes: windows in chunks of ``wc`` (a power of
    two, at most WINDOW_CHUNK), each chunk's masked membership words folded
    into the planes one window at a time (ripple), or summed by a
    carry-save adder tree over the chunk and added once (tree)."""
    R, L = reads.shape
    W = bits.shape[1]
    n_planes = max(int(L - k + 1).bit_length(), 1)
    codes, n_valid, wc = chunked_codes(reads, lengths, k)
    planes = [torch.zeros((R, 2, W), dtype=torch.int32, device=reads.device) for _ in range(n_planes)]
    for base in range(0, codes.shape[2], wc):
        anded = _gather_and(bits, codes[:, :, base : base + wc], n_valid, base, h=h, rows=rows, scheme=scheme)
        if accum == "ripple":
            for s in range(wc):
                carry = anded[:, :, s, :]
                for j in range(n_planes):
                    planes[j], carry = planes[j] ^ carry, planes[j] & carry
            continue
        planes = add_planes(planes, tree_sum_planes([anded]))[:n_planes]
        planes += [torch.zeros_like(planes[0]) for _ in range(n_planes - len(planes))]
    # [R, 2, P, W] -> K1's [2R, P, W] layout, then to integers once
    return expand_planes(torch.stack(planes, dim=2).reshape(2 * R, n_planes, W)).reshape(R, 2, W * 32)


def counts(
    bits: torch.Tensor,
    reads: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    h: int,
    rows: int,
    scheme: str = "rbt1",
    accum: str = "k1",
) -> torch.Tensor:
    """Per-bin window-match counts, int32 [R, 2, W*32].

    ``accum`` picks how the windows' membership words are summed: "k1"
    (the engine's route through kernel K1; the JAX package's "pallas"), or
    the JAX package's XLA routes "ripple" and "tree", step for step its
    ``_counts_impl``.  All three give the same counts.
    """
    if accum not in ACCUMS:
        raise ValueError(f"accum must be one of {ACCUMS}, got {accum!r}")
    if accum != "k1":
        return _counts_chunked(bits, reads, lengths, k=k, h=h, rows=rows, scheme=scheme, accum=accum)
    R = reads.shape[0]
    planes = counts_planes(bits, reads, lengths, k=k, h=h, rows=rows, scheme=scheme)
    return expand_planes(planes).reshape(R, 2, -1)


def max_counts(
    cnt: torch.Tensor,  # i32 [R, 2, B]
    thresholds: torch.Tensor,  # [R], values in [0, 65535]
    bin_mask: torch.Tensor,  # bool [B]
    *,
    segments: tuple[tuple[int, int], ...],
) -> torch.Tensor:
    """Per-filter max over declared bins of max(fwd, rc) where fwd or rc
    reaches the threshold; int32 [R, F]."""
    thr = thresholds.to(torch.int32)[:, None]
    fwd, rc = cnt[:, 0, :], cnt[:, 1, :]
    matched = ((fwd >= thr) | (rc >= thr)) & bin_mask[None, :]
    cand = torch.where(matched, torch.maximum(fwd, rc), torch.zeros_like(fwd))
    return torch.stack(
        [cand[:, off : off + padded].amax(dim=1) for off, padded in segments], dim=1
    )
