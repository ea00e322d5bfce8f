"""IBF construction on the device: references -> fragments -> bit matrix.

The torch counterpart of readbouncer_tpu/ibf/build.py, with the same
semantics (N-run removal with the reference's final-segment truncation,
fragment bounds with a k-1 overlap, declared bin count
``len // fragment_length + 1`` per sequence, forward k-mers only;
reference: src/IBF/IBFBuild.cpp:16-204,223-321,404-521).  The JAX
package's hot loop is a C++ scatter-OR (or numpy); here every window of
a sequence is hashed at once on the device and its bits set in a bool
[rows, bins] table, which is packed to uint32 words and ORed into the
filter at the end.  The table takes one byte per bit of the bins it
covers: 0.71 GB for one 512-bin bench filter (1,236,269 rows x 576
padded bins).  ``update_ibf`` covers only the words from the first new
bin on.  ``insert_sequence`` is the JAX package's numpy scatter-OR of
one fragment, the host oracle of the device build.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.errors import BinCapacityError
from readbouncer_tpu_torch.fastio.fasta import read_records
from readbouncer_tpu_torch.ibf.hashing import POW5, encode_bases, hash_rows_np, kmer_codes_np
from readbouncer_tpu_torch.ibf.params import IBFParams, optimal_bins
from readbouncer_tpu_torch.ibf.query import hash_rows_all
from readbouncer_tpu_torch.ibf.storage import IBFData

__all__ = [
    "BuildStats", "cut_out_nnns", "fragment_bounds", "insert_sequence", "build_ibf_records", "build_ibf",
    "update_ibf",
]


@dataclass
class BuildStats:
    """Mirror of the reference's FilterStats (src/IBF/IBF.hpp:51-79)."""

    sum_seq_len: int = 0
    total_seqs_file: int = 0
    total_bins_declared: int = 0
    total_bins_inserted: int = 0
    invalid_seqs: int = 0
    new_bins: int = 0
    filter_size_bits: int = 0
    build_seconds: float = 0.0


def cut_out_nnns(seq: str) -> str:
    """Remove N-runs; the final segment loses its last character, as in
    the reference (src/IBF/IBFBuild.cpp:112-132)."""
    seqlen = len(seq)
    out: list[str] = []
    start = 0
    while True:
        while start < seqlen and seq[start] == "N":
            start += 1
        if start >= seqlen:
            break
        end = seq.find("N", start)
        if end == -1:
            out.append(seq[start : start + (seqlen - start - 1)])
            break
        out.append(seq[start:end])
        start = end
    return "".join(out)


def fragment_bounds(seqlen: int, fragment_length: int, kmer_size: int) -> list[tuple[int, int]]:
    """(start, end) of every inserted fragment (src/IBF/IBFBuild.cpp:165-204)."""
    bounds: list[tuple[int, int]] = []
    frag_idx = 0
    fragstart = 0
    while fragstart < seqlen - 1:
        bounds.append((fragstart, min((frag_idx + 1) * fragment_length, seqlen)))
        frag_idx += 1
        fragstart = frag_idx * fragment_length - kmer_size + 1
    return bounds


def insert_sequence(ibf: IBFData, bases: np.ndarray, bin_id: int) -> None:
    """Insert every forward k-mer of an encoded fragment into *bin_id*, on
    the host (numpy).

    The reference inserts only forward-strand k-mers at build time;
    reverse complements are handled at query time as a second count pass
    (reference: src/IBF/IBFClassify.cpp:97-98).
    """
    fwd, _ = kmer_codes_np(bases, ibf.kmer_size)
    if fwd.size == 0:
        return
    rows = hash_rows_np(fwd, ibf.hash_functions, ibf.rows, scheme=ibf.scheme)  # [n, h]
    word = np.uint32(bin_id // 32)
    mask = np.uint32(1 << (bin_id % 32))
    flat = ibf.bits.reshape(-1)
    idx = rows.reshape(-1).astype(np.int64) * ibf.words + int(word)
    np.bitwise_or.at(flat, idx, mask)


def _forward_codes(bases: torch.Tensor, k: int) -> torch.Tensor:
    """Forward base-5 codes (u32 in int64) of every window of one sequence."""
    n = bases.shape[0] - k + 1
    b = bases.to(torch.int64)
    codes = torch.zeros(n, dtype=torch.int64, device=bases.device)
    for t in range(k):
        codes += b[t : t + n] * int(POW5[k - 1 - t])
    return codes & 0xFFFFFFFF


def _insert(table: torch.Tensor, bases: torch.Tensor, bounds, first_bin: int, params, rows: int):
    """Set the bits of every fragment's forward k-mers in ``table``
    (bool [rows, bins]); fragment i goes to column ``first_bin + i``."""
    k = params.kmer_size
    starts = torch.tensor([s for s, _ in bounds], dtype=torch.int64)
    n_win = torch.tensor([max(e - s - k + 1, 0) for s, e in bounds], dtype=torch.int64)
    total = int(n_win.sum())
    if total == 0:
        return
    dev = table.device
    codes = _forward_codes(bases, k)
    frag = torch.repeat_interleave(torch.arange(len(bounds)), n_win).to(dev)
    first = (torch.cumsum(n_win, 0) - n_win).to(dev)
    pos = starts.to(dev)[frag] + torch.arange(total, device=dev) - first[frag]
    win_codes = codes[pos]
    bins = frag + first_bin
    width = table.shape[1]
    flat = table.view(-1)
    for r in hash_rows_all(win_codes, params.hash_functions, rows, params.hash_scheme):
        flat[r * width + bins] = True


def _pack_words(table: torch.Tensor) -> np.ndarray:
    """bool [rows, B] -> uint32 [rows, B/32] (bit p of word w = bin w*32+p)."""
    rows, B = table.shape
    t = table.view(rows * (B // 32), 32)
    words = torch.zeros(t.shape[0], dtype=torch.int64, device=table.device)
    for j in range(32):
        words |= t[:, j].to(torch.int64) << j
    return words.reshape(rows, B // 32).cpu().numpy().astype(np.uint32)


@dataclass
class _ParsedRefs:
    seqids: list[str] = field(default_factory=list)
    cleaned: list[str] = field(default_factory=list)


def _parse_refs(records: Iterable[tuple[str, str]], params: IBFParams, stats: BuildStats) -> _ParsedRefs:
    """Clean the reference sequences and count the declared bins
    (reference: src/IBF/IBFBuild.cpp:16-104)."""
    out = _ParsedRefs()
    for rec_id, seq in records:
        stats.total_seqs_file += 1
        if len(seq) < params.kmer_size:
            stats.invalid_seqs += 1
            continue
        newseq = cut_out_nnns(seq)
        out.seqids.append(rec_id)
        out.cleaned.append(newseq)
        stats.total_bins_declared += len(newseq) // params.fragment_length + 1
        stats.sum_seq_len += len(newseq)
    return out


def _file_records(reference_files: Sequence[str | Path]) -> Iterable[tuple[str, str]]:
    for ref in reference_files:
        for rec in read_records(ref, first_word_id=True):
            yield rec.id, rec.seq


def _insert_all(
    ibf: IBFData, parsed: _ParsedRefs, params: IBFParams, stats: BuildStats, bin_offset: int, dev
) -> None:
    """Insert every fragment of ``parsed`` from bin ``bin_offset`` on.

    The bool table covers the words from ``bin_offset // 32`` to the end,
    so new bins go into the filter's existing words at a bit offset."""
    w0 = bin_offset // 32
    table = torch.zeros((ibf.rows, ibf.padded_bins - 32 * w0), dtype=torch.bool, device=dev)
    bin_id = bin_offset
    ranges: list[tuple[int, int]] = (
        list(map(tuple, ibf.bin_ranges.tolist())) if ibf.bin_ranges is not None else []
    )
    for seqid, seq in zip(parsed.seqids, parsed.cleaned):
        bounds = fragment_bounds(len(seq), params.fragment_length, params.kmer_size)
        if bin_id + len(bounds) > ibf.padded_bins:
            raise BinCapacityError(
                f"fragment count exceeded padded bin capacity ({ibf.padded_bins})"
            )
        if bounds:
            bases = torch.from_numpy(encode_bases(seq)).to(dev)
            _insert(table, bases, bounds, bin_id - 32 * w0, params, ibf.rows)
        ibf.bin_seqids += [seqid] * len(bounds)
        ranges += bounds
        bin_id += len(bounds)
    ibf.bits[:, w0:] |= _pack_words(table)
    ibf.bin_ranges = np.array(ranges, dtype=np.uint64) if ranges else None
    stats.total_bins_inserted = bin_id - bin_offset


def build_ibf_records(
    records: Iterable[tuple[str, str]],
    params: IBFParams,
    name: str = "",
    device=None,
) -> tuple[IBFData, BuildStats]:
    """Build a filter from (seqid, sequence) records on ``device``."""
    params.validate()
    dev = resolve_device(device)
    stats = BuildStats()
    t0 = time.monotonic()
    parsed = _parse_refs(records, params, stats)
    stats.filter_size_bits = params.rows * optimal_bins(stats.total_bins_declared)
    ibf = IBFData.empty(
        rows=params.rows,
        num_bins=stats.total_bins_declared,
        kmer_size=params.kmer_size,
        hash_functions=params.hash_functions,
        fragment_length=params.fragment_length,
        max_fp=params.max_fp,
        name=name,
        scheme=params.hash_scheme,
    )
    _insert_all(ibf, parsed, params, stats, 0, dev)
    stats.build_seconds = time.monotonic() - t0
    return ibf, stats


def build_ibf(
    reference_files: Sequence[str | Path],
    params: IBFParams,
    name: str = "",
    device=None,
) -> tuple[IBFData, BuildStats]:
    """Build a filter from FASTA/FASTQ files on ``device`` (reference:
    IBF::create_filter, src/IBF/IBFBuild.cpp:421-521)."""
    return build_ibf_records(_file_records(reference_files), params, name=name, device=device)


def update_ibf(
    ibf: IBFData,
    reference_files: Sequence[str | Path],
    params: IBFParams,
    device=None,
) -> tuple[IBFData, BuildStats]:
    """Append new references to an existing filter, in place.

    Mirrors IBF::update_filter (reference: src/IBF/IBFBuild.cpp:223-321):
    resize the bins to old + new, then insert the new fragments from the
    old declared bin count on.  The filter's own hash scheme governs.
    """
    params.validate()
    dev = resolve_device(device)
    if params.hash_scheme != ibf.scheme:
        params = replace(params, hash_scheme=ibf.scheme)
    stats = BuildStats()
    t0 = time.monotonic()
    old_bins = ibf.num_bins
    parsed = _parse_refs(_file_records(reference_files), params, stats)
    new_total = old_bins + stats.total_bins_declared
    if new_total > old_bins:
        ibf.resize_bins(new_total)
        stats.new_bins = stats.total_bins_declared
    _insert_all(ibf, parsed, params, stats, old_bins, dev)
    stats.total_bins_declared = new_total
    stats.filter_size_bits = ibf.total_bits
    stats.build_seconds = time.monotonic() - t0
    return ibf, stats
