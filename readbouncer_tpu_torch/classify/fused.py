"""Whole-read classification on the device — the torch counterpart of
readbouncer_tpu/classify/fused.py.

Every chunk of every read in a batch is scored in one pass and the
"first chunk that classifies wins" reduction runs on the device, with
decisions identical to the reference's chunk loop
(src/main/classify.hpp:262-299): a classified read's later chunks are
discarded.  PyTorch runs eagerly, so where the JAX package builds jitted
programs per shape, this module has plain functions over tensors.

* the per-read result word (classified, attempts, best target);
* threshold tables (host float64, looked up on the device);
* device ports of the classify decision policy;
* ``stack_dual_max``: counts once (K1), per-filter maxima at both
  thresholds (K2);
* ``plan_stacks``: target and deplete stacks merged into one;
* ``FusedClassifier``: the batch body, reads -> (classified, best,
  attempts);
* the upload path's packings: ``pack4_np`` (2 bits a base, ACGT only)
  and ``pack5_np`` (base 243, three bases a byte) on the host, copied
  from the JAX package as the plain versions of the native
  ``pack_codes``, and their inverses ``unpack4`` / ``unpack5`` on the
  device;
* ``PackedClassifier`` (a batch's rows of one packed pool, unpacked on
  the device) and ``IndexedClassifier`` (phase-B rows gathered on the
  device from a base-243 pool of every read's later chunks);
* ``live_decisions`` and ``LiveFused``: the live loop's check_unblock for
  a batch of reads of one bucket width, reads (unpacked or base-243)
  -> 0/1/2 decisions.

The JAX package unpacks in ``jnp`` outside its Pallas kernels; here the
unpacking and the row gather are plain torch operations on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from readbouncer_tpu_torch.classify.math import ci_and_threshold_batch
from readbouncer_tpu_torch.ibf.query import FilterStack, counts_planes
from readbouncer_tpu_torch.ops.ibf_count import planes_dual_max

__all__ = [
    "pack5_np",
    "pack4_np",
    "unpack5",
    "unpack4",
    "packed_bytes_per_read",
    "pack_results",
    "unpack_results_np",
    "threshold_table",
    "best_filter_index",
    "classify_decisions",
    "live_decisions",
    "stack_dual_max",
    "plan_stacks",
    "FusedClassifier",
    "PackedClassifier",
    "IndexedClassifier",
    "LiveFused",
]


def pack5_np(enc: np.ndarray) -> np.ndarray:
    """Pack base codes (u8 in 0..4) 3-per-byte: byte = c0 + 5*c1 + 25*c2.

    DNA over the Dna5 alphabet is 5 symbols = log2(5) = 2.32 bits/base;
    base-243 packing hits 2.67 bits/base with a trivial decode on the
    device.  A copy of the JAX package's function: the plain version of
    the native ``pack_codes(codes, "base243")``.
    """
    R, L = enc.shape
    P = -(-L // 3)
    if L % 3:
        enc = np.pad(enc, ((0, 0), (0, 3 * P - L)))
    e = enc.reshape(R, P, 3).astype(np.uint16)
    return (e[:, :, 0] + 5 * e[:, :, 1] + 25 * e[:, :, 2]).astype(np.uint8)


def pack4_np(enc: np.ndarray) -> np.ndarray:
    """Pack PURE-ACGT base codes (u8 in 0..3) 4-per-byte (2 bits/base).

    25% fewer bytes than base-243; only valid when the codes hold no N
    (code 4): the engine checks per host batch and falls back to
    base 243.  A copy of the JAX package's function: the plain version of
    the native ``pack_codes(codes, "2bit")``.
    """
    R, L = enc.shape
    P = -(-L // 4)
    if L % 4:
        enc = np.pad(enc, ((0, 0), (0, 4 * P - L)))
    e = enc.reshape(R, P, 4).astype(np.uint8)
    return e[:, :, 0] | (e[:, :, 1] << 2) | (e[:, :, 2] << 4) | (e[:, :, 3] << 6)


def unpack5(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Device inverse of pack5_np: [R, P] u8 -> [R, length] u8 codes
    (``unpack5_jnp``'s digit order)."""
    parts = torch.stack([packed % 5, (packed // 5) % 5, packed // 25], dim=-1)
    return parts.reshape(packed.shape[0], -1)[:, :length]


def unpack4(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Device inverse of pack4_np: [R, P] u8 -> [R, length] u8 codes
    (``unpack4_jnp``'s digit order)."""
    parts = torch.stack([packed & 3, (packed >> 2) & 3, (packed >> 4) & 3, packed >> 6], dim=-1)
    return parts.reshape(packed.shape[0], -1)[:, :length]


def packed_bytes_per_read(length: int, packing: str) -> int:
    """Pool row bytes for one read of ``length`` bases under ``packing``."""
    if packing == "2bit":
        return -(-length // 4)
    if packing == "base243":
        return -(-length // 3)
    raise ValueError(f"unknown packing {packing!r}")


# result word: bit 0 classified, bits 1-8 attempts, bits 9+ best_target+1
def pack_results(classified, best, attempts) -> torch.Tensor:
    return (
        classified.to(torch.int32)
        + (attempts.to(torch.int32) << 1)
        + ((best.to(torch.int32) + 1) << 9)
    )


def unpack_results_np(res: np.ndarray):
    """Host inverse of pack_results -> (classified, best, attempts)."""
    res = np.asarray(res)
    return (res & 1).astype(bool), (res >> 9) - 1, (res >> 1) & 0xFF


def threshold_table(
    max_len: int, kmer_size: int, error_rate: float, significance: float
) -> np.ndarray:
    """uint32[max_len+1] effective uint16-wrapped thresholds per length
    (host float64, bit-identical to classify/math.py)."""
    lens = np.arange(max_len + 1, dtype=np.int64)
    return ci_and_threshold_batch(lens, kmer_size, error_rate, significance)


def best_filter_index(cnt: torch.Tensor) -> torch.Tensor:
    """First-max argmax per row; -1 where the max is 0 (policy.py port)."""
    best = torch.argmax(cnt, dim=1)
    return torch.where(cnt.amax(dim=1) > 0, best, torch.full_like(best, -1))


def classify_decisions(t_base, d_base, t_retry, d_retry):
    """Device port of policy.classify_decisions (same None semantics);
    returns (classified [R] bool, best [R] int64)."""
    have_t = t_base is not None and t_base.shape[1] > 0
    have_d = d_base is not None and d_base.shape[1] > 0
    if have_t and have_d:
        tmax, dmax = t_base.amax(dim=1), d_base.amax(dim=1)
        tmax2, dmax2 = t_retry.amax(dim=1), d_retry.amax(dim=1)
        both = (tmax > 0) & (dmax > 0)
        retry_ok = (tmax2 > 0) & (dmax2 == 0)
        classified = ((tmax > 0) & (dmax == 0)) | (both & retry_ok)
        best = best_filter_index(t_base)
        best = torch.where(classified, best, torch.full_like(best, -1))
        return classified & (best >= 0), best
    if have_d:
        dbest = best_filter_index(d_base)
        return dbest > -1, torch.full_like(dbest, -1)
    if have_t:
        best = best_filter_index(t_base)
        return best != -1, best
    raise ValueError("no filters provided")


def live_decisions(d_base, t_base, d_retry, t_retry) -> torch.Tensor:
    """Device port of the reference's policy.live_decisions: int32 [R] decisions,
    0 continue / 1 unblock / 2 stop_receiving (None or 0-wide = no filters
    of that kind)."""
    have_t = t_base is not None and t_base.shape[1] > 0
    have_d = d_base is not None and d_base.shape[1] > 0
    if have_t and have_d:
        dmax, tmax = d_base.amax(dim=1), t_base.amax(dim=1)
        dmax2, tmax2 = d_retry.amax(dim=1), t_retry.amax(dim=1)
        out = torch.zeros(dmax.shape[0], dtype=torch.int32, device=dmax.device)
        out = torch.where((dmax > 0) & (tmax == 0), 1, out)
        both = (dmax > 0) & (tmax > 0)
        out = torch.where(both & (dmax2 > 0) & (tmax2 == 0), 1, out)
        out = torch.where((dmax == 0) & (tmax > 0), 2, out)
        return out.to(torch.int32)
    if have_d:
        return (d_base.amax(dim=1) > 0).to(torch.int32)
    if have_t:
        return torch.where(t_base.amax(dim=1) > 0, 2, 1).to(torch.int32)
    raise ValueError("no filters provided")


def _threshold_tabs(targets, depletes, max_len, error_rate, significance, device):
    """int32 threshold tables by chunk length at the base and retry rates:
    keys tb, tr (targets) and db, dr (depletes)."""
    tabs = {}
    for name, stack in (("t", targets), ("d", depletes)):
        if stack is None:
            continue
        for suffix, rate in (("b", error_rate), ("r", error_rate - 0.02)):
            tab = threshold_table(max_len, stack.kmer_size, rate, significance)
            tabs[name + suffix] = torch.from_numpy(tab.astype(np.int32)).to(device)
    return tabs


def _dual_maxima(targets, depletes, plan, frags, lens, tabs):
    """(t_b, d_b, t_r, d_r) per-filter maxima of one batch, through the
    merged stack where the plan has one (one K1 and one K2 launch)."""
    combined, n_targets = plan
    t_b = t_r = d_b = d_r = None
    if combined is not None:
        mb, mr = stack_dual_max(combined, frags, lens, tabs["tb"], tabs["tr"])
        return mb[:, :n_targets], mb[:, n_targets:], mr[:, :n_targets], mr[:, n_targets:]
    if targets is not None:
        t_b, t_r = stack_dual_max(targets, frags, lens, tabs["tb"], tabs["tr"])
    if depletes is not None:
        d_b, d_r = stack_dual_max(depletes, frags, lens, tabs["db"], tabs["dr"])
    return t_b, d_b, t_r, d_r


def stack_dual_max(stack: FilterStack, frags, lens, tab_base, tab_retry):
    """Counts once, per-filter maxima at both threshold tables.

    frags [R, cl] u8 and lens [R] on the stack's device; tab_* int32
    threshold tables indexed by chunk length.  The planes come from K1
    and go straight into K2 on every batch shape (K2 masks a ragged read
    block itself); on CPU tensors the wrappers run their plain versions.
    Returns (mb, mr) int32 [R, F].
    """
    lens = lens.to(torch.int64)
    thr_b = tab_base.index_select(0, lens).contiguous()
    thr_r = tab_retry.index_select(0, lens).contiguous()
    planes = counts_planes(
        stack.bits, frags, lens,
        k=stack.kmer_size, h=stack.hash_functions, rows=stack.rows, scheme=stack.scheme,
    )
    return planes_dual_max(planes, thr_b, thr_r, stack.mask_words, stack.seg_spec)


def plan_stacks(targets: FilterStack | None, depletes: FilterStack | None):
    """(merged stack, number of target filters), or (None, 0) when the two
    kinds cannot share hash rows.  One gather pass then serves both kinds
    (the reference fans out per-filter tasks,
    src/IBF/IBFClassify.cpp:256-259, 315-341)."""
    if targets is None or depletes is None:
        return None, 0
    if (targets.kmer_size, targets.hash_functions, targets.rows, targets.scheme) != (
        depletes.kmer_size, depletes.hash_functions, depletes.rows, depletes.scheme
    ):
        return None, 0
    return FilterStack.concat(targets, depletes), targets.num_filters


class FusedClassifier:
    """Whole-read classifier for ``max_chunks``-wide reads.

    ``__call__(reads [R, C*cl] u8, lengths [R] i32)`` -> (classified [R]
    bool, best_target [R] int64, attempts [R] int32), all on the device.
    ``attempt_offset`` shifts the reported chunk indices: the two-phase
    engine scores chunk 0 of every read, then the remaining chunks of
    unresolved reads (classify/engine.py).
    """

    def __init__(
        self,
        targets: FilterStack | None,
        depletes: FilterStack | None,
        chunk_length: int,
        max_chunks: int,
        error_rate: float,
        significance: float,
        attempt_offset: int = 0,
        plan=None,
    ):
        self.targets, self.depletes = targets, depletes
        self.cl, self.C = chunk_length, max_chunks
        self.attempt_offset = attempt_offset
        self.plan = plan if plan is not None else plan_stacks(targets, depletes)
        dev = (targets or depletes).device
        self.tabs = _threshold_tabs(targets, depletes, chunk_length, error_rate, significance, dev)

    def __call__(self, reads: torch.Tensor, lengths: torch.Tensor):
        cl, C = self.cl, self.C
        R = reads.shape[0]
        frags = reads.reshape(R * C, cl)
        steps = torch.arange(C, device=reads.device, dtype=torch.int64) * cl
        clens = torch.clamp(lengths.to(torch.int64)[:, None] - steps[None, :], 0, cl)
        lens_flat = clens.reshape(-1)
        t_b, d_b, t_r, d_r = _dual_maxima(
            self.targets, self.depletes, self.plan, frags, lens_flat, self.tabs
        )
        ok_flat, best_flat = classify_decisions(t_b, d_b, t_r, d_r)
        ok = ok_flat.reshape(R, C)
        best = best_flat.reshape(R, C)
        first = torch.argmax(ok.to(torch.int32), dim=1)  # first classified chunk
        classified = ok.any(dim=1)
        best_read = torch.gather(best, 1, first[:, None])[:, 0]
        avail = (clens > 0).sum(dim=1)
        off = self.attempt_offset
        attempts = torch.where(classified, first + 1 + off, avail + off).to(torch.int32)
        best_read = torch.where(classified, best_read, torch.full_like(best_read, -1))
        return classified, best_read, attempts


class PackedClassifier:
    """Pool-input variant of ``FusedClassifier`` (the JAX package's
    make_fused_classify_packed_fn): the engine uploads one packed pool
    per phase (``pack4_np`` / ``pack5_np`` rows of ``C*cl`` codes) and
    each call scores one batch of its rows.

    ``__call__(pool [N, P] u8, lens_pool [N] i32, start)`` unpacks rows
    ``start .. start+batch_size`` on the device and returns (result words
    [B] int32 (``pack_results``), pending [B] bool): pending marks the
    reads left unresolved that have chunks past these ``C`` (lengths over
    ``C*cl``), the engine's phase-B candidates.  The last batch of a pool
    may be shorter: eager PyTorch needs no fixed shape, so pools are not
    padded.
    """

    def __init__(self, fused: FusedClassifier, batch_size: int, packing: str = "base243"):
        if packing not in ("2bit", "base243"):
            raise ValueError(f"unknown packing {packing!r}")
        self.fused, self.batch_size, self.packing = fused, batch_size, packing
        self.unpack = unpack4 if packing == "2bit" else unpack5

    def __call__(self, pool: torch.Tensor, lens_pool: torch.Tensor, start: int):
        f = self.fused
        width = f.C * f.cl
        lens = lens_pool[start : start + self.batch_size]
        reads = self.unpack(pool[start : start + self.batch_size], width)
        classified, best, attempts = f(reads, lens)
        return pack_results(classified, best, attempts), ~classified & (lens > width)


class IndexedClassifier:
    """Gather-by-index variant of ``PackedClassifier`` for phase B (the
    JAX package's make_fused_classify_indexed_fn).  With ``overlap_pool``
    the engine uploads a base-243 pool of chunks 1..C-1 of every read
    while phase A runs, and phase B sends only the indices of its reads.

    ``__call__(pool [N, P] u8, lens_pool [N] i32, idx [U] i32, start)``
    picks rows ``idx[start .. start+batch_size]`` of the pool and of the
    phase-B lengths (``max(len - cl, 0)``) on the device, unpacks the
    first ``C*cl`` codes of each (a pool row holds all ``(C_max-1)*cl``)
    and scores them.  Returns (result words [B] int32, pending [B] bool,
    all false: phase B scores every chunk left).  The JAX package keeps
    the pool as little-endian uint32 words and bitcasts them back, a TPU
    layout; a uint8 [N, P] tensor gives the same rows.
    """

    def __init__(self, fused: FusedClassifier, batch_size: int):
        self.fused, self.batch_size = fused, batch_size

    def __call__(self, pool: torch.Tensor, lens_pool: torch.Tensor, idx: torch.Tensor, start: int):
        f = self.fused
        sel = idx[start : start + self.batch_size]
        lens = lens_pool.index_select(0, sel)
        reads = unpack5(pool.index_select(0, sel), f.C * f.cl)
        classified, best, attempts = f(reads, lens)
        return pack_results(classified, best, attempts), torch.zeros_like(classified)


class LiveFused:
    """The live check_unblock for one bucket width (the reference's
    make_fused_live_fn): ``__call__(reads [R, max_seq_len] u8, lengths
    [R])`` -> int32 [R] decisions on the device, through K1 -> K2 on the
    merged stack where ``plan`` has one.  Thresholds come from tables at
    ``error_rate`` and ``error_rate - 0.02``; lengths are clipped to
    ``max_seq_len``.  With ``packed=True`` the reads come base-243 packed,
    [R, ceil(max_seq_len / 3)] (``pack5_np``), and are unpacked on the
    device first: a third of the bytes to upload."""

    def __init__(
        self,
        targets: FilterStack | None,
        depletes: FilterStack | None,
        max_seq_len: int,
        error_rate: float,
        significance: float,
        packed: bool = False,
        plan=None,
    ):
        self.targets, self.depletes = targets, depletes
        self.max_seq_len = max_seq_len
        self.packed = packed
        self.plan = plan if plan is not None else plan_stacks(targets, depletes)
        dev = (targets or depletes).device
        self.tabs = _threshold_tabs(targets, depletes, max_seq_len, error_rate, significance, dev)

    def __call__(self, reads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if self.packed:
            reads = unpack5(reads, self.max_seq_len)
        lens = torch.clamp(lengths.to(torch.int64), max=self.max_seq_len)
        t_b, d_b, t_r, d_r = _dual_maxima(self.targets, self.depletes, self.plan, reads, lens, self.tabs)
        return live_decisions(d_b, t_b, d_r, t_r)
