"""Kernels K1, K2 and K4 of the IBF query: wrappers, plain versions, helpers.

Counterpart of readbouncer_tpu/ops/ibf_count_pallas.py.  Each wrapper
validates its operands, then

* on CPU tensors runs the plain PyTorch version of the same function;
* on CUDA tensors launches the CUDA C++ kernel of ``csrc/ibf_count.cu``
  (built and bound by ``ops/_build.py``), and raises if it cannot.

There is no fallback from the kernel to the plain version.  Each wrapper
carries a launch counter (``accumulate_planes.launches``,
``planes_dual_max.launches``, ``accumulate_counts.launches``) that goes
up by one per kernel launch and nowhere else.

Bit planes: plane j of row r2 holds bit j of the per-bin count, 32 bins
per word — bit p of word w is bin ``w*32 + p``.  Words travel as int32
tensors read as uint32 in CUDA.

K4 is the v1 accumulation, which the main path no longer takes (K1 and
K2 replaced it) and ``tools/profile_realistic.py`` times: membership
words laid out [W, n_pad, 2R] (read-strands on the fastest axis) to
int32 counts [W, 32, 2R], where bin b of read r, strand s is at
``[b // 32, b % 32, 2*r + s]``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = [
    "MAX_PLANES",
    "MAX_SEGMENTS",
    "accumulate_planes",
    "accumulate_planes_plain",
    "planes_dual_max",
    "planes_dual_max_plain",
    "expand_planes",
    "pack_bin_mask",
    "COUNTS_BLOCKS",
    "accumulate_counts",
    "accumulate_counts_plain",
    "counts_v1_n_pad",
    "counts_v1_input",
    "counts_from_v1",
]

MAX_PLANES = 16  # K1 keeps the planes in registers (one template per P)
MAX_SEGMENTS = 32  # K2 takes the segment table as a by-value kernel argument
# K4's padding contract: the Pallas kernel's (word, window, read-strand)
# blocks, each cut to the axis when the axis is smaller
COUNTS_BLOCKS = (8, 128, 512)


def _check_int32(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.int32 or t.dim() != ndim:
        raise ValueError(f"{name} must be an int32 tensor of {ndim} dims, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on unsupported device {t.device}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, what: str, library: str = "ibf_count") -> None:
    if err != 0:
        from readbouncer_tpu_torch.ops._build import error_string

        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({error_string(err, library)})")


# --------------------------------------------------------------------- K1


def accumulate_planes(a: torch.Tensor, n_planes: int) -> torch.Tensor:
    """a int32 [R2, n, W] membership words -> int32 [R2, n_planes, W] planes.

    Counts, per read-strand row and bin, the windows whose word has the
    bin's bit set.  Exact while ``2**n_planes > n``; the wrapper requires
    that and ``n_planes <= MAX_PLANES``.  Replaces the Pallas
    ``_planes_kernel`` (accumulate_planes_pallas), which also needs its
    windows zero-padded to a block multiple; here no padding is needed.
    """
    _check_int32("a", a, 3)
    R2, n, W = a.shape
    if not 1 <= n_planes <= MAX_PLANES:
        raise ValueError(f"n_planes must be in [1, {MAX_PLANES}], got {n_planes}")
    if (1 << n_planes) <= n:
        raise ValueError(f"{n_planes} planes cannot count {n} windows exactly")
    if a.device.type == "cpu":
        return accumulate_planes_plain(a, n_planes)
    out = torch.empty((R2, n_planes, W), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out.zero_()
    from readbouncer_tpu_torch.ops._build import load_library

    lib = load_library("ibf_count").lib
    with torch.cuda.device(a.device):
        err = lib.rb_accumulate_planes(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            R2, n, W, n_planes, _stream(a),
        )
    _raise_on(err, "accumulate_planes")
    accumulate_planes.launches += 1
    return out


accumulate_planes.launches = 0


def accumulate_planes_plain(a: torch.Tensor, n_planes: int) -> torch.Tensor:
    """Plain version of K1: a ripple-carry add of each window's word into
    the planes (mod 2**n_planes), one window at a time."""
    R2, n, W = a.shape
    planes = [torch.zeros((R2, W), dtype=torch.int32, device=a.device) for _ in range(n_planes)]
    for i in range(n):
        carry = a[:, i, :]
        for j in range(n_planes):
            t = planes[j] & carry
            planes[j] = planes[j] ^ carry
            carry = t
    return torch.stack(planes, dim=1)


def expand_planes(planes: torch.Tensor) -> torch.Tensor:
    """[R2, P, W] packed planes -> [R2, W*32] int32 counts."""
    R2, P, W = planes.shape
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    cnt = torch.zeros((R2, W, 32), dtype=torch.int32, device=planes.device)
    for j in range(P):
        bit = (planes[:, j, :, None] >> shifts) & 1
        cnt += bit << j
    return cnt.reshape(R2, W * 32)


# --------------------------------------------------------------------- K2


def _segment_words(segments) -> list[tuple[int, int]]:
    words = []
    for off, padded in segments:
        if off % 32 or padded % 32:
            raise ValueError(f"segment ({off}, {padded}) not word-aligned")
        words.append((off // 32, padded // 32))
    return words


def planes_dual_max(
    planes: torch.Tensor,  # int32 [2R, P, W], rows 2r (fwd) and 2r+1 (rc)
    thr_b: torch.Tensor,  # int32 [R] base threshold per read
    thr_r: torch.Tensor,  # int32 [R] retry threshold per read
    mask_words: torch.Tensor,  # int32 [W] packed declared-bin mask
    segments,  # ((bin_offset, padded_bins), ...) — word-aligned
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-filter max matched counts at two thresholds, from bit planes.

    A bin matches when it is declared and its fwd OR rc count reaches the
    threshold; its candidate is max(fwd, rc); each filter's result is the
    max candidate over its segment (0 when none matches).  Returns
    (mb, mr), int32 [R, F].  Replaces the Pallas ``_dual_max_kernel``
    (planes_dual_max_pallas); unlike it, any R is accepted.
    """
    _check_int32("planes", planes, 3)
    R2, P, W = planes.shape
    if R2 % 2:
        raise ValueError(f"planes must hold fwd/rc row pairs, got {R2} rows")
    R = R2 // 2
    for name, t in (("thr_b", thr_b), ("thr_r", thr_r)):
        _check_int32(name, t, 1)
        if t.shape[0] != R:
            raise ValueError(f"{name} has {t.shape[0]} entries for {R} reads")
    _check_int32("mask_words", mask_words, 1)
    if mask_words.shape[0] != W:
        raise ValueError(f"mask_words has {mask_words.shape[0]} words, planes {W}")
    seg = _segment_words(segments)
    if not 1 <= len(seg) <= MAX_SEGMENTS:
        raise ValueError(f"need 1..{MAX_SEGMENTS} segments, got {len(seg)}")
    if any(w0 + nw > W for w0, nw in seg):
        raise ValueError(f"segments {segments} exceed {W} words")
    devs = {t.device for t in (planes, thr_b, thr_r, mask_words)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if planes.device.type == "cpu":
        return planes_dual_max_plain(planes, thr_b, thr_r, mask_words, segments)
    F = len(seg)
    mb = torch.empty((R, F), dtype=torch.int32, device=planes.device)
    mr = torch.empty_like(mb)
    if R == 0:
        return mb, mr
    from readbouncer_tpu_torch.ops._build import load_library

    table = (ctypes.c_int * (2 * F))(*[v for pair in seg for v in pair])
    lib = load_library("ibf_count").lib
    with torch.cuda.device(planes.device):
        err = lib.rb_planes_dual_max(
            ctypes.c_void_p(planes.data_ptr()), ctypes.c_void_p(thr_b.data_ptr()),
            ctypes.c_void_p(thr_r.data_ptr()), ctypes.c_void_p(mask_words.data_ptr()),
            ctypes.cast(table, ctypes.c_void_p), F,
            ctypes.c_void_p(mb.data_ptr()), ctypes.c_void_p(mr.data_ptr()),
            R, P, W, _stream(planes),
        )
    _raise_on(err, "planes_dual_max")
    planes_dual_max.launches += 1
    return mb, mr


planes_dual_max.launches = 0


def planes_dual_max_plain(planes, thr_b, thr_r, mask_words, segments):
    """Plain version of K2: expand the planes to counts, then one
    threshold pass per threshold and a max per segment."""
    R = planes.shape[0] // 2
    cnt = expand_planes(planes).reshape(R, 2, -1)
    fwd, rc = cnt[:, 0], cnt[:, 1]
    mx = torch.maximum(fwd, rc)
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    declared = (((mask_words[:, None] >> shifts) & 1) != 0).reshape(-1)
    outs = []
    for thr in (thr_b, thr_r):
        t = thr[:, None]
        matched = ((fwd >= t) | (rc >= t)) & declared[None, :]
        cand = torch.where(matched, mx, torch.zeros_like(mx))
        outs.append(
            torch.stack(
                [cand[:, w0 * 32 : (w0 + nw) * 32].amax(dim=1) for w0, nw in _segment_words(segments)],
                dim=1,
            )
        )
    return outs[0], outs[1]


def pack_bin_mask(bin_mask) -> np.ndarray:
    """bool [B] declared-bin mask -> uint32 [B//32] words (bit p of word w
    = bin w*32 + p), the mask_words operand of planes_dual_max."""
    m = np.asarray(bin_mask, dtype=bool)
    B = m.shape[0]
    if B % 32:
        raise ValueError(f"bin mask length {B} is not a multiple of 32")
    bits = m.reshape(B // 32, 32).astype(np.uint32)
    return (bits << np.arange(32, dtype=np.uint32)[None, :]).sum(axis=1, dtype=np.uint32)


# --------------------------------------------------------------------- K4


def accumulate_counts(a_t: torch.Tensor) -> torch.Tensor:
    """a_t int32 [W, n_pad, R2] membership words -> int32 [W, 32, R2] counts.

    ``counts[w, p, q]`` is the number of windows whose word ``a_t[w, :, q]``
    has bit p set.  Keeps the padding contract of the Pallas
    ``_count_kernel`` it replaces (accumulate_counts_pallas): each axis a
    multiple of its block in ``COUNTS_BLOCKS`` (or smaller than it), padded
    windows and lanes zero; ``ValueError`` otherwise.
    """
    _check_int32("a_t", a_t, 3)
    W, n_pad, R2 = a_t.shape
    blocks = [min(b, d) for b, d in zip(COUNTS_BLOCKS, a_t.shape)]
    if any(b == 0 or d % b for b, d in zip(blocks, a_t.shape)):
        raise ValueError(f"bad padding: {tuple(a_t.shape)} vs blocks {tuple(blocks)}")
    if a_t.device.type == "cpu":
        return accumulate_counts_plain(a_t)
    out = torch.empty((W, 32, R2), dtype=torch.int32, device=a_t.device)
    from readbouncer_tpu_torch.ops._build import load_library

    lib = load_library("ibf_count").lib
    with torch.cuda.device(a_t.device):
        err = lib.rb_accumulate_counts(
            ctypes.c_void_p(a_t.data_ptr()), ctypes.c_void_p(out.data_ptr()), W, n_pad, R2, _stream(a_t),
        )
    _raise_on(err, "accumulate_counts")
    accumulate_counts.launches += 1
    return out


accumulate_counts.launches = 0


def accumulate_counts_plain(a_t: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: one shift-mask-sum over the windows per bit."""
    return torch.stack([((a_t >> p) & 1).sum(dim=1, dtype=torch.int32) for p in range(32)], dim=1)


def counts_v1_n_pad(n: int) -> int:
    """Windows padded for K4 as the JAX package pads them: to a multiple
    of 128 above 128 windows, else to a power of two."""
    return -(-n // 128) * 128 if n > 128 else (1 << max(n - 1, 1).bit_length())


def counts_v1_input(anded: torch.Tensor, n_pad: int) -> torch.Tensor:
    """anded int32 [R, 2, n, W] -> K4's a_t int32 [W, n_pad, 2R], windows
    past n zero."""
    R, _, n, W = anded.shape
    a_t = torch.zeros((W, n_pad, 2 * R), dtype=torch.int32, device=anded.device)
    a_t[:, :n, :] = anded.reshape(2 * R, n, W).permute(2, 1, 0)
    return a_t


def counts_from_v1(out: torch.Tensor) -> torch.Tensor:
    """K4's int32 [W, 32, 2R] -> per-bin counts int32 [R, 2, W*32] (the
    K1 route's ``counts`` layout)."""
    W, _, R2 = out.shape
    return out.reshape(W * 32, R2).t().reshape(R2 // 2, 2, W * 32)
