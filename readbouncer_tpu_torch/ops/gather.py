"""Kernel K5, the gather probe: wrapper and plain version.

Counterpart of ``dma_gather`` in scripts/dma_gather_probe.py, which
streams the slices of a table through an NBUF-deep ring of async copies
and XORs them together.  ``xor_gather`` validates its operands, then

* on CPU tensors runs ``xor_gather_plain`` (``tab[idx]`` and a XOR fold);
* on CUDA tensors calls the entry point of ``csrc/gather_probe.cu`` (built
  and bound by ``ops/_build.py``), and raises if it cannot.  Since XOR
  cancels pairs, the entry point reads only the slices hit an odd number
  of times: three kernels per call (a parity bitmap of the indices, the
  list of its set bits, the gather and XOR of the listed slices).

There is no fallback from the kernel to the plain version.
``xor_gather.launches`` goes up by one per call that launches the
kernels, and nowhere else.
Words travel as int32 tensors read as uint32 in CUDA.
"""

from __future__ import annotations

import ctypes

import torch

from readbouncer_tpu_torch.ops.ibf_count import _raise_on, _stream

__all__ = ["xor_gather", "xor_gather_plain"]


def xor_gather(tab: torch.Tensor, idx: torch.Tensor, ch: int, nbuf: int, *, check: bool = True) -> torch.Tensor:
    """XOR of ``tab[idx[j]]`` over every j: tab int32 [N, BR, WD], idx int32
    [M] -> int32 [BR, WD].

    M must be a multiple of ``ch``, as ``dma_gather`` asserts; on the card
    each block of the gather takes at most ``ch`` entries of the odd-hit
    list, and ``nbuf`` slices are in flight per thread.  The kernels' own
    limits (a slice of a multiple of 4 words, at most 4,096; 1 <= nbuf <=
    16; the ring within a block's shared memory) are checked by the entry
    point, which then launches nothing.

    An index outside [0, N) raises ``IndexError``, as in the plain
    version.  On the card that takes reading back the kernel's error word,
    one synchronisation: ``check=False`` leaves it out, for a timed loop
    over indices that a checked call has already passed.
    """
    if tab.dtype != torch.int32 or tab.dim() != 3 or not tab.is_contiguous():
        raise ValueError(f"tab must be a contiguous int32 [N, BR, WD] tensor, got {tab.dtype} {tuple(tab.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous int32 [M] tensor, got {idx.dtype} {tuple(idx.shape)}")
    if tab.device != idx.device or tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tab on {tab.device}, idx on {idx.device}")
    N, BR, WD = tab.shape
    S, M = BR * WD, idx.shape[0]
    if ch < 1 or M % ch:
        raise ValueError(f"M={M} is not a multiple of CH={ch}")
    if tab.device.type == "cpu":
        return xor_gather_plain(tab, idx)
    if M == 0:
        return torch.zeros((BR, WD), dtype=tab.dtype, device=tab.device)
    # the result, the error word, the odd-hit count, the parity bitmap;
    # then the odd-hit list, which min(M, N) bounds
    buf = torch.zeros(S + 2 + -(-N // 32), dtype=torch.int32, device=tab.device)
    odd = torch.empty(max(min(M, N), 1), dtype=torch.int32, device=tab.device)
    out = buf[:S].view(BR, WD)
    from readbouncer_tpu_torch.ops._build import load_library

    lib = load_library("gather_probe").lib
    with torch.cuda.device(tab.device):
        err = lib.rb_xor_gather(
            ctypes.c_void_p(tab.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
            ctypes.c_void_p(buf.data_ptr()), ctypes.c_void_p(odd.data_ptr()), N, S, M, ch, nbuf,
            _stream(tab),
        )
    _raise_on(err, "xor_gather", "gather_probe")
    xor_gather.launches += 1
    if check and int(buf[S]):
        raise IndexError(f"an index of idx lies outside [0, {N})")
    return out


xor_gather.launches = 0


def xor_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: gather the slices, then fold them with XOR
    (halving the stack each step)."""
    n = tab.shape[0]
    if idx.numel() and not bool(((idx >= 0) & (idx < n)).all()):
        raise IndexError(f"an index of idx lies outside [0, {n})")
    g = tab[idx.long()]
    if g.shape[0] == 0:
        return torch.zeros(tab.shape[1:], dtype=tab.dtype, device=tab.device)
    while g.shape[0] > 1:
        half = g.shape[0] // 2
        folded = g[:half] ^ g[half : 2 * half]
        g = torch.cat([folded, g[2 * half :]]) if g.shape[0] % 2 else folded
    return g[0]
