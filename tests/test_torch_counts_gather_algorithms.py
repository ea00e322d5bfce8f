"""K4's and K5's card algorithms on the CPU.

The CUDA kernels of ``accumulate_counts`` (ops/csrc/ibf_count.cu) and
``xor_gather`` (ops/csrc/gather_probe.cu) run only on a card, so the
functions below do their word operations in PyTorch (int64 words masked
to 32 bits) and are held bit-equal to the port's plain versions on the
edge cases the card tests hold the kernels to
(tests/test_torch_gpu_counts_edges.py), and once each to the JAX
package's Pallas kernel in interpret mode.

* K4: per column, the window axis is cut into segments of at most 1,020
  windows and each segment into 4 contiguous chunks (<= 255 windows); a
  chunk's words are folded 8 at a time into 8 bit planes by Harley-Seal
  carry-save adders, whose weight-8 carry ripples into planes 3-7; the 4
  chunks' planes are added bit-sliced in a butterfly (8 -> 9 -> 10
  planes), expanded to 32 counts, and the segments' counts added.
* K5: a parity bitmap of the indices (``np.bitwise_xor.at``: one XOR per
  index into word i >> 5, as the kernel's atomicXor), the list of its set
  bits appended warp by warp after a scan of 32 words' popcounts, the list
  dealt evenly over the gather's blocks, and the XOR of the listed slices.
"""

import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_gpu_counts_edges import counts_edge_cases, gather_edge_cases

from readbouncer_tpu.ops.ibf_count_pallas import accumulate_counts_pallas
from readbouncer_tpu_torch.ops import gather
from readbouncer_tpu_torch.ops import ibf_count as ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ONES = 0xFFFFFFFF
CHUNKS, PLANES = 4, 8  # the kernel's RB_COUNTS_CHUNKS, RB_COUNTS_PLANES
SEGMENT = CHUNKS * ((1 << PLANES) - 1)  # 1,020 windows


def _xor3(a, b, c):
    return a ^ b ^ c


def _maj3(a, b, c):
    return (a & b) | (c & (a ^ b))


def _fold8(p: list, x: list) -> None:
    """Harley-Seal: 8 words [cols] into the planes p[0..PLANES), in place;
    a carry out of the top plane is dropped, as in the kernel."""

    def csa(a, b, c):
        return _maj3(a, b, c), _xor3(a, b, c)  # (hi, lo)

    twos_a, p[0] = csa(p[0], x[0], x[1])
    twos_b, p[0] = csa(p[0], x[2], x[3])
    fours_a, p[1] = csa(p[1], twos_a, twos_b)
    twos_a, p[0] = csa(p[0], x[4], x[5])
    twos_b, p[0] = csa(p[0], x[6], x[7])
    fours_b, p[1] = csa(p[1], twos_a, twos_b)
    eights, p[2] = csa(p[2], fours_a, fours_b)
    for j in range(3, PLANES):
        p[j], eights = p[j] ^ eights, p[j] & eights


def _add_planes(a: list, b: list) -> list:
    """Bit-sliced ripple-carry sum of two counters: len(a) + 1 planes."""
    carry = torch.zeros_like(a[0])
    out = []
    for x, y in zip(a, b):
        out.append(_xor3(x, y, carry))
        carry = _maj3(x, y, carry)
    return out + [carry]


def _expand(planes: list) -> torch.Tensor:
    """Planes [cols] -> counts [32, cols]."""
    return torch.stack([sum(((t >> k) & 1) << j for j, t in enumerate(planes)) for k in range(32)])


def bitsliced_counts(a_t: torch.Tensor) -> torch.Tensor:
    """K4's word operations: same result as ``accumulate_counts_plain``."""
    W, n_pad, R2 = a_t.shape
    words = (a_t.to(torch.int64) & ONES).permute(1, 0, 2).reshape(n_pad, W * R2)
    total = torch.zeros((32, W * R2), dtype=torch.int64)
    for s0 in range(0, n_pad, SEGMENT):
        seg = min(SEGMENT, n_pad - s0)
        L = -(-seg // CHUNKS)
        lanes = []
        for c in range(CHUNKS):
            chunk = words[s0 + min(c * L, seg) : s0 + min((c + 1) * L, seg)]
            p = [torch.zeros(W * R2, dtype=torch.int64) for _ in range(PLANES)]
            for g in range(0, chunk.shape[0], 8):
                x = list(chunk[g : g + 8])
                x += [torch.zeros(W * R2, dtype=torch.int64)] * (8 - len(x))  # a partial group adds 0
                _fold8(p, x)
            lanes.append(p)
        t9 = [_add_planes(lanes[c], lanes[c ^ 1]) for c in range(CHUNKS)]  # butterfly, lane ^ 1
        t10 = [_add_planes(t9[c], t9[c ^ 2]) for c in range(CHUNKS)]  # then lane ^ 2
        assert all(all(torch.equal(x, y) for x, y in zip(t10[0], t)) for t in t10)  # every lane holds it
        total += _expand(t10[0])  # the segments' atomicAdd
    return total.reshape(32, W, R2).permute(1, 0, 2).to(torch.int32).contiguous()


def bitsliced_xor_gather(tab: torch.Tensor, idx: torch.Tensor, ch: int, fill: int = 7) -> torch.Tensor:
    """K5's three kernels: same result as ``xor_gather_plain``.  ``fill``
    stands for the card's one full wave of gather blocks."""
    N, M = tab.shape[0], idx.numel()
    i = idx.numpy().astype(np.int64)
    if ((i < 0) | (i >= N)).any():  # the error word
        raise IndexError(f"an index of idx lies outside [0, {N})")
    bitmap = np.zeros(-(-N // 32), dtype=np.uint32)
    np.bitwise_xor.at(bitmap, i >> 5, (np.uint32(1) << (i & 31).astype(np.uint32)))  # parity
    words = torch.from_numpy(bitmap.astype(np.int64))
    # compact: per warp of 32 words, an inclusive scan of the popcounts and
    # one append at the counter
    odd, count = [], 0
    for k0 in range(0, words.numel(), 32):
        w = words[k0 : k0 + 32]
        pops = torch.tensor([bin(int(x)).count("1") for x in w])
        incl = torch.cumsum(pops, 0)
        base = count
        count += int(incl[-1])
        for lane, x in enumerate(w.tolist()):
            pos = base + int(incl[lane] - pops[lane])
            for b in range(32):
                if x >> b & 1:
                    odd.append((pos, ((k0 + lane) << 5) | b))
                    pos += 1
    lst = [s for _, s in sorted(odd)]
    assert len(lst) == count
    cap = min(M, N)
    blocks = min(cap, max(-(-cap // ch), fill))
    slices = tab.reshape(N, -1).to(torch.int64) & ONES
    acc = torch.zeros(slices.shape[1], dtype=torch.int64)
    for b in range(blocks):
        lo, hi = b * count // blocks, (b + 1) * count // blocks
        assert hi - lo <= ch
        part = torch.zeros_like(acc)
        for s in lst[lo:hi]:
            part ^= slices[s]
        acc ^= part  # the block's atomicXor
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32).reshape(tab.shape[1:])


@pytest.mark.parametrize("kind", ["ones", "zeros", "one_bit", "random"])
def test_bitsliced_counts_match_plain_on_edge_cases(kind):
    for name, a in counts_edge_cases(kind):
        want = ops.accumulate_counts_plain(a)
        assert torch.equal(bitsliced_counts(a), want), name
        if kind == "ones":
            assert int(want.max()) == a.shape[1], name


def test_bitsliced_counts_match_pallas_past_one_segment():
    """Once against the Pallas kernel in interpret mode, on dense words at
    n_pad = 1024 (two segments, counts past 2^9)."""
    a = counts_edge_cases("past_2_9")[0][1][:2, :, :64].contiguous()
    want = np.asarray(accumulate_counts_pallas(jnp.asarray(a.numpy().view(np.uint32)), interpret=True))
    got = bitsliced_counts(a)
    assert int(got.max()) > 512
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ops.accumulate_counts_plain(a))


def test_bitsliced_xor_gather_matches_plain_on_edge_cases():
    for name, tab, idx in gather_edge_cases():
        want = gather.xor_gather_plain(tab, idx)
        for ch in (1, idx.numel()):
            assert torch.equal(bitsliced_xor_gather(tab, idx, ch), want), (name, ch)
        if name in ("same index, M even", "every slice twice"):
            assert not want.any(), name
    tab, idx = gather_edge_cases()[0][1:]
    bad = idx.clone()
    bad[3] = tab.shape[0]
    with pytest.raises(IndexError, match="outside"):
        bitsliced_xor_gather(tab, bad, 1)


def test_bitsliced_xor_gather_matches_pallas_dma_gather():
    """Once against scripts/dma_gather_probe.py's dma_gather under TPU
    interpret mode, at the probe's --check shapes."""
    saved_env, saved_path = dict(os.environ), list(sys.path)
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import dma_gather_probe as probe
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        sys.path[:] = saved_path
    rng = np.random.default_rng(8)
    n_blocks, m, ch, nbuf = 1024, 512, 128, 4
    tab = rng.integers(0, 2**32, size=(n_blocks, 8, 128), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, n_blocks, size=m).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(probe.dma_gather(jnp.asarray(tab), jnp.asarray(idx), ch, nbuf))
    got = bitsliced_xor_gather(torch.from_numpy(tab.view(np.int32)), torch.from_numpy(idx), ch)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
