"""K2's bit-sliced algorithm on the CPU.

The CUDA kernel of ``planes_dual_max`` (ops/csrc/ibf_count.cu) never
expands a count: it compares bit-sliced counters 32 bins per word
operation and finds each segment's max MSB first with warp votes.  It runs
only on a card, so ``bitsliced_dual_max`` below does the same word
operations in PyTorch (int64 words masked to 32 bits; where the kernel
votes across the 32 words of one warp pass, an "any" over the same 32
words; the max over passes), and is held bit-equal to the port's plain
version ``planes_dual_max_plain`` on the edge cases the card test holds
the kernel to (tests/test_torch_gpu.py::dual_max_edge_case), and once to
the JAX package's Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpu import EDGE_SEGMENTS, dual_max_edge_case

from readbouncer_tpu.ops.ibf_count_pallas import planes_dual_max_pallas
from readbouncer_tpu_torch.ops import ibf_count as ops

torch.set_num_threads(1)

ONES = 0xFFFFFFFF
PASS_WORDS = 32  # a warp's lanes: words per pass of the kernel's segment loop


def _ge_scalar(x: list[torch.Tensor], t: torch.Tensor) -> torch.Tensor:
    """Bins where the bit-sliced x (P words [R, n]) is >= t [R], MSB first."""
    P = len(x)
    gt = torch.zeros_like(x[0])
    eq = torch.full_like(x[0], ONES)
    for j in reversed(range(P)):
        tj = ((t[:, None] >> j) & 1) * ONES
        gt |= eq & x[j] & ~tj & ONES
        eq &= ~(x[j] ^ tj) & ONES
    ge = gt | eq
    ge = torch.where(t[:, None] <= 0, torch.full_like(ge, ONES), ge)
    return torch.where(t[:, None] >= (1 << P), torch.zeros_like(ge), ge)


def _masked_max(mx: list[torch.Tensor], M: torch.Tensor) -> torch.Tensor:
    """Per read, the max of bit-sliced mx over the bins in M [R, n]; an
    "any" over the n words stands for the warp vote."""
    res = torch.zeros(M.shape[0], dtype=torch.int64)
    for j in reversed(range(len(mx))):
        c = M & mx[j]
        hit = (c != 0).any(dim=1)
        M = torch.where(hit[:, None], c, M)
        res |= hit.to(torch.int64) << j
    return res


def bitsliced_dual_max(planes, thr_b, thr_r, mask_words, segments):
    """The kernel's word operations on whole tensors: same (mb, mr) as
    ``planes_dual_max_plain``."""
    R2, P, W = planes.shape
    words = planes.to(torch.int64) & ONES
    f = [words[0::2, j] for j in range(P)]  # [R, W] per plane
    r = [words[1::2, j] for j in range(P)]
    gt = torch.zeros_like(f[0])
    eq = torch.full_like(f[0], ONES)
    for j in reversed(range(P)):
        gt |= eq & f[j] & ~r[j] & ONES
        eq &= ~(f[j] ^ r[j]) & ONES
    sel = gt | eq  # fwd >= rc
    mx = [(f[j] & sel) | (r[j] & ~sel & ONES) for j in range(P)]
    mask = mask_words.to(torch.int64)[None, :] & ONES
    outs = []
    for thr in (thr_b, thr_r):
        t = thr.to(torch.int64)
        M = mask & (_ge_scalar(f, t) | _ge_scalar(r, t))
        cols = []
        for w0, nw in ops._segment_words(segments):
            best = torch.zeros(R2 // 2, dtype=torch.int64)
            for base in range(0, nw, PASS_WORDS):
                cut = slice(w0 + base, w0 + min(base + PASS_WORDS, nw))
                best = torch.maximum(best, _masked_max([m[:, cut] for m in mx], M[:, cut]))
            cols.append(best)
        outs.append(torch.stack(cols, dim=1).to(torch.int32))
    return outs[0], outs[1]


@pytest.mark.parametrize("P", [1, 8, 9, 16])
def test_bitsliced_matches_plain_on_edge_cases(P):
    """Thresholds <= 0, 1, 2^P - 1, 2^P and 2^P + 5; fwd == rc ties; a
    read of all-zero counts; segments of 1, 18 and 40 words (two passes)
    and one with no declared bin."""
    planes, thr_b, thr_r, words, segments = dual_max_edge_case(P, P)
    got_b, got_r = bitsliced_dual_max(planes, thr_b, thr_r, words, segments)
    want_b, want_r = ops.planes_dual_max_plain(planes, thr_b, thr_r, words, segments)
    assert torch.equal(got_b, want_b) and torch.equal(got_r, want_r)
    assert (want_b[:, 3] == 0).all() and (want_r[:, 3] == 0).all()  # no declared bin
    assert (want_b > 0).any()  # the cases are not all empty
    wrap_b, wrap_r = ops.planes_dual_max(planes, thr_b, thr_r, words, segments)
    assert torch.equal(wrap_b, want_b) and torch.equal(wrap_r, want_r)


def test_bitsliced_matches_pallas():
    """Once against the JAX package's Pallas kernel in interpret mode, at a
    small shape with thresholds the Pallas kernel takes (uint32, R % 8 = 0)."""
    P = 6
    planes, thr_b, thr_r, words, segments = dual_max_edge_case(P, 3)
    thr_b = thr_b.clamp(min=0)
    thr_r = thr_r.clamp(min=0)
    want_b, want_r = planes_dual_max_pallas(
        jnp.asarray(planes.numpy().view(np.uint32)), jnp.asarray(thr_b.numpy().astype(np.uint32)),
        jnp.asarray(thr_r.numpy().astype(np.uint32)), jnp.asarray(words.numpy().view(np.uint32)),
        EDGE_SEGMENTS, interpret=True, read_block=8,
    )
    got_b, got_r = bitsliced_dual_max(planes, thr_b, thr_r, words, segments)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
