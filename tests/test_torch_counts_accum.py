"""The port's three count routes against the JAX package's.

``readbouncer_tpu_torch.ibf.query.counts`` with ``accum="ripple"``,
``"tree"`` and its default ``"k1"`` (kernel K1's plain version on CPU
tensors) against ``readbouncer_tpu.ibf.query._counts_impl`` with the same
route (``"pallas"`` for K1, run in interpret mode on the CPU), on the
same numpy-seeded inputs: int32 counts, bit-equal (tolerance 0).  The
cases cover n not a power of two, more than one 128-window chunk, short
and zero lengths, W of 1 and 3 words and both hash schemes.
``add_planes`` is bit-equal to ``_add_planes`` on ragged plane lists.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readbouncer_tpu.ibf.query import _add_planes, _counts_impl
from readbouncer_tpu_torch.ibf import query as tq

torch.set_num_threads(1)

# (reads R, read length L, words W, k, rows, scheme): n = L - k + 1 is
# 36 (not a power of two), 138 (two chunks of 128), 18, and 1
CASES = [
    (3, 40, 1, 5, 997, "rbt1"),
    (4, 150, 3, 13, 1001, "rbt1"),
    (3, 30, 3, 13, 800, "rbt2"),
    (2, 13, 1, 13, 64, "rbt1"),
]
JAX_ROUTE = {"ripple": "ripple", "tree": "tree", "k1": "pallas"}


def _inputs(rng, R, L, W, rows):
    bits = rng.integers(0, 1 << 32, size=(rows, W), dtype=np.uint32)
    reads = rng.integers(0, 5, size=(R, L)).astype(np.uint8)  # 4 = N
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    lengths[0] = L
    lengths[-1] = 0 if R > 2 else 7  # zero, or shorter than k
    return bits, reads, lengths


@pytest.mark.parametrize("accum", ["ripple", "tree", "k1"])
def test_counts_route_is_bit_equal_to_jax(accum):
    rng = np.random.default_rng(11)
    for R, L, W, k, rows, scheme in CASES:
        bits, reads, lengths = _inputs(rng, R, L, W, rows)
        want = np.asarray(_counts_impl(bits, reads, lengths, k=k, h=3, rows=rows, scheme=scheme,
                                       accum=JAX_ROUTE[accum]))
        got = tq.counts(torch.from_numpy(bits.view(np.int32)), torch.from_numpy(reads), torch.from_numpy(lengths),
                        k=k, h=3, rows=rows, scheme=scheme, accum=accum)
        assert got.dtype == torch.int32 and tuple(got.shape) == (R, 2, W * 32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{accum} at {(R, L, W, k, rows, scheme)}")


def test_routes_agree_with_each_other_on_one_hash():
    """h=1 (no AND) and all reads full length: the three routes agree."""
    rng = np.random.default_rng(12)
    bits = torch.from_numpy(rng.integers(0, 1 << 32, size=(509, 2), dtype=np.uint32).view(np.int32))
    reads = torch.from_numpy(rng.integers(0, 4, size=(5, 300)).astype(np.uint8))
    lengths = torch.full((5,), 300, dtype=torch.int32)
    outs = [tq.counts(bits, reads, lengths, k=13, h=1, rows=509, accum=a) for a in tq.ACCUMS]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_add_planes_is_bit_equal_on_ragged_lists():
    rng = np.random.default_rng(13)
    for la, lb in ((3, 1), (1, 4), (2, 2), (0, 3), (5, 0)):
        a = [rng.integers(0, 1 << 32, size=(4, 3), dtype=np.uint32) for _ in range(la)]
        b = [rng.integers(0, 1 << 32, size=(4, 3), dtype=np.uint32) for _ in range(lb)]
        want = _add_planes([jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b])
        got = tq.add_planes([torch.from_numpy(x.view(np.int32)) for x in a],
                            [torch.from_numpy(x.view(np.int32)) for x in b])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))


def test_unknown_route_raises():
    z = torch.zeros((8, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="accum"):
        tq.counts(z, torch.zeros((1, 20), dtype=torch.uint8), torch.zeros(1, dtype=torch.int32),
                  k=5, h=1, rows=8, accum="pallas")
