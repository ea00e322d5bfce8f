"""K4 (``accumulate_counts``, the v1 per-bin count accumulation): the
port's plain version against the JAX package's Pallas kernel in
interpret mode on the same seeded membership words (fewer than 8 words,
zero-padded windows, several blocks on every axis); the padding contract
both raise on; and the v1 layout, reshaped, against the port's K1-route
``counts`` of the same reads.

On the CPU the wrapper runs its plain version; the CUDA kernel itself
runs only on a card, where tests/test_torch_gpu_counts.py compares the
two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readbouncer_tpu.ops.ibf_count_pallas import accumulate_counts_pallas
from readbouncer_tpu_torch.ibf.build import build_ibf_records
from readbouncer_tpu_torch.ibf.hashing import encode_bases
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.query import anded_windows, counts
from readbouncer_tpu_torch.ops import ibf_count as ops

torch.set_num_threads(1)

U32 = np.uint32


def _words(rng, shape, n_real=None):
    """ANDed-looking random words; windows from n_real on are zero."""
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(U32)
    a &= rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(U32)
    if n_real is not None:
        a[:, n_real:, :] = 0
    return a


@pytest.mark.parametrize(
    "shape,n_real",
    [((3, 32, 24), None), ((8, 128, 64), 100), ((16, 256, 1024), 238)],
    ids=["w_below_8", "padded_windows", "two_blocks_each_axis"],
)
def test_accumulate_counts_plain_matches_pallas(shape, n_real):
    a = _words(np.random.default_rng(sum(shape)), shape, n_real)
    want = np.asarray(accumulate_counts_pallas(jnp.asarray(a), interpret=True))
    got = ops.accumulate_counts(torch.from_numpy(a.view(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (shape[0], 32, shape[2])
    np.testing.assert_array_equal(got.numpy(), want)
    bits = (a[:, :, None, :] >> np.arange(32, dtype=U32)[None, None, :, None]) & 1
    np.testing.assert_array_equal(got.numpy(), bits.sum(axis=1))


@pytest.mark.parametrize("shape", [(12, 128, 64), (8, 200, 64), (8, 128, 700)],
                         ids=["words", "windows", "lanes"])
def test_bad_padding_raises_as_the_reference(shape):
    a = np.zeros(shape, dtype=U32)
    with pytest.raises(ValueError, match="bad padding"):
        accumulate_counts_pallas(jnp.asarray(a), interpret=True)
    with pytest.raises(ValueError, match="bad padding"):
        ops.accumulate_counts(torch.from_numpy(a.view(np.int32)))


def test_v1_layout_equals_k1_route_counts():
    rng = np.random.default_rng(4)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 6000))
    ibf, _ = build_ibf_records([("g", genome)], IBFParams(fragment_length=2000), name="g", device="cpu")
    bits = torch.from_numpy(ibf.bits.view(np.int32))
    R, L, k = 12, 150, 13
    reads = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    for r in range(0, R, 2):
        s = int(rng.integers(0, len(genome) - L))
        reads[r] = encode_bases(genome[s : s + L])
    lens = rng.integers(k - 1, L + 1, size=R).astype(np.int32)
    reads_t, lens_t = torch.from_numpy(reads), torch.from_numpy(lens)
    kw = dict(k=k, h=ibf.hash_functions, rows=ibf.rows, scheme=ibf.scheme)
    anded = anded_windows(bits, reads_t, lens_t, **kw)
    n_pad = ops.counts_v1_n_pad(L - k + 1)
    assert n_pad == 256
    out = ops.accumulate_counts(ops.counts_v1_input(anded, n_pad))
    want = counts(bits, reads_t, lens_t, **kw)
    assert int(want.max()) > 0
    assert torch.equal(ops.counts_from_v1(out), want)


def test_cpu_tensors_take_plain_version_without_counting():
    before = ops.accumulate_counts.launches
    out = ops.accumulate_counts(torch.full((2, 4, 6), -1, dtype=torch.int32))
    assert bool((out == 4).all())
    assert ops.accumulate_counts.launches == before
