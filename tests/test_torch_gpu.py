"""Card-only tests: the CUDA kernels K1 and K2 against their plain
versions (K2 also on the edge cases that tests/test_torch_dual_max_bitsliced.py
holds its bit-sliced algorithm to on the CPU), and the classify engine on
the card against the same engine on the CPU.  Each test skips inside its body where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=. python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from readbouncer_tpu_torch.classify.engine import ClassifyEngine
from readbouncer_tpu_torch.ibf.build import build_ibf_records
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ops import ibf_count as ops

torch.set_num_threads(1)


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _membership(rng, R2, n, W):
    a = rng.integers(0, 2**32, size=(R2, n, W), dtype=np.uint64).astype(np.uint32)
    a &= rng.integers(0, 2**32, size=(R2, n, W), dtype=np.uint64).astype(np.uint32)
    a[rng.random((R2, n, W)) < 0.5] = 0
    return torch.from_numpy(a.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("R2,n,W", [(6, 100, 3), (2048, 238, 72), (7, 1, 5), (8, 3000, 2)])
def test_accumulate_planes_kernel_matches_plain(R2, n, W):
    dev = _cuda_or_skip()
    a = _membership(np.random.default_rng(R2 + n), R2, n, W).to(dev)
    P = max(int(n).bit_length(), 1)
    before = ops.accumulate_planes.launches
    got = ops.accumulate_planes(a, P)
    torch.cuda.synchronize()
    assert ops.accumulate_planes.launches == before + 1
    assert torch.equal(got, ops.accumulate_planes_plain(a, P))


# segments of 1, 18, 40 and 2 words; the last has no declared bin
EDGE_SEGMENTS = ((0, 32), (32, 576), (608, 1280), (1888, 64))


def dual_max_edge_case(P: int, seed: int):
    """K2 inputs that reach every branch of its bit-sliced algorithm: per
    read, thresholds of -3, 0, 1, 2^P - 1, 2^P, 2^P + 5 or random; rc equal
    to fwd (ties) on a whole read or half its words; a read whose counts are
    all 0; segments of 1, 18 and 40 words and one with no declared bin.
    Returns (planes, thr_b, thr_r, mask_words, segments) on the CPU."""
    rng = np.random.default_rng(seed)
    R, W = 16, 61
    top = 1 << P
    # each row's counts below its own cap, a fifth of them 0, 1 or 2, and
    # in reads 0-7 a few at 2^P - 2 or 2^P - 1: thresholds meet counts, and
    # the segment maxima of reads 8-15 spread over the range
    shape = (2 * R, W * 32)
    cnt = rng.integers(0, rng.integers(1, top + 1, size=(2 * R, 1)), size=shape)
    cnt = np.where(rng.random(shape) < 0.2, rng.integers(0, min(3, top), size=shape), cnt)
    high = top - 1 - rng.integers(0, min(2, top), size=(R, W * 32))
    cnt[:R] = np.where(rng.random((R, W * 32)) < 0.01, high, cnt[:R])
    cnt[1:8:2] = cnt[0:8:2]  # reads 0-3: rc == fwd everywhere
    cnt[9, ::2] = cnt[8, ::2]  # read 4: ties on every other bin
    cnt[10:12] = 0  # read 5: every count 0
    bits = (cnt[:, None, :] >> np.arange(P)[None, :, None]) & 1  # [2R, P, W*32]
    planes = (bits.reshape(2 * R, P, W, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=3).astype(np.uint32)
    mask = np.zeros(W * 32, dtype=bool)
    mask[0:21] = True
    mask[32:544] = True
    mask[608:1888] = rng.random(1280) < 0.9
    edges = np.array([-3, 0, 1, top - 1, top, top + 5], dtype=np.int64)
    thr_b = rng.integers(0, top + 1, size=R)
    thr_r = rng.integers(0, top + 1, size=R)
    thr_b[: len(edges)] = edges
    thr_r[len(edges) : 2 * len(edges)] = edges
    thr_r[5] = 0  # all-zero counts still match: the max is 0
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return (
        as_i32(planes), torch.from_numpy(thr_b.astype(np.int32)), torch.from_numpy(thr_r.astype(np.int32)),
        as_i32(ops.pack_bin_mask(mask)), EDGE_SEGMENTS,
    )


def _dual_max_matches_plain(planes, thr_b, thr_r, words, segments):
    before = ops.planes_dual_max.launches
    mb, mr = ops.planes_dual_max(planes, thr_b, thr_r, words, segments)
    torch.cuda.synchronize()
    assert ops.planes_dual_max.launches == before + 1
    pb, pr = ops.planes_dual_max_plain(planes, thr_b, thr_r, words, segments)
    assert torch.equal(mb, pb) and torch.equal(mr, pr)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [8, 9, 16])
def test_planes_dual_max_kernel_matches_plain(P):
    """Bit-equal to the plain version: the edge cases of dual_max_edge_case
    at P planes (9: the live shape), and random planes at the bench
    geometry (W=72, four 18-word segments) for R = 1, 1023, 3072."""
    dev = _cuda_or_skip()
    _dual_max_matches_plain(*[t.to(dev) for t in dual_max_edge_case(P, P)[:4]], EDGE_SEGMENTS)
    rng = np.random.default_rng(P)
    W = 72
    segments = ((0, 576), (576, 576), (1152, 576), (1728, 576))
    mask = np.zeros(W * 32, dtype=bool)
    for off, _ in segments:
        mask[off : off + 512] = True
    words = torch.from_numpy(ops.pack_bin_mask(mask).view(np.int32)).to(dev)
    for R in (1, 1023, 3072):
        planes = torch.from_numpy(
            rng.integers(0, 2**32, size=(2 * R, P, W), dtype=np.uint64).astype(np.uint32).view(np.int32)
        ).to(dev)
        thr_b = torch.from_numpy(rng.integers(0, (1 << P) + 45, size=R).astype(np.int32)).to(dev)
        thr_b[0] = 0
        thr_r = torch.clamp(thr_b - 5, min=0)
        _dual_max_matches_plain(planes, thr_b, thr_r, words, segments)


@pytest.mark.gpu
def test_engine_on_the_card_matches_the_cpu():
    dev = _cuda_or_skip()
    rng = np.random.default_rng(5)
    genomes = ["".join("ACGT"[i] for i in rng.integers(0, 4, 6000)) for _ in range(3)]
    params = IBFParams(fragment_length=2000)
    filters = [
        build_ibf_records([(f"g{i}", g)], params, name=f"g{i}", device=dev)[0]
        for i, g in enumerate(genomes)
    ]
    cpu_filters = [
        build_ibf_records([(f"g{i}", g)], params, name=f"g{i}", device="cpu")[0]
        for i, g in enumerate(genomes)
    ]
    for a, b in zip(filters, cpu_filters):
        np.testing.assert_array_equal(a.bits, b.bits)
    seqs = []
    for i in range(200):
        g = genomes[i % 3]
        s = int(rng.integers(0, len(g) - 900))
        seqs.append(g[s : s + int(rng.integers(250, 900))] if i % 4 else
                    "".join("ACGT"[j] for j in rng.integers(0, 4, 700)))
    kw = dict(error_rate=0.1, chunk_length=250, max_chunks=3, batch_size=64)
    before = (ops.accumulate_planes.launches, ops.planes_dual_max.launches)
    got = ClassifyEngine(filters[:2], filters[2:], device=dev, **kw).classify_sequences(seqs)
    assert ops.accumulate_planes.launches > before[0] and ops.planes_dual_max.launches > before[1]
    want = ClassifyEngine(cpu_filters[:2], cpu_filters[2:], device="cpu", **kw).classify_sequences(seqs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
