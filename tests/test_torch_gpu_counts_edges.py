"""Card-only tests: K4 (accumulate_counts) and K5 (xor_gather) against
their plain versions on edge cases, the same ones that
tests/test_torch_counts_gather_algorithms.py holds the kernels'
algorithms to on the CPU (``counts_edge_cases``, ``gather_edge_cases``).

K4: all-ones words at n_pad 32, 128, 256 and 384 (counts reach n_pad and
pass 255), all zeros, one set bit, random words (also at n_pad 100 and
61, whose chunks end in a partial group of 8); on the card also R2 not
a multiple of 4 (the kernel's scalar path) and n_pad = 1024 with dense
words (counts past 2^9, and more than one segment of 1,020 windows).
K5: every index equal with M even (result 0) and odd; every slice hit
exactly twice (result 0); N = 1; N = 33 (a bitmap word boundary); the
index N - 1; random.  Each test skips inside its body where there is no
card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=. python -m pytest tests/test_torch_gpu_counts_edges.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from readbouncer_tpu_torch.ops import gather
from readbouncer_tpu_torch.ops import ibf_count as ops

torch.set_num_threads(1)

U32 = np.uint32


def _random_words(rng, shape, dense: bool = False) -> np.ndarray:
    """AND (sparse, ~1/4 of the bits) or OR (dense, ~3/4) of two draws."""
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(U32)
    b = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(U32)
    return (a | b) if dense else (a & b)


def counts_edge_cases(kind: str) -> list[tuple[str, torch.Tensor]]:
    """K4 inputs a_t int32 [W, n_pad, R2] on the CPU, named, for one kind:
    "ones", "zeros", "one_bit", "random" (run on the CPU and the card), and
    "r2_not_4", "past_2_9" (the card's extra shapes)."""
    rng = np.random.default_rng(["ones", "zeros", "one_bit", "random", "r2_not_4", "past_2_9"].index(kind))
    cases = []
    if kind == "ones":
        for n_pad in (32, 128, 256, 384):
            cases.append((f"ones n_pad={n_pad}", np.full((2, n_pad, 8), 0xFFFFFFFF, dtype=U32)))
    elif kind == "zeros":
        cases.append(("zeros", np.zeros((3, 256, 24), dtype=U32)))
    elif kind == "one_bit":
        for n_pad, (w, i, q, p) in ((128, (3, 127, 19, 31)), (256, (0, 0, 0, 0)), (384, (1, 255, 6, 17))):
            a = np.zeros((4, n_pad, 20), dtype=U32)
            a[w, i, q] = U32(1) << U32(p)
            cases.append((f"one bit n_pad={n_pad} at {(w, i, q, p)}", a))
    elif kind == "random":
        cases.append(("random (8, 384, 64)", _random_words(rng, (8, 384, 64))))
        cases.append(("random (3, 256, 24), windows from 238 zero", _random_words(rng, (3, 256, 24))))
        cases[-1][1][:, 238:, :] = 0
        # chunks of 25 and 16 / 13 windows: each ends in a partial group of 8
        cases.append(("random (2, 100, 12)", _random_words(rng, (2, 100, 12), dense=True)))
        cases.append(("random (4, 61, 8)", _random_words(rng, (4, 61, 8), dense=True)))
    elif kind == "r2_not_4":
        cases.append(("random (5, 96, 30)", _random_words(rng, (5, 96, 30))))
        cases.append(("ones (5, 96, 30)", np.full((5, 96, 30), 0xFFFFFFFF, dtype=U32)))
    elif kind == "past_2_9":
        cases.append(("dense (8, 1024, 512)", _random_words(rng, (8, 1024, 512), dense=True)))
    else:
        raise ValueError(kind)
    return [(name, torch.from_numpy(a.view(np.int32))) for name, a in cases]


def gather_edge_cases() -> list[tuple[str, torch.Tensor, torch.Tensor]]:
    """K5 inputs (name, tab int32 [N, BR, WD], idx int32 [M]) on the CPU."""
    rng = np.random.default_rng(5)

    def tab(n, br=2, wd=8):
        return torch.from_numpy(rng.integers(0, 2**32, size=(n, br, wd), dtype=np.uint64).astype(U32).view(np.int32))

    def idx(values):
        return torch.from_numpy(np.asarray(values, dtype=np.int32))

    cases = [
        ("same index, M even", tab(40), idx([17] * 64)),
        ("same index, M odd", tab(40), idx([17] * 63)),
        ("every slice twice", tab(70), idx(rng.permutation(np.repeat(np.arange(70), 2)))),
        ("N = 1", tab(1, 1, 4), idx([0] * 37)),
        ("N = 33", tab(33), idx(rng.permutation([31, 32, 32, 0, 31, 5, 32, 32, 32, 31] * 3))),
        ("index N - 1", tab(97, 3, 4), idx(np.concatenate([[96] * 5, rng.integers(0, 97, 45)]))),
        ("random", tab(500, 4, 32), idx(rng.integers(0, 500, 1200))),
    ]
    return cases


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ones", "zeros", "one_bit", "random", "r2_not_4", "past_2_9"])
def test_accumulate_counts_kernel_edge_cases(kind):
    dev = _cuda_or_skip()
    for name, a in counts_edge_cases(kind):
        want = ops.accumulate_counts_plain(a)
        before = ops.accumulate_counts.launches
        got = ops.accumulate_counts(a.to(dev))
        torch.cuda.synchronize()
        assert ops.accumulate_counts.launches == before + 1
        assert torch.equal(got.cpu(), want), name
        if kind == "ones":
            assert int(want.max()) == a.shape[1], name
        if kind == "past_2_9":
            assert int(want.max()) > 512, name
    # a view at an odd word offset is not 16-byte aligned: the scalar path
    a = counts_edge_cases("random")[0][1]
    flat = torch.zeros(a.numel() + 1, dtype=torch.int32)
    flat[1:] = a.reshape(-1)
    shifted = flat.to(dev)[1:].view(a.shape)
    assert torch.equal(ops.accumulate_counts(shifted).cpu(), ops.accumulate_counts_plain(a))


@pytest.mark.gpu
@pytest.mark.parametrize("nbuf", [1, 8])
def test_xor_gather_kernel_edge_cases(nbuf):
    dev = _cuda_or_skip()
    for name, tab, idx in gather_edge_cases():
        want = gather.xor_gather_plain(tab, idx)
        m = idx.numel()
        for ch in (1, m):
            before = gather.xor_gather.launches
            got = gather.xor_gather(tab.to(dev), idx.to(dev), ch, nbuf)
            torch.cuda.synchronize()
            assert gather.xor_gather.launches == before + 1
            assert torch.equal(got.cpu(), want), (name, ch)
        if name in ("same index, M even", "every slice twice"):
            assert not want.any(), name
