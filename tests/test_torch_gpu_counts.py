"""Card-only tests: the CUDA kernels K4 (accumulate_counts) and K5
(xor_gather) against their plain versions on seeded inputs, and the
filter build and update on the card against the same on the CPU (an
update inserts from a bin offset that is not a multiple of 32).  Each
test skips inside its body where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=. python -m pytest tests/test_torch_gpu_counts.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from readbouncer_tpu_torch.ibf.build import build_ibf, update_ibf
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ops import gather
from readbouncer_tpu_torch.ops import ibf_count as ops

torch.set_num_threads(1)


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _words(rng, shape) -> torch.Tensor:
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    a &= rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 32, 24), (8, 128, 64), (72, 256, 4096)])
def test_accumulate_counts_kernel_matches_plain(shape):
    dev = _cuda_or_skip()
    a = _words(np.random.default_rng(sum(shape)), shape).to(dev)
    before = ops.accumulate_counts.launches
    got = ops.accumulate_counts(a)
    torch.cuda.synchronize()
    assert ops.accumulate_counts.launches == before + 1
    assert torch.equal(got, ops.accumulate_counts_plain(a))
    with pytest.raises(ValueError, match="bad padding"):
        ops.accumulate_counts(torch.zeros((12, 128, 64), dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "tab_shape,m,ch,nbuf",
    [
        ((1024, 8, 128), 512, 128, 4),  # the probe's --check shapes
        ((500, 3, 24), 1000, 100, 3),  # 18 vectors a slice: 14 groups, CH not a multiple
        ((300, 2, 8), 77, 1, 1),  # one index per block, one copy in flight
        ((64, 32, 128), 1536, 512, 12),  # 16 KiB slices, 1,024 threads, 192 KiB ring
    ],
    ids=["check", "odd_slice", "ch1_nbuf1", "wide_slice"],
)
def test_xor_gather_kernel_matches_plain(tab_shape, m, ch, nbuf):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(m + ch)
    tab = _words(rng, tab_shape).to(dev)
    idx = torch.from_numpy(rng.integers(0, tab_shape[0], size=m).astype(np.int32)).to(dev)
    before = gather.xor_gather.launches
    got = gather.xor_gather(tab, idx, ch, nbuf)
    torch.cuda.synchronize()
    assert gather.xor_gather.launches == before + 1
    assert torch.equal(got, gather.xor_gather_plain(tab, idx))
    # an index outside the table is an error for both; the kernel ran
    for fill in (tab_shape[0], -1):
        bad = idx.clone()
        bad[m // 2] = fill
        for fn in (lambda: gather.xor_gather(tab, bad, ch, nbuf), lambda: gather.xor_gather_plain(tab, bad)):
            with pytest.raises(IndexError, match="outside"):
                fn()
    assert gather.xor_gather.launches == before + 3
    # no indices: zeros, and no launch
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    assert torch.equal(gather.xor_gather(tab, empty, ch, nbuf), torch.zeros_like(got))
    # the entry point refuses what the kernel cannot run, and launches nothing
    for t, n in ((tab, 17), (torch.zeros((8, 3, 3), dtype=torch.int32, device=dev), nbuf)):
        with pytest.raises(RuntimeError, match="launch failed"):
            gather.xor_gather(t, idx % 8, ch, n)
    assert gather.xor_gather.launches == before + 3


@pytest.mark.gpu
def test_build_and_update_on_card_match_cpu(tmp_path):
    dev = _cuda_or_skip()
    rng = np.random.default_rng(37)
    seq = lambda n: "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    (tmp_path / "old.fasta").write_text(f">old\n{seq(7300)}\n")  # 37 bins of 200
    (tmp_path / "new.fasta").write_text(f">a\n{seq(5000)}\n>b\n{seq(2600)}\n")
    params = IBFParams(kmer_size=13, fragment_length=200)
    out = {}
    for where in ("cpu", dev):
        ibf, _ = build_ibf([tmp_path / "old.fasta"], params, name="old", device=where)
        assert ibf.num_bins == 37
        built = ibf.bits.copy()
        ibf, stats = update_ibf(ibf, [tmp_path / "new.fasta"], params, device=where)
        out[str(where)] = (built, ibf, stats)
    (b_cpu, u_cpu, s_cpu), (b_gpu, u_gpu, s_gpu) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(b_gpu, b_cpu)
    np.testing.assert_array_equal(u_gpu.bits, u_cpu.bits)
    assert u_gpu.num_bins == u_cpu.num_bins == 37 + s_cpu.new_bins
    assert u_gpu.bin_seqids == u_cpu.bin_seqids
    np.testing.assert_array_equal(u_gpu.bin_ranges, u_cpu.bin_ranges)
