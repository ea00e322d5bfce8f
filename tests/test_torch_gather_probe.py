"""K5 (``xor_gather``, the gather probe): the port's plain version against
the reference probe's Pallas ``dma_gather`` under TPU interpret mode at
the probe's ``--check`` shapes; the operand checks (M % CH as
``dma_gather`` asserts it, indices inside the table); and the two tools, the gather probe and the
realistic-geometry profile, run end to end on the CPU at tiny sizes.

On the CPU the wrapper runs its plain version; the CUDA kernel itself
runs only on a card, where tests/test_torch_gpu_counts.py compares the
two.
"""

import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from readbouncer_tpu_torch.ops import gather as ops
from readbouncer_tpu_torch.tools import dma_gather_probe, profile_realistic

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dma_gather():
    """scripts/dma_gather_probe.py's dma_gather; the probe imports its
    sibling _bench_util and sets JAX cache variables, which are put back."""
    saved_env, saved_path = dict(os.environ), list(sys.path)
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import dma_gather_probe as probe
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        sys.path[:] = saved_path
    return probe.dma_gather


def test_xor_gather_plain_matches_pallas_dma_gather(dma_gather):
    rng = np.random.default_rng(0)
    n_blocks, m, ch, nbuf = 1024, 512, 128, 4  # the probe's --check shapes
    tab = rng.integers(0, 2**32, size=(n_blocks, 8, 128), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, n_blocks, size=m).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(dma_gather(jnp.asarray(tab), jnp.asarray(idx), ch, nbuf))
    got = ops.xor_gather(torch.from_numpy(tab.view(np.int32)), torch.from_numpy(idx), ch, nbuf)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want, np.bitwise_xor.reduce(tab[idx], axis=0))


@pytest.mark.parametrize(
    "m,fill,error,match",
    [
        (100, 0, ValueError, "multiple of CH"),
        (128, 64, IndexError, r"outside \[0, 64\)"),
        (128, -1, IndexError, r"outside \[0, 64\)"),
    ],
    ids=["m_not_multiple_of_ch", "index_past_end", "negative_index"],
)
def test_xor_gather_validates_inputs(m, fill, error, match):
    """M % CH as dma_gather asserts it, and indices inside the table (a
    TPU copy outside it faults; torch would wrap a negative one)."""
    tab = torch.zeros((64, 8, 128), dtype=torch.int32)
    idx = torch.zeros(m, dtype=torch.int32)
    idx[-1] = fill
    before = ops.xor_gather.launches
    with pytest.raises(error, match=match):
        ops.xor_gather(tab, idx, 32, 4)
    assert ops.xor_gather.launches == before


def test_cpu_tensors_take_plain_version_without_counting():
    before = ops.xor_gather.launches
    tab = torch.arange(4 * 2 * 4, dtype=torch.int32).reshape(4, 2, 4)
    out = ops.xor_gather(tab, torch.tensor([1, 2, 2, 3], dtype=torch.int32), 2, 2)
    assert torch.equal(out, tab[1] ^ tab[3])
    empty = ops.xor_gather(tab, torch.zeros(0, dtype=torch.int32), 2, 2)
    assert torch.equal(empty, torch.zeros((2, 4), dtype=torch.int32))
    assert ops.xor_gather.launches == before


def test_dma_gather_probe_tool_runs_on_cpu(capsys):
    assert dma_gather_probe.main(["--check", "--device", "cpu"]) == 0
    for exp in dma_gather_probe.EXPERIMENTS:
        assert dma_gather_probe.main([exp, "--device", "cpu", "--rows", "2048", "--m", "256",
                                      "--ch", "64", "--nbuf", "4"]) == 0
    out = capsys.readouterr().out
    assert "xor_gather check OK on cpu" in out
    for exp in dma_gather_probe.EXPERIMENTS:
        assert f"{exp} [" in out
    assert out.count("M=256") == 4
    assert out.count(" ms ") >= 4


def test_profile_realistic_tool_runs_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--bins", "2", "--filters", "2", "--batch", "8", "--chunk", "64",
            "--cache", str(tmp_path)]
    assert profile_realistic.main(args) == 0
    out = capsys.readouterr().out
    assert out.count("built g") == 2
    assert sorted(p.name for p in tmp_path.glob("*.ribf")) == ["g0_b2_f100000_k13.ribf", "g1_b2_f100000_k13.ribf"]
    for stage in ("host encode", "H2D", "counts full (K1 path)", "gather+AND only",
                  "K4 accumulate only [4,64,16]", "max_counts", "counts throughput"):
        assert stage in out, stage
    assert '"K1": 0, "K4": 0' in out  # plain versions on the CPU
    assert profile_realistic.main(args) == 0  # the second run loads the cache
    assert "built g" not in capsys.readouterr().out
