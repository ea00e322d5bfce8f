"""Filter state across the two packages: ``ibf_from_numpy`` and the .ribf
loader and writer, each held equal to the JAX package's IBFData; and the
tracked bench filters and genomes, read with the port's loaders, against
the sha256 constants chip_smoke.py checks on the card (through
tools/bench.py::bench_filters, whose constants they are)."""

import hashlib
from pathlib import Path

import pytest
import torch

import chip_smoke
from readbouncer_tpu.ibf.build import build_ibf as jax_build_ibf
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu.ibf.storage import IBFData as JaxIBFData
from readbouncer_tpu_torch.errors import FilterFileError, FilterSchemeError
from readbouncer_tpu_torch.fastio.fasta import read_records
from readbouncer_tpu_torch.ibf.storage import IBFData, ibf_from_numpy, sniff
from readbouncer_tpu_torch.tools import bench as bench_tool
from test_torch_build import _assert_same_filter, refs  # noqa: F401  (module fixture)

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / ".bench_cache"


def test_ibf_from_numpy_carries_a_jax_filter(refs):
    path, _ = refs
    jax_ibf, _ = jax_build_ibf([path], JaxParams(kmer_size=13, fragment_length=1000), name="x")
    port = ibf_from_numpy(vars(jax_ibf))
    _assert_same_filter(jax_ibf, port)
    port.bits[0, 0] ^= 1  # a copy: the JAX filter is untouched
    assert port.bits[0, 0] != jax_ibf.bits[0, 0]
    minimal = ibf_from_numpy(
        {"bits": jax_ibf.bits, "kmer_size": 13, "hash_functions": 3, "num_bins": jax_ibf.num_bins}
    )
    assert minimal.scheme == "rbt1" and minimal.bin_ranges is None
    with pytest.raises(FilterSchemeError):
        ibf_from_numpy({**vars(jax_ibf), "scheme": "rbt9"})
    with pytest.raises(FilterFileError):
        ibf_from_numpy({**vars(jax_ibf), "bits": jax_ibf.bits.reshape(-1)})


def test_ribf_roundtrip_across_packages(refs, tmp_path):
    path, _ = refs
    jax_ibf, _ = jax_build_ibf([path], JaxParams(kmer_size=13, fragment_length=1000), name="x")
    jax_ibf.save(tmp_path / "jax.ribf")
    assert sniff(tmp_path / "jax.ribf") and not sniff(path)
    port = IBFData.load(tmp_path / "jax.ribf")
    _assert_same_filter(jax_ibf, port)
    port.save(tmp_path / "port.ribf")
    _assert_same_filter(jax_ibf, JaxIBFData.load(tmp_path / "port.ribf"))
    assert IBFData.load(tmp_path / "jax.ribf", name="renamed").name == "renamed"
    with pytest.raises(FilterFileError):
        IBFData.load(path)


@pytest.mark.parametrize("i", range(4))
def test_tracked_bench_state_matches_chip_smoke(i):
    """chip_smoke.py cannot take the tracked filters to the card (they
    exceed what a copy for the card may hold): it regenerates bench.py's
    genome i, builds its filter there and checks both against sha256
    constants (tools/bench.py's).  Those constants are the tracked files'
    own."""
    name = chip_smoke.bench_name(i)
    ibf = IBFData.load(BENCH / f"{name}.ribf")
    assert hashlib.sha256(ibf.bits.tobytes()).hexdigest() == chip_smoke.BITS_SHA[i]
    assert (ibf.num_bins, ibf.kmer_size, ibf.hash_functions, ibf.scheme, ibf.fragment_length) == (
        chip_smoke.BINS_PER_FILTER, 13, 3, "rbt1", chip_smoke.FRAGMENT
    )
    (rec,) = read_records(BENCH / f"{name}.fasta")
    genome = rec.seq.encode("ascii")
    assert hashlib.sha256(genome).hexdigest() == bench_tool.GENOME_SHA[i]
    assert bench_tool.bench_genome(i).tobytes() == genome
