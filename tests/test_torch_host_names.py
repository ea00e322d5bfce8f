"""The host names the port copies from the JAX package, each held against
its JAX counterpart: the decision math (with tests/test_math.py's
goldens), the classify errors and their hierarchy, the Dna5 complement,
the filter sizing, ``IBFParams.threads`` / ``total_bits`` and the numpy
``insert_sequence``, which must also give the bits of the port's build."""

import numpy as np
import pytest
import torch

from readbouncer_tpu import errors as jax_errors
from readbouncer_tpu.classify import math as jax_math
from readbouncer_tpu.ibf import build as jax_build
from readbouncer_tpu.ibf import hashing as jax_hashing
from readbouncer_tpu.ibf import params as jax_params
from readbouncer_tpu.ibf.storage import IBFData as JaxIBFData
from readbouncer_tpu_torch import errors
from readbouncer_tpu_torch.classify import math
from readbouncer_tpu_torch.ibf import build, hashing, params
from readbouncer_tpu_torch.ibf.storage import IBFData

torch.set_num_threads(1)

LENS = (0, 12, 13, 14, 20, 35, 100, 250, 719, 1500, 65535, 70000)
RATES = ((0.1, 0.95), (0.08, 0.95), (0.12, 0.9))


def _calculate_ci():
    assert math.calculate_ci(0.1, 13, 35, 0.95) == (5, 30)  # tests/test_math.py's golden
    for L in LENS:
        for r, sig in RATES:
            assert math.calculate_ci(r, 13, L, sig) == jax_math.calculate_ci(r, 13, L, sig), (L, r, sig)


def _match_threshold():
    assert math.match_threshold(35, 13, 0.1, 0.95) == 65529  # -7 wrapped, tests/test_math.py's golden
    for r, sig in RATES:
        batch = math.ci_and_threshold_batch(np.array(LENS[2:]), 13, r, sig)
        for i, L in enumerate(LENS[2:]):
            want = jax_math.match_threshold(L, 13, r, sig)
            assert math.match_threshold(L, 13, r, sig) == want == batch[i], (L, r, sig)


def _errors():
    for name in ("ClassifyError", "ShortReadError", "CountError"):
        assert name in errors.__all__ and name in jax_errors.__all__
        port, ref = getattr(errors, name), getattr(jax_errors, name)
        assert [c.__name__ for c in port.__mro__] == [c.__name__ for c in ref.__mro__], name
        assert port.__doc__ == ref.__doc__
    assert issubclass(errors.ShortReadError, errors.ClassifyError)
    assert issubclass(errors.CountError, errors.IBFError) and issubclass(errors.CountError, ValueError)
    with pytest.raises(errors.ClassifyError):
        raise errors.ShortReadError("read shorter than k")


def _complement():
    bases = np.arange(256, dtype=np.uint8) % 5
    got = hashing.complement(bases)
    assert got.dtype == np.uint8 and "complement" in hashing.__all__
    np.testing.assert_array_equal(got, jax_hashing.complement(bases))
    np.testing.assert_array_equal(hashing.complement(hashing.encode_bases("ACGTNacgtx")),
                                  [3, 2, 1, 0, 4, 3, 2, 1, 0, 4])


def _filter_size_bits():
    assert "filter_size_bits" in params.__all__
    assert params.filter_size_bits(2, 100_000) == 79_121_216  # the reference's golden
    for bins, frag, k, h, fp in ((1, 1000, 13, 3, 0.01), (64, 5000, 11, 2, 0.05), (512, 100_000, 15, 5, 0.001)):
        assert params.filter_size_bits(bins, frag, k, h, fp) == jax_params.filter_size_bits(bins, frag, k, h, fp)


def _threads():
    for n in (0, 1, 7):
        port, ref = params.IBFParams(build_threads=n), jax_params.IBFParams(build_threads=n)
        assert port.threads == ref.threads >= 1


def _total_bits():
    for scheme in ("rbt1", "rbt2"):
        port = params.IBFParams(fragment_length=5000, hash_scheme=scheme)
        ref = jax_params.IBFParams(fragment_length=5000, hash_scheme=scheme)
        for bins in (1, 63, 64, 512):
            assert port.total_bits(bins) == ref.total_bits(bins)
    assert params.IBFParams().total_bits(2) == params.filter_size_bits(2, 100_000)


def _insert_sequence():
    """Fragments of a 5 kb genome inserted bin by bin on the host: equal
    to the JAX package's numpy insert and to the port's device build."""
    rng = np.random.default_rng(8)
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, 5000))
    p = params.IBFParams(kmer_size=13, fragment_length=1000)
    built, _ = build.build_ibf_records([("g", genome)], p, name="g", device="cpu")
    clean = build.cut_out_nnns(genome)
    bounds = build.fragment_bounds(len(clean), p.fragment_length, p.kmer_size)
    assert len(bounds) > 1
    kw = dict(rows=p.rows, num_bins=built.num_bins, kmer_size=13, hash_functions=p.hash_functions,
              fragment_length=p.fragment_length, max_fp=p.max_fp, name="g")
    port, ref = IBFData.empty(**kw), JaxIBFData.empty(**kw)
    for b, (s, e) in enumerate(bounds):
        bases = hashing.encode_bases(clean[s:e])
        build.insert_sequence(port, bases, b)
        jax_build.insert_sequence(ref, bases, b)
    assert "insert_sequence" in build.__all__
    np.testing.assert_array_equal(port.bits, ref.bits)
    np.testing.assert_array_equal(port.bits, built.bits)
    assert port.bits.any()


CASES = {f.__name__[1:]: f for f in (
    _calculate_ci, _match_threshold, _errors, _complement, _filter_size_bits, _threads, _total_bits,
    _insert_sequence,
)}


@pytest.mark.parametrize("name", list(CASES))
def test_host_name_matches_jax(name):
    CASES[name]()
