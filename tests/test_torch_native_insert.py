"""The build's native route (``insert_fragments`` of the port's host
library) against the port's plain insert, its torch route and the JAX
package's Python route, and the slice as a whole: the CLI's ``classify``
on the CPU, where reading, filter building and encoding all go through
the host library, against the JAX CLI on its Python paths.

The JAX package's own extension (``readbouncer_tpu._native``) is never
imported: ``_rbt_native`` is set to None in the JAX modules for each
test, so the JAX package runs its numpy insert and Python reader.
"""

import gzip
import logging
import re

import numpy as np
import pytest
import torch

from readbouncer_tpu.classify import engine as jax_engine
from readbouncer_tpu.fastio import fasta as jax_fasta
from readbouncer_tpu.ibf import build as jax_build
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu.ibf.storage import IBFData as JaxData
from readbouncer_tpu.main import main as jax_main
from readbouncer_tpu_torch.ibf.build import (
    BuildStats, _insert_all, _parse_refs, build_ibf, fragment_bounds, insert_sequence, update_ibf,
)
from readbouncer_tpu_torch.ibf.hashing import encode_bases
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.main import main as port_main
from readbouncer_tpu_torch.native import CALLS, load_native

LOGGERS = ("ReadBouncerLog", "IbfLog", "ClassifyLog", "RUClientLog")


@pytest.fixture(autouse=True)
def _jax_python_paths(monkeypatch):
    torch.set_num_threads(1)
    for module in (jax_fasta, jax_engine, jax_build):
        monkeypatch.setattr(module, "_rbt_native", None)


@pytest.fixture(autouse=True)
def _restore_loggers():
    """main() of either package sets up the process-wide subsystem loggers
    (file handlers, propagate=False); put them back afterwards."""
    saved = {}
    for name in LOGGERS:
        lg = logging.getLogger(name)
        saved[name] = (lg.handlers[:], lg.propagate, lg.level)
    yield
    for name, (handlers, propagate, level) in saved.items():
        lg = logging.getLogger(name)
        for h in lg.handlers:
            if h not in handlers:
                h.close()
        lg.handlers[:] = handlers
        lg.propagate = propagate
        lg.setLevel(level)


def _mk(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _fasta(path, records):
    path.write_text("".join(f">{name}\n{seq}\n" for name, seq in records))
    return path


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("scheme", ["rbt1", "rbt2"])
def test_insert_fragments_matches_plain_and_jax(tmp_path, scheme, threads):
    """tests/test_build.py:107-135's case: N runs, a single short fragment,
    k-1 overlaps, three sequences."""
    rng = np.random.default_rng(7)
    ref = _fasta(tmp_path / "r.fasta", [("a", _mk(rng, 950) + "NNNN" + _mk(rng, 431)),
                                        ("b", _mk(rng, 87)), ("c", _mk(rng, 2500))])
    params = IBFParams(kmer_size=13, fragment_length=500, hash_scheme=scheme, build_threads=threads)
    assert params.threads == threads
    stats = BuildStats()
    parsed = _parse_refs([(r.id, r.seq) for r in jax_fasta.read_records(ref, first_word_id=True)], params, stats)

    def empty():
        return IBFData.empty(rows=params.rows, num_bins=stats.total_bins_declared, kmer_size=13,
                             hash_functions=params.hash_functions, fragment_length=500, scheme=scheme)

    calls = CALLS["insert_fragments"]
    native, torch_route, plain = empty(), empty(), empty()
    _insert_all(native, parsed, params, BuildStats(), 0, torch.device("cpu"))  # native by default
    assert CALLS["insert_fragments"] == calls + 3
    _insert_all(torch_route, parsed, params, BuildStats(), 0, torch.device("cpu"), use_native=False)
    assert CALLS["insert_fragments"] == calls + 3
    bin_id = 0
    for seq in parsed.cleaned:
        for s, e in fragment_bounds(len(seq), 500, 13):
            insert_sequence(plain, encode_bases(seq)[s:e], bin_id)
            bin_id += 1

    jp = JaxParams(kmer_size=13, fragment_length=500, hash_scheme=scheme)
    jstats = jax_build.BuildStats()
    jparsed = jax_build._parse_refs([ref], jp, jstats)
    jax_ibf = JaxData.empty(rows=jp.rows, num_bins=jstats.total_bins_declared, kmer_size=13,
                            hash_functions=jp.hash_functions, fragment_length=500, scheme=scheme)
    jax_build._insert_all(jax_ibf, jparsed, jp, jax_build.BuildStats(), 0, use_native=False)

    assert native.bits.any() and bin_id == len(native.bin_seqids) == 3 + 1 + 6
    for other in (plain.bits, torch_route.bits, jax_ibf.bits):
        np.testing.assert_array_equal(native.bits, other)
    assert native.bin_seqids == torch_route.bin_seqids == jax_ibf.bin_seqids
    np.testing.assert_array_equal(native.bin_ranges, jax_ibf.bin_ranges)


def test_build_and_update_native_route_match_torch_route_and_jax(tmp_path):
    rng = np.random.default_rng(21)
    old = _fasta(tmp_path / "old.fasta", [("o1 first", _mk(rng, 4100)), ("o2", _mk(rng, 2300))])
    new = _fasta(tmp_path / "new.fasta", [("n1 d", _mk(rng, 1500) + "NNN" + _mk(rng, 1700)),
                                          ("tiny", "ACGT"), ("n2", _mk(rng, 900))])
    params = IBFParams(kmer_size=13, fragment_length=300)
    jp = JaxParams(kmer_size=13, fragment_length=300)
    calls = CALLS["insert_fragments"]
    native, nstats = build_ibf([old], params, name="old", device="cpu")
    assert CALLS["insert_fragments"] == calls + 2
    torch_route, tstats = build_ibf([old], params, name="old", device="cpu", use_native=False)
    want, wstats = jax_build.build_ibf([old], jp, name="old")
    for got, stats in ((native, nstats), (torch_route, tstats)):
        np.testing.assert_array_equal(got.bits, want.bits)
        assert got.bin_seqids == want.bin_seqids and got.num_bins == want.num_bins
        np.testing.assert_array_equal(got.bin_ranges, want.bin_ranges)
        assert stats.total_bins_inserted == wstats.total_bins_inserted

    native, _ = update_ibf(native, [new], params, device="cpu")
    torch_route, _ = update_ibf(torch_route, [new], params, device="cpu", use_native=False)
    want, wstats = jax_build.update_ibf(want, [new], jp)
    assert native.num_bins == want.num_bins > 33
    for got in (native, torch_route):
        np.testing.assert_array_equal(got.bits, want.bits)
        assert got.bin_seqids == want.bin_seqids
        np.testing.assert_array_equal(got.bin_ranges, want.bin_ranges)


def test_insert_fragments_refuses_bad_arguments():
    """The ValueErrors of rbt_native.cpp:430-462."""
    lib = load_native().module
    rows, words = 64, 2
    bits = np.zeros(rows * words, dtype=np.uint32)
    bases = bytes(40)
    good = np.array([[0, 40, 3]], dtype=np.int64).tobytes()
    lib.insert_fragments(bits, rows, words, bases, good, 13, 3, 1)
    assert bits.any()

    def frags(*spans):
        return np.array(spans, dtype=np.int64).tobytes()

    cases = [
        ("rbt2 needs rows%8==0 and h<=8", (bits, 60, words, bases, good, 13, 3, 1, 1)),
        ("rbt2 needs rows%8==0 and h<=8", (bits, rows, words, bases, good, 13, 9, 1, 1)),
        ("bits buffer too small", (bits[:-1], rows, words, bases, good, 13, 3, 1)),
        ("frags must be int64 [n,3]", (bits, rows, words, bases, good[:-8], 13, 3, 1)),
        ("need 1<=k<=16, 1<=h<=5", (bits, rows, words, bases, good, 17, 3, 1)),
        ("need 1<=k<=16, 1<=h<=5", (bits, rows, words, bases, good, 13, 0, 1)),
        ("fragment out of range", (bits, rows, words, bases, frags([0, 41, 3]), 13, 3, 1)),
        ("fragment out of range", (bits, rows, words, bases, frags([-1, 40, 3]), 13, 3, 1)),
        ("fragment out of range", (bits, rows, words, bases, frags([0, 40, 3], [0, 40, 64]), 13, 3, 1)),
    ]
    before = bits.copy()
    for message, args in cases:
        with pytest.raises(ValueError, match=re.escape(message)):
            lib.insert_fragments(*args)
    np.testing.assert_array_equal(bits, before)  # refused before any bit was set


def test_cli_classify_fastq_gz_matches_jax_cli(tmp_path, capsys):
    """The slice as a whole: ``classify`` over FASTA filter inputs (the
    port builds them with the native insert) and a ``.fastq.gz`` of reads
    (the native reader), with the native encode, equal to the JAX CLI."""
    rng = np.random.default_rng(5)
    target, deplete = _mk(rng, 6000), _mk(rng, 6000)
    _fasta(tmp_path / "target.fasta", [("t1 desc", target)])
    _fasta(tmp_path / "deplete.fasta", [("d1", deplete)])
    reads = []
    for src, tag in ((target, "tr"), (deplete, "dr")):
        for i in range(5):
            s = int(rng.integers(0, 6000 - 450))
            reads.append((f"{tag}{i} run=1", src[s : s + 450]))
    reads += [("rr0", _mk(rng, 450)), ("nn0", target[1000:1180] + "N" + target[1181:1400]),
              ("short0", target[:150])]
    with gzip.open(tmp_path / "reads.fastq.gz", "wt") as f:
        f.write("".join(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n" for rid, seq in reads))

    def config(name):
        cfg = tmp_path / f"{name}.toml"
        cfg.write_text(
            f'usage = "classify"\noutput_directory = "{tmp_path}/out_{name}"\n'
            f'log_directory = "{tmp_path}/log_{name}"\n\n'
            f"[IBF]\nkmer_size = 13\nfragment_size = 2000\n"
            f'target_files = ["{tmp_path}/target.fasta"]\ndeplete_files = ["{tmp_path}/deplete.fasta"]\n'
            f'read_files = ["{tmp_path}/reads.fastq.gz"]\nexp_seq_error_rate = 0.1\n'
            f"chunk_length = 200\nmax_chunks = 2\n\n[TPU]\nbatch_size = 16\n"
        )
        return str(cfg)

    assert jax_main(["--config", config("jax")]) == 0
    jax_out = capsys.readouterr().out
    before = dict(CALLS)
    assert port_main(["--config", config("port"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    for key in ("read_records", "insert_fragments", "encode_batch"):
        assert CALLS[key] > before.get(key, 0), key

    def results(text):
        lines = text[text.index("Final Results"):].splitlines()[1:]
        block = lines[: next(i for i, ln in enumerate(lines) if ln.startswith("-----"))]
        return [ln for ln in block if "Average Processing Time" not in ln]

    assert results(port_out) == results(jax_out)
    # the five target reads and the one with an N; the deplete reads are no target's
    assert "Number of classified reads                         :   6" in port_out
    for name in ("target.fasta", "deplete.fasta", "unclassified.fasta"):
        got, want = tmp_path / "out_port" / name, tmp_path / "out_jax" / name
        assert got.exists() == want.exists(), name
        if want.exists():
            assert got.read_text() == want.read_text(), name
    for stem in ("target", "deplete"):
        got, want = IBFData.load(tmp_path / "out_port" / f"{stem}.ribf"), JaxData.load(
            tmp_path / "out_jax" / f"{stem}.ribf")
        np.testing.assert_array_equal(got.bits, want.bits)
        assert got.bin_seqids == want.bin_seqids == [stem[0] + "1"] * 4
