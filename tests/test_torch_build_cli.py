"""The filter-building usages of ``python -m readbouncer_tpu_torch`` against
``python -m readbouncer_tpu``: ``build`` writes the same ``.ribf`` arrays;
``update_ibf`` and the ``update`` usage give the same bits, ``bin_seqids``
and ``bin_ranges`` for rbt1 and rbt2, from an old bin count that is a
multiple of 32 and from one that is not; ``classify`` and ``target`` over
FASTA filter inputs build the same filters and give the same outputs."""

import logging
import zipfile

import numpy as np
import pytest
import torch

from readbouncer_tpu.ibf.build import build_ibf as jax_build_ibf
from readbouncer_tpu.ibf.build import update_ibf as jax_update_ibf
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu.main import main as jax_main
from readbouncer_tpu_torch.ibf.build import update_ibf
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.storage import ibf_from_numpy
from readbouncer_tpu_torch.main import main as port_main

torch.set_num_threads(1)

LOGGERS = ("ReadBouncerLog", "IbfLog", "ClassifyLog", "RUClientLog")
FRAGMENT = 200  # small fragments: tens of bins from a few kb


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


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Genomes of 32 and 37 declared bins (old filters), a two-record
    update FASTA of 38 bins with an N run and a record shorter than k,
    two classify genomes and reads cut from them."""
    td = tmp_path_factory.mktemp("build_cli")
    rng = np.random.default_rng(31)
    (td / "old32.fasta").write_text(f">o32 first\n{_rand_seq(rng, 6300)}\n")
    (td / "old37.fasta").write_text(f">o37\n{_rand_seq(rng, 7300)}\n")
    a = _rand_seq(rng, 5000)
    (td / "new.fasta").write_text(
        f">newA desc\n{a[:2000]}NNNNN{a[2000:]}\n>tiny\nACGT\n>newB\n{_rand_seq(rng, 2600)}\n"
    )
    target, deplete = _rand_seq(rng, 6000), _rand_seq(rng, 6000)
    (td / "target.fasta").write_text(f">t1\n{target}\n")
    (td / "deplete.fasta").write_text(f">d1\n{deplete}\n")
    reads = []
    for src, tag in ((target, "tr"), (deplete, "dr")):
        for i in range(4):
            s = int(rng.integers(0, 6000 - 400))
            reads.append(f">{tag}{i}\n{src[s:s + 400]}")
    reads.append(">rr0\n" + _rand_seq(rng, 400))
    (td / "reads.fasta").write_text("\n".join(reads) + "\n")
    replay = [f">{tag}{i}\n{src[500 * i:500 * i + 3000]}" for src, tag in ((target, "t"), (deplete, "h"))
              for i in range(3)]
    (td / "replay.fasta").write_text("\n".join(replay) + "\n")
    return td


def _config(td, name, usage, targets, depletes=(), extra_ibf="", tpu=""):
    q = lambda files: ", ".join(f'"{td / f}"' for f in files)
    cfg = td / f"{name}.toml"
    cfg.write_text(
        f'usage = "{usage}"\noutput_directory = "{td}/out_{name}"\nlog_directory = "{td}/log_{name}"\n\n'
        f"[IBF]\nkmer_size = 13\nfragment_size = 2000\ntarget_files = [{q(targets)}]\n"
        f'deplete_files = [{q(depletes)}]\nread_files = ["{td}/reads.fasta"]\n'
        f"exp_seq_error_rate = 0.1\nchunk_length = 200\nmax_chunks = 2\n{extra_ibf}\n"
        f'[Basecaller]\ncaller = "Oracle"\n\n[TPU]\nbatch_size = 16\n{tpu}\n'
    )
    return str(cfg)


def _run_both(td, name, capsys, **kw):
    """The JAX CLI, then the port's CLI on the CPU, on the same config;
    returns both stdouts."""
    assert jax_main(["--config", _config(td, f"jax_{name}", **kw)]) == 0
    jax_out = capsys.readouterr().out
    assert port_main(["--config", _config(td, f"port_{name}", **kw), "--device", "cpu"]) == 0
    return jax_out, capsys.readouterr().out


def _members(path):
    """Every array of a .ribf (an npz archive) as its stored bytes."""
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _bins(bits, n):
    """bool [rows, n]: the bits of the first n bins."""
    b = (bits[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return b.reshape(bits.shape[0], -1)[:, :n]


def _between(text, first, last):
    lines = text[text.index(first):].splitlines()
    return [ln for ln in lines[: next(i for i, ln in enumerate(lines) if ln.startswith(last))]
            if "time" not in ln.lower() and "latency" not in ln]


def test_cli_build_matches_jax(world, capsys):
    td = world
    _run_both(td, "build", capsys, usage="build", targets=["target.fasta"], depletes=["deplete.fasta"])
    for stem in ("target", "deplete"):
        got = _members(td / "out_port_build" / f"{stem}.ribf")
        assert got == _members(td / "out_jax_build" / f"{stem}.ribf"), stem
        assert "bits.npy" in got and "bin_ranges.npy" in got


@pytest.mark.parametrize("scheme", ["rbt1", "rbt2"])
@pytest.mark.parametrize("old", ["old32", "old37"], ids=["old_bins_32", "old_bins_37"])
def test_update_ibf_matches_jax(world, scheme, old):
    td = world
    jp = JaxParams(kmer_size=13, fragment_length=FRAGMENT, hash_scheme=scheme)
    jax_ibf, _ = jax_build_ibf([td / f"{old}.fasta"], jp, name=old)
    port_ibf = ibf_from_numpy(vars(jax_ibf))  # copied before the JAX update grows it in place
    old_bits, old_bins = port_ibf.bits.copy(), port_ibf.num_bins
    assert old_bins == int(old[3:])
    want, wstats = jax_update_ibf(jax_ibf, [td / "new.fasta"], jp)
    # a scheme other than the filter's is overridden by the filter's own
    other = "rbt2" if scheme == "rbt1" else "rbt1"
    tp = IBFParams(kmer_size=13, fragment_length=FRAGMENT, hash_scheme=other)
    got, gstats = update_ibf(port_ibf, [td / "new.fasta"], tp, device="cpu")
    assert got.num_bins == want.num_bins == old_bins + 38 and got.scheme == scheme
    np.testing.assert_array_equal(got.bits, want.bits)
    assert got.bin_seqids == want.bin_seqids and got.bin_seqids[old_bins:][:1] == ["newA"]
    np.testing.assert_array_equal(got.bin_ranges, want.bin_ranges)
    np.testing.assert_array_equal(_bins(got.bits, old_bins), _bins(old_bits, old_bins))
    for key in ("total_seqs_file", "total_bins_declared", "total_bins_inserted", "invalid_seqs",
                "new_bins", "filter_size_bits", "sum_seq_len"):
        assert getattr(gstats, key) == getattr(wstats, key), key


def test_cli_update_matches_jax(world, capsys):
    td = world
    ibf, _ = jax_build_ibf([td / "old37.fasta"], JaxParams(kmer_size=13, fragment_length=FRAGMENT), name="old37")
    ibf.save(td / "old37.ribf")
    _run_both(td, "update", capsys, usage="update", targets=["new.fasta"],
              extra_ibf=f'update_filter = "{td / "old37.ribf"}"')
    got = _members(td / "out_port_update" / "old37.ribf")
    assert got == _members(td / "out_jax_update" / "old37.ribf")
    assert got != _members(td / "old37.ribf")


def test_cli_classify_fasta_filter_inputs_match_jax(world, capsys):
    td = world
    jax_out, port_out = _run_both(td, "cls", capsys, usage="classify", targets=["target.fasta"],
                                  depletes=["deplete.fasta"])
    assert _between(port_out, "Final Results", "-----") == _between(jax_out, "Final Results", "-----")
    for name in ("target.fasta", "unclassified.fasta", "target.ribf", "deplete.ribf"):
        got, want = td / "out_port_cls" / name, td / "out_jax_cls" / name
        if name.endswith(".ribf"):
            assert _members(got) == _members(want), name
        else:
            assert got.read_text() == want.read_text(), name
    assert (td / "out_port_cls" / "target.fasta").read_text().count(">tr") == 4


def test_cli_target_fasta_filter_inputs_match_jax(world, capsys):
    td = world
    tpu = f'replay_file = "{td / "replay.fasta"}"'
    jax_out, port_out = _run_both(td, "live", capsys, usage="target", targets=["target.fasta"],
                                  depletes=["deplete.fasta"], tpu=tpu)
    assert _between(port_out, "Number of classified reads", "Real time") == _between(
        jax_out, "Number of classified reads", "Real time"
    )
    for name in ("TargetReads.fasta", "DepletedReads.fasta", "target.ribf", "deplete.ribf"):
        got, want = td / "out_port_live" / name, td / "out_jax_live" / name
        assert (_members(got) == _members(want)) if name.endswith(".ribf") else got.read_text() == want.read_text()
    rows = (td / "out_port_live" / "read_until_decision_stats.csv").read_text().splitlines()
    assert [r.rsplit(";", 1)[0] for r in rows] == [
        r.rsplit(";", 1)[0] for r in (td / "out_jax_live" / "read_until_decision_stats.csv").read_text().splitlines()
    ]
    assert sum("unblock" in r for r in rows) == 3
