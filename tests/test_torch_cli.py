"""``python -m readbouncer_tpu_torch`` against ``python -m readbouncer_tpu``
on one small config: the same TOML file over the same .ribf filters, the
same output FASTAs and counters.  Under ``[TPU] coordinator`` with one
process every usage writes and prints what it does without one, and a
process id outside the group is refused before any work (two-process
runs: tests/test_torch_distributed.py).  The live usages (``target``, ``test``) are held
against the JAX CLI in tests/test_torch_cli_live.py, the filter-building
ones (``build``, ``update``, FASTA filter inputs) in
tests/test_torch_build_cli.py."""

import logging
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from readbouncer_tpu.ibf.build import build_ibf as jax_build_ibf
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu.main import main as jax_main
from readbouncer_tpu_torch.main import main as port_main

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _restore_loggers():
    """main() of either package sets up the process-wide subsystem loggers
    (file handlers, propagate=False); put them back afterwards so later
    tests in the same process still see those loggers' records."""
    names = ("ReadBouncerLog", "IbfLog", "ClassifyLog", "RUClientLog")
    saved = {}
    for name in names:
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_cli.py's genome fixture, plus N-containing and short
    reads, and the two genomes' filters saved by the JAX package."""
    rng = np.random.default_rng(11)
    td = tmp_path_factory.mktemp("tcli")
    bases = np.array(list("ACGT"))
    target = "".join(bases[rng.integers(0, 4, size=6000)])
    deplete = "".join(bases[rng.integers(0, 4, size=6000)])
    (td / "target.fasta").write_text(f">t1\n{target}\n")
    (td / "deplete.fasta").write_text(f">d1\n{deplete}\n")
    lines = []
    for src, tag in ((target, "tr"), (deplete, "dr")):
        for i in range(4):
            s = rng.integers(0, 6000 - 400)
            lines.append(f">{tag}{i}\n{src[s:s + 400]}")
    for i in range(2):
        lines.append(f">rr{i}\n" + "".join(bases[rng.integers(0, 4, size=400)]))
    lines.append(f">nn0\n{target[1000:1180]}N{target[1181:1400]}")
    lines.append(f">short0\n{target[:150]}")
    (td / "reads.fasta").write_text("\n".join(lines) + "\n")
    for name in ("target", "deplete"):
        ibf, _ = jax_build_ibf([td / f"{name}.fasta"], JaxParams(kmer_size=13, fragment_length=2000),
                               name=name)
        ibf.save(td / f"{name}.ribf")
    return td


def _config(td, name, usage="classify", targets="target.ribf", depletes="deplete.ribf", extra=""):
    cfg = td / f"{name}.toml"
    cfg.write_text(
        f'usage = "{usage}"\noutput_directory = "{td}/out_{name}"\nlog_directory = "{td}/log_{name}"\n\n'
        f"[IBF]\nkmer_size = 13\nfragment_size = 2000\n"
        f'target_files = ["{td}/{targets}"]\ndeplete_files = ["{td}/{depletes}"]\n'
        f'read_files = ["{td}/reads.fasta"]\nexp_seq_error_rate = 0.1\n'
        f"chunk_length = 200\nmax_chunks = 2\n{extra}\n[TPU]\nbatch_size = 16\n"
    )
    return cfg


def _port_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "readbouncer_tpu_torch", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )


def _results_block(text):
    lines = text[text.index("Final Results"):].splitlines()[1:]
    block = lines[: next(i for i, ln in enumerate(lines) if ln.startswith("-----"))]
    # drop the timing line: it differs between any two runs
    return [ln for ln in block if "Average Processing Time" not in ln]


def test_cli_classify_matches_jax(world, capsys):
    td = world
    assert jax_main(["--config", str(_config(td, "jax"))]) == 0
    jax_out = capsys.readouterr().out
    proc = _port_cli("--config", str(_config(td, "port")), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert _results_block(proc.stdout) == _results_block(jax_out)
    assert re.search(r"Number of classified reads\s*:\s*[1-9]", proc.stdout)
    for name in ("target.fasta", "unclassified.fasta"):
        assert (td / "out_port" / name).read_text() == (td / "out_jax" / name).read_text()
    assert (td / "log_port" / "configLog.toml").exists()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _coordinated(cfg, num_processes, process_id):
    """The config ``cfg`` with the multi-process keys set."""
    text = cfg.read_text().replace(
        "\n[TPU]\n",
        f'\n[TPU]\ncoordinator = "127.0.0.1:{_free_port()}"\nnum_processes = {num_processes}\n'
        f"process_id = {process_id}\n",
    )
    out = cfg.with_name(cfg.stem + "_coord.toml")
    out.write_text(text.replace(f"out_{cfg.stem}", f"out_{cfg.stem}_coord"))
    return out


def test_cli_fasta_filter_inputs_exit_nonzero(world, capsys):
    """A coordinator with a process id outside [0, num_processes) is
    refused (exit 2) before any filter is built from the FASTA inputs."""
    td = world
    cfg = _coordinated(_config(td, "fasta", targets="target.fasta", depletes="deplete.fasta"), 2, 2)
    assert port_main(["--config", str(cfg), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "process_id 2" in err and "num_processes" in err
    assert not (td / "out_fasta_coord").exists() or list((td / "out_fasta_coord").iterdir()) == []


def _usage_config(td, usage):
    """A config of ``usage`` over this file's world: build from the genome
    FASTAs, update the target filter with the deplete genome, classify
    over the .ribf filters, target (Oracle caller) and test on the reads."""
    if usage == "build":
        return _config(td, usage, usage=usage, targets="target.fasta", depletes="deplete.fasta")
    if usage == "update":
        return _config(td, usage, usage=usage, targets="deplete.fasta",
                       extra=f'update_filter = "{td}/target.ribf"\n')
    cfg = _config(td, usage, usage=usage)
    if usage in ("target", "test"):
        cfg.write_text(cfg.read_text().replace(
            "\n[TPU]\n", f'\n[Basecaller]\ncaller = "Oracle"\n\n[TPU]\nreplay_file = "{td}/reads.fasta"\n'))
    return cfg


def _untimed(stdout):
    return [ln for ln in stdout.splitlines()
            if not any(w in ln for w in ("time", "Time", "latency", "Peak RSS"))]


def _output_files(out_dir):
    """Every output file's text; the decision CSV less its timing column."""
    files = {}
    for f in sorted(out_dir.iterdir()):
        text = f.read_bytes()
        if f.name == "read_until_decision_stats.csv":
            text = "\n".join(r.rsplit(";", 1)[0] for r in text.decode().splitlines())
        files[f.name] = text
    return files


@pytest.mark.parametrize("usage", ["build", "update", "classify", "target", "test"])
def test_cli_single_process_coordinator_matches_plain_run(world, capsys, usage):
    """Each usage under ``[TPU] coordinator`` with one process (a gloo
    group of one) writes the same files and prints the same report as
    without a coordinator, and leaves no process group behind."""
    import torch.distributed as dist

    td = world
    cfg = _usage_config(td, usage)
    assert port_main(["--config", str(cfg), "--device", "cpu"]) == 0
    plain = capsys.readouterr().out
    assert port_main(["--config", str(_coordinated(cfg, 1, 0)), "--device", "cpu"]) == 0
    coord = capsys.readouterr().out
    assert not dist.is_initialized()
    assert _untimed(coord) == _untimed(plain)
    want = _output_files(td / f"out_{usage}")
    assert _output_files(td / f"out_{usage}_coord") == want
    assert want if usage != "test" else "chunks in first window" in coord
