"""``python -m readbouncer_tpu_torch`` against ``python -m readbouncer_tpu``
on one small config: the same TOML file over the same .ribf filters, the
same output FASTAs and counters.  A multi-process run (``[TPU]
coordinator`` set), not ported yet, exits 2 naming ROADMAP M9 in every
usage, before any work.  The live usages (``target``, ``test``) are held
against the JAX CLI in tests/test_torch_cli_live.py, the filter-building
ones (``build``, ``update``, FASTA filter inputs) in
tests/test_torch_build_cli.py."""

import logging
import os
import re
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


COORDINATOR = '\n[TPU]\ncoordinator = "localhost:8476"\nnum_processes = 2\nprocess_id = 0\n'


def _coordinated(td, name, **kw):
    """A config of this file with the multi-process keys set."""
    cfg = _config(td, name, **kw)
    cfg.write_text(cfg.read_text().replace("\n[TPU]\nbatch_size = 16\n", COORDINATOR))
    return cfg


def test_cli_fasta_filter_inputs_exit_nonzero(world, capsys):
    """Under a coordinator FASTA inputs are refused before any filter is built."""
    td = world
    cfg = _coordinated(td, "fasta", targets="target.fasta", depletes="deplete.fasta")
    assert port_main(["--config", str(cfg), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "not ported" in err and "M9" in err and "coordinator" in err and "ROADMAP.md" in err
    assert not (td / "out_fasta" / "target.ribf").exists()
    assert not (td / "out_fasta" / "target.fasta").exists()


@pytest.mark.parametrize("usage", ["build", "update", "classify", "target", "test"])
def test_cli_unported_usages_exit_nonzero(world, capsys, usage):
    """Each usage of a multi-process run exits 2 naming M9, writing nothing."""
    td = world
    extra = f'update_filter = "{td}/target.ribf"\n' if usage == "update" else ""
    cfg = _coordinated(td, f"u_{usage}", usage=usage, extra=extra)
    assert port_main(["--config", str(cfg), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "not ported" in err and "M9" in err and "coordinator" in err and "ROADMAP.md" in err
    assert list((td / f"out_u_{usage}").iterdir()) == []
