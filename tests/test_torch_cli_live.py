"""``python -m readbouncer_tpu_torch`` against ``python -m readbouncer_tpu``
on the live usages: ``target`` with the Oracle and the synth48 GRU
caller, and from recorded signals, gives the same output FASTAs,
decision CSV rows (all but the timing column) and final counters;
``test`` reports the same first window; ``target`` with the remote
caller (a TCP basecall server in a thread) and over the device mesh
``data:4,bins:2`` gives what the JAX CLI gives."""

import logging
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from readbouncer_tpu.main import main as jax_main
from readbouncer_tpu.stream.replay import NearestLevelBasecaller as JaxOracle
from readbouncer_tpu.stream.replay import ReplaySource as JaxReplaySource
from readbouncer_tpu_torch.main import main as port_main
from readbouncer_tpu_torch.models.remote import serve_basecalls
from readbouncer_tpu_torch.stream.replay import NearestLevelBasecaller
from torch_live_world import make_world

ROOT = Path(__file__).resolve().parent.parent
LOGGERS = ("ReadBouncerLog", "IbfLog", "ClassifyLog", "RUClientLog")


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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tiny live world's .ribf filters and a replay FASTA of 3 host,
    3 target and 1 random read of 3 kb."""
    td = tmp_path_factory.mktemp("cli_live")
    genomes, _ = make_world(td)
    rng = np.random.default_rng(8)
    lines = []
    for name, tag in (("host", "h"), ("target", "t")):
        for i in range(3):
            s = int(rng.integers(0, 6000 - 3000))
            lines.append(f">{tag}{i}\n{genomes[name][s:s + 3000]}")
    lines.append(">x0\n" + "".join("ACGT"[i] for i in rng.integers(0, 4, 3000)))
    (td / "reads.fasta").write_text("\n".join(lines) + "\n")
    return td


def _config(td, name, usage="target", caller="Oracle", tpu=""):
    cfg = td / f"{name}.toml"
    cfg.write_text(
        f'usage = "{usage}"\noutput_directory = "{td}/out_{name}"\nlog_directory = "{td}/log_{name}"\n\n'
        f'[IBF]\nkmer_size = 13\ntarget_files = ["{td}/target.ribf"]\ndeplete_files = ["{td}/host.ribf"]\n'
        f'exp_seq_error_rate = 0.1\n\n[Basecaller]\ncaller = "{caller}"\nnetwork = "synth48"\n\n'
        f'[TPU]\nbatch_size = 16\n{tpu or f"replay_file = {chr(34)}{td}/reads.fasta{chr(34)}"}\n'
    )
    return cfg


def _report(stdout):
    """The final live report without its timing lines."""
    lines = stdout[stdout.index("Number of classified reads"):].splitlines()
    lines = lines[: next(i for i, ln in enumerate(lines) if ln.startswith("Real time"))]
    return [ln for ln in lines if "time" not in ln and "latency" not in ln]


def _outputs(out_dir):
    csv = (out_dir / "read_until_decision_stats.csv").read_text().splitlines()
    return (
        [row.rsplit(";", 1)[0] for row in csv],
        (out_dir / "TargetReads.fasta").read_text(),
        (out_dir / "DepletedReads.fasta").read_text(),
    )


def _assert_same_run(td, port_name, jax_name, port_stdout, jax_stdout):
    assert _report(port_stdout) == _report(jax_stdout)
    assert _outputs(td / f"out_{port_name}") == _outputs(td / f"out_{jax_name}")


def test_cli_target_oracle_matches_jax(world, capsys):
    td = world
    assert jax_main(["--config", str(_config(td, "jax_oracle"))]) == 0
    jax_out = capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "readbouncer_tpu_torch", "--config", str(_config(td, "port_oracle")),
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    _assert_same_run(td, "port_oracle", "jax_oracle", proc.stdout, jax_out)
    rows = _outputs(td / "out_port_oracle")[0]
    assert sum("unblock" in r for r in rows) == 3 and sum("stop_receiving" in r for r in rows) == 4


def test_cli_target_synth48_matches_jax(world, capsys):
    td = world
    assert jax_main(["--config", str(_config(td, "jax_gru", caller="DeepNano"))]) == 0
    jax_out = capsys.readouterr().out
    assert port_main(["--config", str(_config(td, "port_gru", caller="DeepNano")), "--device", "cpu"]) == 0
    _assert_same_run(td, "port_gru", "jax_gru", capsys.readouterr().out, jax_out)
    assert ">h0" in (td / "out_port_gru" / "DepletedReads.fasta").read_text()


def test_cli_target_recorded_signals_matches_jax(world, capsys):
    td = world
    npz = JaxReplaySource.from_fasta([td / "reads.fasta"]).save_signals(td / "recorded.npz")
    tpu = f'replay_signals = "{npz}"'
    assert jax_main(["--config", str(_config(td, "jax_rec", tpu=tpu))]) == 0
    jax_out = capsys.readouterr().out
    assert port_main(["--config", str(_config(td, "port_rec", tpu=tpu)), "--device", "cpu"]) == 0
    _assert_same_run(td, "port_rec", "jax_rec", capsys.readouterr().out, jax_out)


def test_cli_test_usage_matches_jax(world, capsys):
    td = world
    assert jax_main(["--config", str(_config(td, "jax_conn", usage="test"))]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if "successful" in ln or "first window" in ln]
    assert port_main(["--config", str(_config(td, "port_conn", usage="test")), "--device", "cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines() if "successful" in ln or "first window" in ln]
    assert got == want and len(got) == 2 and "7 chunks in first window" in got[1]


def _serve(basecall_fn):
    """A one-connection basecall server (serve_basecalls) in a thread;
    returns its port."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        with srv:
            serve_basecalls(srv, basecall_fn)

    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[1]


def test_cli_target_remote_caller_matches_jax(world, capsys):
    """caller = "remote": each CLI basecalls through a TCP server running
    the Oracle; outputs and counters equal, and equal to the Oracle run's
    decisions."""
    td = world
    for pkg, run, oracle in (("jax", jax_main, JaxOracle), ("port", port_main, NearestLevelBasecaller)):
        cfg = _config(td, f"{pkg}_remote", caller="remote")
        cfg.write_text(cfg.read_text().replace(
            'network = "synth48"', f'network = "synth48"\nhost = "127.0.0.1"\nport = "{_serve(oracle().basecall)}"'))
        args = ["--config", str(cfg)] + (["--device", "cpu"] if pkg == "port" else [])
        assert run(args) == 0
        outs = capsys.readouterr().out
        if pkg == "jax":
            jax_out = outs
    _assert_same_run(td, "port_remote", "jax_remote", outs, jax_out)
    rows = _outputs(td / "out_port_remote")[0]
    assert sum("unblock" in r for r in rows) == 3 and sum("stop_receiving" in r for r in rows) == 4


def test_cli_target_mesh_matches_jax(world, capsys):
    """[TPU] mesh_shape = "data:4,bins:2": the JAX CLI over its 8 virtual
    devices and the port's over 8 CPU shards (ShardedLiveClassifier) give
    the same outputs and counters; the decisions are those of the
    unsharded run."""
    td = world
    tpu = f'mesh_shape = "data:4,bins:2"\nreplay_file = "{td}/reads.fasta"'
    assert jax_main(["--config", str(_config(td, "jax_mesh", tpu=tpu))]) == 0
    jax_out = capsys.readouterr().out
    assert port_main(["--config", str(_config(td, "port_mesh", tpu=tpu)), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    _assert_same_run(td, "port_mesh", "jax_mesh", port_out, jax_out)
    assert port_main(["--config", str(_config(td, "port_unsharded")), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert _outputs(td / "out_port_mesh") == _outputs(td / "out_port_unsharded")
