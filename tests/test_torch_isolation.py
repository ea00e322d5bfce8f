"""The port stands alone.

* Under an import hook that refuses ``jax``, ``jaxlib`` and
  ``readbouncer_tpu`` (that package and its submodules, not
  ``readbouncer_tpu_torch``), every module of the port and
  ``chip_smoke`` import, and a tiny classify and a tiny live run with the
  GRU caller run with ``device="cpu"``, through the port's own native
  host library (``readbouncer_tpu_torch.native``, loaded under the hook;
  never ``readbouncer_tpu._native``).
* Without a CUDA card ``chip_smoke.py`` exits non-zero without printing
  a result, also when it is alone in a directory.

tests/test_torch_device.py shows that the entry points never fall back
to the CPU on their own.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

BLOCKED_RUN = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "readbouncer_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import readbouncer_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(readbouncer_tpu_torch.__path__, "readbouncer_tpu_torch.")]
    names = [n for n in names if n != "readbouncer_tpu_torch.__main__"]
    for n in names:
        importlib.import_module(n)
    import chip_smoke  # noqa: F401

    import numpy as np
    from readbouncer_tpu_torch.classify.engine import ClassifyEngine
    from readbouncer_tpu_torch.ibf.build import build_ibf_records
    from readbouncer_tpu_torch.ibf.params import IBFParams

    rng = np.random.default_rng(0)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    ibf, _ = build_ibf_records([("g", genome)], IBFParams(fragment_length=1000), name="g", device="cpu")
    engine = ClassifyEngine([ibf], [], error_rate=0.1, batch_size=8, device="cpu")
    reads = [genome[100:700], "".join("ACGT"[i] for i in rng.integers(0, 4, 600))]
    classified, best, attempts = engine.classify_sequences(reads)
    assert classified.tolist() == [True, False], classified
    import tempfile
    from readbouncer_tpu_torch.models.basecaller import GRUBasecaller
    from readbouncer_tpu_torch.stream.replay import ReplayRead, ReplaySource, sequence_to_signal
    from readbouncer_tpu_torch.stream.scheduler import AdaptiveSampler, LiveClassifier, LiveConfig

    seq = genome[200:2000]
    src = ReplaySource(reads=[ReplayRead("on", sequence_to_signal(seq, rng=rng), seq)], channels=1)
    cfg = LiveConfig(batch_size=8)
    caller = GRUBasecaller(network="synth48", max_frames=320, device="cpu")
    with tempfile.TemporaryDirectory() as td:
        sampler = AdaptiveSampler(src, caller, LiveClassifier([ibf], [], cfg, device="cpu"), td, cfg)
        stats = sampler.run(max_ticks=20)
    assert (stats.stop_received, stats.unblocked) == (1, 0), stats.report()
    # the native host library the runs above went through is the port's own
    from readbouncer_tpu_torch.native import CALLS, MODULE, load_native
    assert all(CALLS[k] > 0 for k in ("encode_batch", "insert_fragments")), CALLS
    assert sys.modules[MODULE] is load_native().module and MODULE.startswith("readbouncer_tpu_torch.")
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ISOLATED", len(names))
    """
)


def _run(args, cwd, extra_env=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **(extra_env or {}))
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_and_runs_with_jax_and_reference_blocked():
    proc = _run([sys.executable, "-c", BLOCKED_RUN], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout
    assert int(proc.stdout.split()[-1]) >= 30  # every module of the port was imported


def test_blocker_really_blocks_the_reference():
    probe = BLOCKED_RUN.split("import readbouncer_tpu_torch")[0] + "import readbouncer_tpu\n"
    proc = _run([sys.executable, "-c", probe], cwd=ROOT)
    assert proc.returncode != 0 and "blocked import of readbouncer_tpu" in proc.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone_in_a_directory"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; chip_smoke.py would run")
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
            timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        )
    else:
        proc = _run([sys.executable, "chip_smoke.py"], cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
