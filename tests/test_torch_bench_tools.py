"""The port's offline measurement tools (readbouncer_tpu_torch/tools/bench.py,
bench_build.py, bench_toy.py, profile_classify.py) against the JAX side.

* Workloads, draw for draw: bench.py's, scripts/bench_toy.py's and
  scripts/bench_build.py's own ``main`` run at small sizes with the JAX
  package's filter build and engine replaced by recorders; the genomes,
  reads and FASTA bytes they made must be the port's.
* Decisions: run_bench, run_bench_toy and run_profile_classify on the
  CPU over 2 filters x 8 bins x 2 kb and 256 reads decide every read as
  the JAX ClassifyEngine (batch 64) does.
* JSON lines: each tool's ``main(... --device cpu)``, at a small size
  set through the tools' module constants as the scripts' are, prints
  as its last line a JSON object with the JAX script's metric and keys
  plus ``device`` (bench.py's less the three keys of its TPU upload
  regimes, plus the classified count and the run times;
  profile_classify's JAX script prints text only, and the port's line
  carries its stages).  bench and profile_classify build the four bench
  filters at 8 bins x 2 kb and hold them to the sha256 of what bench.py's
  own ``get_filters`` builds at that size with the JAX package.
"""

import hashlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from readbouncer_tpu.classify.engine import ClassifyEngine as JaxEngine
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu_torch.ibf.storage import ibf_from_numpy
from readbouncer_tpu_torch.tools import bench, bench_build, bench_toy, profile_classify

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _load_script(path: Path, name: str):
    """A root or scripts/ module by path; the module's import-time changes
    to the environment and sys.path are put back."""
    saved_env, saved_path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        sys.path[:] = saved_path
    return mod


class _Stop(Exception):
    pass


class _FakeIBF:
    rows = words = 1

    def save(self, path):
        Path(path).write_bytes(b"")


def _recording_build(record):
    def build(paths, params, name=""):
        record[name] = Path(paths[0]).read_bytes()
        return _FakeIBF(), None

    return build


def _recording_engine(record):
    class Engine:
        def __init__(self, *a, **kw):
            pass

        def probe_transfer_seconds(self):
            return 0.0

        def _stop(self, seqs, **kw):
            record["seqs"] = list(seqs)
            raise _Stop

        classify_sequences = classify_sequences_pipelined = _stop

    return Engine


def test_workloads_are_the_scripts_draw_for_draw(tmp_path, monkeypatch):
    import readbouncer_tpu.classify.engine as jax_engine_mod
    import readbouncer_tpu.ibf.build as jax_build_mod

    record = {}
    monkeypatch.setattr(jax_build_mod, "build_ibf", _recording_build(record))
    monkeypatch.setattr(jax_engine_mod, "ClassifyEngine", _recording_engine(record))
    # bench.py at 1 bin (100 kb genomes) and 600 reads
    script = _load_script(ROOT / "bench.py", "jax_bench_script")
    monkeypatch.setattr(script, "CACHE", tmp_path / "cache")
    monkeypatch.setattr(script, "BINS_PER_FILTER", 1)
    monkeypatch.setattr(script, "N_READS", 600)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(_Stop):
        script.main()
    genomes = [bench.bench_genome(i, 100_000) for i in range(4)]
    for i, g in enumerate(genomes):
        fasta = (tmp_path / "cache" / f"g{i}_b1_f100000_k13.fasta").read_bytes()
        assert fasta.split(b"\n")[1] == g.tobytes()
    assert record.pop("seqs") == bench.bench_reads(genomes, 600)

    # scripts/bench_toy.py at 20 kb genomes and 300 reads: the genomes are
    # drawn between the filter builds, the reads after them
    record.clear()
    toy = _load_script(ROOT / "scripts" / "bench_toy.py", "jax_bench_toy_script")
    monkeypatch.setattr(toy, "GENOME_LEN", 20_000)
    monkeypatch.setattr(toy, "N_READS", 300)
    with pytest.raises(_Stop):
        toy.main()
    genomes, seqs = bench_toy.toy_workload(300, 20_000)
    assert [record[n].split(b"\n")[1] for n in bench_toy.NAMES] == [g.tobytes() for g in genomes]
    assert record["seqs"] == seqs

    # scripts/bench_build.py: the FASTA it builds from
    record.clear()
    build = _load_script(ROOT / "scripts" / "bench_build.py", "jax_bench_build_script")
    monkeypatch.setattr(sys, "argv", ["bench_build.py", "--mb", "0.05", "--runs", "1"])
    build.main()
    assert record["g"] == b">g\n" + bench_build.build_genome(0.05) + b"\n"


@pytest.fixture(scope="module")
def jax_bench_state(tmp_path_factory):
    """bench.py's own get_filters at 8 bins x 2 kb (16 kb genomes): the
    JAX package's four filters and the genomes as text."""
    script = _load_script(ROOT / "bench.py", "jax_bench_small")
    script.BINS_PER_FILTER = 8
    script.CACHE = tmp_path_factory.mktemp("jax_bench_cache")
    return script.get_filters(JaxParams(kmer_size=13, fragment_length=2000))


@pytest.fixture
def small_bench(jax_bench_state, monkeypatch):
    """tools/bench.py at jax_bench_state's geometry, its genome and bits
    checks held to the sha256 of jax_bench_state's genomes and filters."""
    filters, genomes = jax_bench_state
    monkeypatch.setattr(bench, "BINS_PER_FILTER", 8)
    monkeypatch.setattr(bench, "FRAGMENT", 2000)
    monkeypatch.setattr(bench, "GENOME_SHA", [hashlib.sha256(g.encode()).hexdigest() for g in genomes])
    monkeypatch.setattr(bench, "BITS_SHA", [hashlib.sha256(f.bits.tobytes()).hexdigest() for f in filters])
    return jax_bench_state


@pytest.fixture(scope="module")
def world(jax_bench_state):
    """Genome 0's filter as the target and genome 1's as the depletion
    filter, built by the JAX package, 256 reads of 1 kb (96 from each
    genome, 64 random), and the JAX engine's decisions on them at batch 64."""
    jax_filters, texts = jax_bench_state
    genomes = [np.frombuffer(t.encode(), dtype=np.uint8) for t in texts]
    rng = np.random.default_rng(5)
    seqs = (bench.reads_from(rng, genomes[0], 96, 1000) + bench.reads_from(rng, genomes[1], 96, 1000)
            + bench.reads_from(rng, bench.synth_genome(rng, 20_000), 64, 1000))
    seqs = [seqs[i] for i in rng.permutation(len(seqs))]
    want = JaxEngine(jax_filters[:1], jax_filters[1:2], error_rate=0.1, batch_size=64).classify_sequences(seqs)
    port = [ibf_from_numpy(vars(f)) for f in jax_filters[:2]]
    return port, seqs, [np.asarray(w) for w in want]


@pytest.mark.parametrize("tool", ["bench", "bench_toy", "profile_classify"])
def test_tool_decides_as_the_jax_engine(world, tool):
    (target, deplete), seqs, want = world
    if tool == "bench":
        out = bench.run_bench([target], [deplete], seqs, "cpu", batch=64, host_batch=128, runs=1)
        assert [int(c.sum()) for c in out["classified_by_run"]] == [int(want[0].sum())] * 2
    elif tool == "bench_toy":
        out = bench_toy.run_bench_toy([target], [deplete], seqs, "cpu", batch=64, runs=1)
    else:
        out = profile_classify.run_profile_classify([target], [deplete], seqs, "cpu", batch=64)
        assert set(out["line"]["stages_ms"]) == {
            "host_encode", "h2d_phase_a", "submit", "phase_a", "dispatch_b", "phase_b", "final_fetch"
        }
    for got, w in zip((out["classified"], out["best"], out["attempts"]), want):
        np.testing.assert_array_equal(got, w)
    assert 0 < int(want[0].sum()) < len(seqs)
    assert out["line"]["device"] == "cpu"


# per tool: argv (the script's own flags), module constants set small,
# and the JAX script's metric and keys, with what the port's line adds or drops
LINES = {
    "bench": (bench, ["--batch", "64", "--host-batch", "128"], {"N_READS": 256, "N_TIMED_RUNS": 1},
              "classify_reads_per_sec_realistic",
              {"metric", "value", "unit", "vs_baseline", "classified", "run_seconds"}),
    "bench_build": (bench_build, ["--mb", "0.05", "--runs", "2"], {}, "ibf_build_mbases_per_sec",
                    {"metric", "value", "unit", "genome_mb", "median_seconds", "runs", "peak_device_gb"}),
    "bench_toy": (bench_toy, [], {"GENOME_LEN": 20_000, "N_READS": 256, "BATCH_SIZE": 64, "N_TIMED_RUNS": 1},
                  "classify_reads_per_sec", {"metric", "value", "unit", "vs_baseline"}),
    "profile_classify": (profile_classify, ["--reads", "256"], {"BATCH_SIZE": 64}, "classify_serial_reads_per_sec",
                         {"metric", "value", "unit", "reads", "batch", "stages_ms"}),
}


@pytest.mark.parametrize("tool", sorted(LINES))
def test_main_prints_the_scripts_json_line_last(tool, request, monkeypatch, tmp_path, capsys):
    mod, argv, small, metric, keys = LINES[tool]
    if mod in (bench, profile_classify):
        request.getfixturevalue("small_bench")
        argv = argv + ["--cache", str(tmp_path)]
    for name, value in small.items():  # profile_classify's batch is bench.py's, as in the script
        monkeypatch.setattr(bench if mod is profile_classify else mod, name, value)
    assert mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == keys | {"device"}
    assert line["metric"] == metric and line["device"] == "cpu" and line["value"] > 0
    if tool == "bench_build":
        assert line["runs"] == 2 and line["genome_mb"] == 0.05 and line["peak_device_gb"] is None
    if mod in (bench, profile_classify):
        assert out.count("bits sha256 equal to the reference's") == 4
