"""The port's live measurement tool (readbouncer_tpu_torch/tools/bench_live.py)
against scripts/bench_live.py and the JAX package's live sampler; the
build tool and the bench filter cache against the JAX package; and the
five measurement tools' refusal to run without a card unless asked.

* The read set and squiggles, draw for draw: the script's own ``main``
  at a small size (random reads included) with bench.py's filter loader
  and the replay source replaced by recorders.
* The run: run_bench_live with the Oracle caller on a tiny replay gives
  every read the action the JAX ``AdaptiveSampler`` gives it.
* ``main(... --device cpu)`` with the synth48 GRU, at 8 bins x 2 kb,
  prints as its last line the script's JSON line plus ``device``; a
  DeepNano net whose weights are not in the repository fails with the
  loader's message before any filter is built.
* run_bench_build's bits equal the JAX ``build_ibf``'s on the same
  FASTA; a filter loaded from the bench cache is held to the reference's
  sha256 as a built one is.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from readbouncer_tpu.ibf.build import build_ibf as jax_build_ibf
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu.stream import replay as jax_replay
from readbouncer_tpu.stream import scheduler as jax_scheduler
from readbouncer_tpu_torch.ibf.storage import ibf_from_numpy
from readbouncer_tpu_torch.tools import bench, bench_build, bench_live, bench_toy, profile_classify
from test_torch_bench_tools import _load_script, _Stop, jax_bench_state, small_bench  # noqa: F401  (fixtures)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_live_reads_and_squiggles_are_the_scripts_draw_for_draw(monkeypatch):
    genomes = [bench.bench_genome(i, 30_000) for i in range(4)]
    jax_bench = _load_script(ROOT / "bench.py", "bench")
    monkeypatch.setitem(sys.modules, "bench", jax_bench)
    monkeypatch.setattr(jax_bench, "get_filters", lambda params: ([None] * 4, [g.tobytes().decode() for g in genomes]))
    seen = {}

    def source(reads, channels):
        seen["reads"] = reads
        raise _Stop

    monkeypatch.setattr(jax_replay, "ReplaySource", source)
    script = _load_script(ROOT / "scripts" / "bench_live.py", "jax_bench_live_script")
    monkeypatch.setattr(sys, "argv", ["bench_live.py", "--reads", "20", "--read-bases", "500", "--random-frac", "0.25"])
    with pytest.raises(_Stop):
        script.main()
    got = bench_live.live_workload(genomes, 20, 500, 0.25)
    assert [r.read_id for r in seen["reads"]] == [rid for rid, _, _, _ in got]
    assert [r.true_seq for r in seen["reads"]] == [seq for _, _, seq, _ in got]
    for r, (_, sig, _, _) in zip(seen["reads"], got):
        np.testing.assert_array_equal(r.signal, sig)
    assert sorted(o for *_, o in got) == [-1] * 5 + [0] * 7 + [3] * 8


def test_live_tool_acts_on_every_read_as_the_jax_sampler(jax_bench_state, tmp_path):
    jax_all, texts = jax_bench_state
    genomes = [np.frombuffer(t.encode(), dtype=np.uint8) for t in texts]
    jax_filters = [jax_all[0], jax_all[3]]
    workload = bench_live.live_workload(genomes, 8, 2000)
    target, deplete = (ibf_from_numpy(vars(f)) for f in jax_filters)
    out = bench_live.run_bench_live([target], [deplete], workload, bench_live.make_caller("oracle"), "cpu",
                                    channels=4, batch=8)
    cfg = jax_scheduler.LiveConfig(batch_size=8)
    src = jax_replay.ReplaySource(
        reads=[jax_replay.ReplayRead(rid, sig.copy(), seq) for rid, sig, seq, _ in workload], channels=4
    )
    sampler = jax_scheduler.AdaptiveSampler(
        src, jax_replay.NearestLevelBasecaller(), jax_scheduler.LiveClassifier(jax_filters[:1], jax_filters[1:], cfg),
        output_dir=tmp_path / "jax", cfg=cfg,
    )
    want = sampler.run()
    assert (out["line"]["unblocked"], out["line"]["stop_received"]) == (want.unblocked, want.stop_received) == (4, 4)
    assert {r.read_id: (r.unblocked, r.stopped) for r in out["reads"]} == {
        r.read_id: (r.unblocked, r.stopped) for r in src.reads
    }
    assert all(r.unblocked == (origin == 3) for r, (*_, origin) in zip(out["reads"], workload))


def test_main_prints_the_scripts_json_line_last(small_bench, tmp_path, capsys):
    argv = ["--reads", "8", "--read-bases", "2000", "--channels", "4", "--batch", "8", "--caller", "synth48",
            "--cache", str(tmp_path), "--device", "cpu"]
    assert bench_live.main(argv) == 0
    out = capsys.readouterr().out
    assert "# basecaller warmup" in out and "# tail(>=p95)" in out and "Reads unblocked" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == {
        "metric", "value", "p95_ms", "max_ms", "ticks", "channels", "reads", "unblocked", "stop_received",
        "within_0.4s_budget_pct", "wall_seconds", "device",
    }
    assert line["metric"] == "live_p50_tick_latency_ms" and line["device"] == "cpu"
    assert (line["reads"], line["channels"], line["unblocked"], line["stop_received"]) == (8, 4, 4, 4)


def test_missing_deepnano_net_fails_with_the_loaders_message(tmp_path, capsys):
    rc = bench_live.main(["--caller", "48", "--cache", str(tmp_path / "c"), "--device", "cpu"])
    assert rc != 0 and "rnn48.txt not found" in capsys.readouterr().err
    assert not (tmp_path / "c").exists()  # no filter was built


def test_tools_raise_without_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (bench, bench_build, bench_live, bench_toy, profile_classify):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--cache", str(tmp_path)] if mod in (bench, bench_live, profile_classify) else [])
    assert not any(tmp_path.iterdir())


def test_build_tool_builds_as_the_jax_package(tmp_path):
    genome = bench_build.build_genome(0.05)
    out = bench_build.run_bench_build(genome, "cpu", runs=2)
    path = tmp_path / "g.fasta"
    path.write_bytes(b">g\n" + genome + b"\n")
    want, _ = jax_build_ibf([path], JaxParams(kmer_size=13, fragment_length=100_000), name="g")
    assert out["bits_sha"] == [hashlib.sha256(want.bits.tobytes()).hexdigest()] * 2


def test_bench_filters_hold_cached_files_to_the_reference(small_bench, tmp_path):
    built, _ = bench.bench_filters("cpu", tmp_path)
    loaded, _ = bench.bench_filters("cpu", tmp_path)  # every file now comes from the cache
    assert all(np.array_equal(a.bits, b.bits) for a, b in zip(built, loaded))
    built[1].save(tmp_path / f"{bench.bench_name(0)}.ribf")  # a stale file under genome 0's name
    with pytest.raises(RuntimeError, match="bits differ from the reference's bench filter"):
        bench.bench_filters("cpu", tmp_path)
