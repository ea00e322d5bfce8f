"""The port's four probe tools against the JAX scripts, on the CPU.

* proto_counts_layout: ``flat_core`` with the row gather and with the
  element gather, bit-equal (tolerance 0) to the JAX script's
  ``_flat_core`` on the script's draw at R=16, L=40, W=2, 1,024 rows;
* dedup_probe: ``synth_codes`` draw for draw and ``bloom_and`` bit-equal
  to the script's;
* each tool's ``main([..., "--device", "cpu"])`` at a tiny size (its
  module constants shrunk) exits 0 and prints its JSON line last, with
  ``device`` "cpu";
* every gather_probe experiment runs on the CPU at a tiny ``m``, ``rows``
  and READS, and g3's AND equals numpy's on ``setup``'s inputs.

The JAX scripts are loaded by path (scripts/ on sys.path for their
``_bench_util`` import), and their import-time changes to the
environment and sys.path are put back.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readbouncer_tpu_torch.tools import dedup_probe, gather_probe, proto_counts_layout, transfer_probe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _load_script(name: str):
    saved_env, saved_path = dict(os.environ), list(sys.path)
    try:
        sys.path.insert(0, str(ROOT / "scripts"))
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        sys.path[:] = saved_path
    return mod


@pytest.mark.parametrize("elem_gather", [False, True], ids=["row_gather", "element_gather"])
def test_flat_core_is_bit_equal_to_the_script(elem_gather):
    script = _load_script("proto_counts_layout")
    rows = 1024
    bits, reads, lengths = proto_counts_layout.proto_inputs(16, 40, 2, rows)
    want = np.asarray(script._flat_core(jnp.asarray(bits), jnp.asarray(reads), jnp.asarray(lengths),
                                        k=13, h=3, rows=rows, elem_gather=elem_gather))
    got = proto_counts_layout.flat_core(
        torch.from_numpy(bits.view(np.int32)), torch.from_numpy(reads), torch.from_numpy(lengths),
        k=13, h=3, rows=rows, elem_gather=elem_gather,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dedup_draws_and_bloom_and_match_the_script(monkeypatch):
    script = _load_script("dedup_probe")
    rows = 4096
    monkeypatch.setattr(script, "ROWS", rows)  # the script's bloom_and reads its ROWS
    for dup in (0.0, 0.5, 0.9):
        want = script.synth_codes(np.random.default_rng(3), 2000, dup)
        got = dedup_probe.synth_codes(np.random.default_rng(3), 2000, dup)
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(4)
    tab = rng.integers(0, 1 << 32, size=(rows, dedup_probe.W), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(script.bloom_and(jnp.asarray(tab), jnp.asarray(got)))
    anded = dedup_probe.bloom_and(torch.from_numpy(tab.view(np.int32)), torch.from_numpy(got.astype(np.int64)), rows)
    np.testing.assert_array_equal(anded.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(dedup_probe.sum_u32(anded).numpy(), np.asarray(jnp.asarray(want).sum(axis=0)))


MAINS = {
    "proto_counts_layout": (proto_counts_layout, ["--reps", "1"], {"R": 16, "L": 120, "W": 2, "ROWS": 1024},
                            "proto_counts_layout_ms"),
    "dedup_probe": (dedup_probe, ["counts", "--dup", "0.5"], {"M": 2000, "ROWS": 4096}, "dedup_probe"),
    "gather_probe": (gather_probe, ["g3", "--m", "256", "--rows", "1024"], {}, "gather_probe_ms"),
    "transfer_probe": (transfer_probe, [], {"H2D_SIZES": (4 << 10, 64 << 10)}, "transfer_probe"),
}


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_main_prints_its_json_line_last(tool, monkeypatch, capsys):
    mod, argv, small, metric = MAINS[tool]
    for name, value in small.items():
        monkeypatch.setattr(mod, name, value)
    assert mod.main(argv + ["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == metric and line["device"] == "cpu"
    if tool == "proto_counts_layout":
        assert [v["match"] for v in line["variants"].values()] == ["ref", "OK", "OK", "OK", "OK"]
    if tool == "dedup_probe":
        assert line["sums_equal"] and line["u_pad"] >= line["unique"]


def test_every_gather_experiment_runs_and_g3_is_numpys_and(monkeypatch):
    monkeypatch.setattr(gather_probe, "READS", 4)
    for exp in gather_probe.EXPERIMENTS:
        res = gather_probe.run_gather_probe(exp, "cpu", m=256, rows=1024)
        assert res["line"]["exp"] == exp and res["line"]["device"] == "cpu"
        if exp == "gprod_nobar":
            assert res["ms"] is None and res["line"]["same_as"] == "gprod"
        else:
            assert res["ms"] > 0
    fn, args, *_ = gather_probe.setup("g3", 256, 1024, torch.device("cpu"))
    tab, idx3 = (t.numpy() for t in args)
    np.testing.assert_array_equal(fn(*args).numpy(), tab[idx3[0]] & tab[idx3[1]] & tab[idx3[2]])
