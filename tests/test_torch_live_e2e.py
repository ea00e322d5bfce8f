"""The port's live sampler against the JAX package's on the tiny world of
tests/test_live_e2e.py: the same replayed reads through both
``AdaptiveSampler``s give the same counters, per-read outcomes, output
FASTAs and decision CSV rows (all but the timing column), with the
Oracle caller (depletion, once_seen concat, the give-up, target-only,
SIGINT stop) and with the trained synth48 GRU (tick by tick and with
overlap_ticks)."""

import os
import signal

import numpy as np
import pytest
import torch

from readbouncer_tpu.models.basecaller import GRUBasecaller as JaxCaller
from readbouncer_tpu.stream import replay as jax_replay
from readbouncer_tpu_torch.models.basecaller import GRUBasecaller
from readbouncer_tpu_torch.stream import replay
from torch_live_world import make_reads, make_world, rand_seq, run_live

torch.set_num_threads(1)

ORACLES = {"port": replay.NearestLevelBasecaller, "jax": jax_replay.NearestLevelBasecaller}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("live_e2e"))


@pytest.fixture(scope="module")
def grus():
    return {
        "port": GRUBasecaller(network="synth48", max_frames=320, device="cpu"),
        "jax": JaxCaller(network="synth48", max_frames=320),
    }


def _both(tmp_path, world, reads, callers, **kw):
    _, filters = world
    out = {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = run_live(pkg, filters, reads, d, callers[pkg](), **kw)[0]
    assert out["port"] == out["jax"]
    return out["port"]


def test_oracle_depletion_run_as_jax(world, tmp_path):
    genomes, _ = world
    rng = np.random.default_rng(1)
    reads = make_reads(rng, genomes["host"], 3, 4000, "host") + make_reads(rng, genomes["target"], 3, 4000, "tgt")
    got = _both(tmp_path, world, reads, ORACLES)
    assert got["stats"][2:4] == (3, 3)  # unblocked, stop_received
    assert got["source"]["unblocked"] == 3 and got["source"]["samples_saved"] > 0
    assert got["fasta"]["DepletedReads.fasta"].count(">host_") == 3


def test_oracle_once_seen_concat_and_give_up_as_jax(world, tmp_path):
    """A read whose first chunk is junk (decided on the concatenation of
    its chunks) and one that matches nothing and passes give_up_len."""
    genomes, _ = world
    rng = np.random.default_rng(2)
    late = rand_seq(rng, 200) + genomes["host"][1000:3500]
    mystery = rand_seq(rng, 2500)
    reads = [(rid, jax_replay.sequence_to_signal(s, rng=rng), s) for rid, s in (("late", late), ("mystery", mystery))]
    got = _both(tmp_path, world, reads, ORACLES, targets=(), max_ticks=50)
    assert got["stats"][2:4] == (1, 1)
    assert ">late" in got["fasta"]["DepletedReads.fasta"] and ">mystery" in got["fasta"]["TargetReads.fasta"]


def test_oracle_target_only_and_mid_bucket_as_jax(world, tmp_path):
    genomes, _ = world
    rng = np.random.default_rng(3)
    reads = make_reads(rng, genomes["target"], 2, 3000, "tgt") + make_reads(rng, genomes["host"], 2, 3000, "off")
    got = _both(tmp_path, world, reads, ORACLES, depletes=(), channels=3, mid_len=1024, max_ticks=60)
    assert got["stats"][2:4] == (2, 2)


def test_oracle_sigint_stop_as_jax(world, tmp_path):
    """SIGINT at the third basecall stops both runs after the same tick:
    actions drained, reads left unfinished, the same partial outputs."""
    genomes, _ = world
    rng = np.random.default_rng(4)
    reads = make_reads(rng, genomes["host"], 6, 4000, "host")

    def interrupting(base):
        class Interrupting(base):
            calls = 0

            def basecall(self, signals):
                Interrupting.calls += 1
                if Interrupting.calls == 3:
                    os.kill(os.getpid(), signal.SIGINT)
                return super().basecall(signals)

        return Interrupting

    callers = {pkg: interrupting(cls) for pkg, cls in ORACLES.items()}
    before = signal.getsignal(signal.SIGINT)
    got = _both(tmp_path, world, reads, callers, channels=2, max_ticks=None, handle_sigint=True)
    assert signal.getsignal(signal.SIGINT) is before
    assert got["source"]["reads_started"] < 6 and got["stats"][4] == 3  # stopped after tick 3


@pytest.mark.parametrize("overlap", [False, True], ids=["tick_by_tick", "overlap_ticks"])
def test_synth48_run_as_jax(world, tmp_path, grus, overlap):
    genomes, _ = world
    rng = np.random.default_rng(5)
    reads = make_reads(rng, genomes["host"], 2, 2500, "host") + make_reads(rng, genomes["target"], 2, 2500, "tgt")
    got = _both(tmp_path, world, reads, {k: (lambda v=v: v) for k, v in grus.items()},
                overlap_ticks=overlap, max_ticks=40)
    assert got["stats"][2:4] == (2, 2)
    assert got["stats"][1] == 0
