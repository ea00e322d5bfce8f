"""The port's copies of the replay harness against the JAX package's:
squiggle synthesis, the oracle caller, the tick cadence with unblock and
stop_receiving feedback, the action sender (pacing, CSV, retries), the
recorded-signal round trip and the run-control surface.  All bit-equal.
"""

import numpy as np
import pytest
import torch

from readbouncer_tpu.stream import actions as jax_actions
from readbouncer_tpu.stream import control as jax_control
from readbouncer_tpu.stream import replay as jax_replay
from readbouncer_tpu.utils import timing as jax_timing
from readbouncer_tpu_torch.errors import ConfigError
from readbouncer_tpu_torch.stream import actions, control, replay
from readbouncer_tpu_torch.utils import timing

torch.set_num_threads(1)


def _rand_seq(rng, n):
    return "".join("ACGTN"[i] for i in rng.integers(0, 5, n))


def test_sequence_to_signal_bit_equal():
    seq = _rand_seq(np.random.default_rng(0), 300)
    for kw in ({}, {"dwell_jitter": 3}, {"drift": 0.05}, {"samples_per_base": 7, "noise": 4.0}):
        got = replay.sequence_to_signal(seq, rng=np.random.default_rng(9), **kw)
        want = jax_replay.sequence_to_signal(seq, rng=np.random.default_rng(9), **kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(replay.sequence_to_signal(seq), jax_replay.sequence_to_signal(seq))


def test_oracle_caller_bit_equal():
    rng = np.random.default_rng(1)
    sigs = [replay.sequence_to_signal(_rand_seq(rng, int(n)), rng=rng) for n in (0, 1, 50, 177)]
    sigs.append(sigs[-1][:100])
    got = replay.NearestLevelBasecaller().basecall(sigs)
    assert got == jax_replay.NearestLevelBasecaller().basecall(sigs)


def _sources(pkg_a, pkg_b, n=7, channels=3, **kw):
    out = []
    for pkg in (pkg_a, pkg_b):
        rng = np.random.default_rng(2)
        reads = [
            pkg.ReplayRead(f"r{i}", rng.normal(100, 5, int(rng.integers(10, 9000))).astype(np.float32))
            for i in range(n)
        ]
        out.append(pkg.ReplaySource(reads=reads, channels=channels, **kw))
    return out


def _chunk_key(c):
    return (c.channel, c.read_number, c.read_id, c.chunk_index, c.classification, c.signal.tobytes())


def test_tick_cadence_and_feedback_bit_equal():
    """Every tick's chunks, the unblock / stop_receiving answers and the
    source counters, with actions sent after some ticks."""
    mine, ref = _sources(replay, jax_replay, chunk_classifier=lambda r, ci: 66 if ci == 1 else 83)
    tick = 0
    while not (mine.finished and ref.finished):
        a, b = mine.tick(), ref.tick()
        assert [_chunk_key(c) for c in a] == [_chunk_key(c) for c in b]
        for c in a[: tick % 3]:
            act = "unblock" if (tick + c.channel) % 2 else "stop_receiving"
            assert getattr(mine, act)(c.channel, c.read_number) == getattr(ref, act)(c.channel, c.read_number)
        assert mine.unblock(1, 10**6) is ref.unblock(1, 10**6) is False
        tick += 1
        assert tick < 200
    assert mine.stats == ref.stats and mine.stats["chunks_filtered"] > 0
    assert mine.stats["unblocked"] > 0 and mine.stats["stop_received"] > 0


class _Flaky:
    """An action sink whose first calls raise (transient failures)."""

    def __init__(self, fails):
        self.fails, self.calls = fails, []

    def unblock(self, channel, read_number):
        self.calls.append(("u", channel, read_number))
        if len(self.calls) <= self.fails:
            raise OSError("transient")
        return read_number % 2 == 0

    def stop_receiving(self, channel, read_number):
        self.calls.append(("s", channel, read_number))
        return True


def _send(pkg, out_dir, fails):
    sink = _Flaky(fails)
    sender = pkg.ActionSender(sink, out_dir, batch_size=3)
    sizes = []
    for i in range(11):
        sender.queue(pkg.Action(i % 4 + 1, i, f"r{i}", unblock=i % 3 != 0, seq_length=100 + i,
                                processing_seconds=0.5 * i))
        if i % 4 == 3:
            sizes.append((sender.flush(), sender.batch_size))
    sizes.append((sender.drain(), sender.batch_size))
    sender.close()
    rows = (out_dir / "read_until_decision_stats.csv").read_text().splitlines()
    return sizes, rows, sink.calls, (sender.succeeded, sender.failed, sender.retries)


def test_action_sender_bit_equal(tmp_path):
    for fails in (0, 2):
        got = _send(actions, tmp_path / f"port{fails}", fails)
        want = _send(jax_actions, tmp_path / f"jax{fails}", fails)
        assert got == want
    assert got[3][2] == 1 and len(got[1]) == 12  # one retry; header + 11 rows
    with pytest.raises(OSError):
        _send(actions, tmp_path / "dead", 10**6)


def test_recorded_signals_round_trip_across_packages(tmp_path):
    mine, ref = _sources(replay, jax_replay, n=4)
    for r, rr in zip(mine.reads, ref.reads):
        r.true_seq = rr.true_seq = "ACGT" * (len(r.read_id) + 1)
    mine.save_signals(tmp_path / "port.npz")
    ref.save_signals(tmp_path / "jax.npz")
    for path in (tmp_path / "port.npz", tmp_path / "jax.npz"):
        a = replay.ReplaySource.from_signals(path, channels=2)
        b = jax_replay.ReplaySource.from_signals(path, channels=2)
        assert [(r.read_id, r.true_seq, r.signal.tobytes()) for r in a.reads] == [
            (r.read_id, r.true_seq, r.signal.tobytes()) for r in b.reads
        ]
    bad = replay.ReplaySource(reads=[replay.ReplayRead("__seq__/x", np.zeros(3, np.float32))])
    with pytest.raises(ValueError, match="reserved"):
        bad.save_signals(tmp_path / "bad.npz")


def test_control_surface_and_timing_match(tmp_path):
    mine, ref = _sources(replay, jax_replay, n=2)
    a = control.ReplayConnection(mine, "fc1").connect()
    b = jax_control.ReplayConnection(ref, "fc1").connect()
    a.analysis.set_break_reads_after_seconds(0.25)
    b.analysis.set_break_reads_after_seconds(0.25)
    assert a.summary() == b.summary() and mine.chunk_samples == ref.chunk_samples == 1000
    assert (a.device.state(), a.acquisition.has_started()) == (b.device.state(), b.acquisition.has_started())
    with pytest.raises(ConfigError, match="no reads"):
        control.ReplayConnection(replay.ReplaySource(reads=[]), "empty").connect()
    m, r = timing.OnlineMean(), jax_timing.OnlineMean()
    for x in (0.5, 1.25, 3.0):
        assert m.add(x) == r.add(x)
    clock = timing.StopClock()
    clock.add(0.25)
    clock.start()
    clock.stop()
    assert clock.elapsed() >= 0.25 and not clock.running
    assert timing.Durations() == timing.Durations(-1.0, -1.0, 0.0, 0.0)
