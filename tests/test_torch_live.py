"""The port's live decisions against the JAX package: the device policy
(``live_decisions`` against ``jax_live_decisions`` and the numpy
policy) and ``LiveClassifier.decide`` on the tiny world of
tests/test_live_e2e.py across the 512 / mid / 2048 length buckets.
Decisions are integers and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readbouncer_tpu.classify.fused import jax_live_decisions
from readbouncer_tpu.classify.policy import live_decisions as np_live_decisions
from readbouncer_tpu.stream import scheduler as jax_scheduler
from readbouncer_tpu_torch.classify.fused import live_decisions
from readbouncer_tpu_torch.stream import scheduler
from torch_live_world import make_world

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("live"))


@pytest.mark.parametrize("F_t,F_d", [(3, 1), (2, 0), (0, 2)], ids=["both", "target_only", "deplete_only"])
def test_live_decisions_match_jax(F_t, F_d):
    rng = np.random.default_rng(F_t * 10 + F_d)
    R = 200

    def counts(F):
        c = rng.integers(0, 4, size=(R, F)).astype(np.int32)
        c[rng.random((R, F)) < 0.5] = 0
        return c

    t_b, d_b = counts(F_t), counts(F_d)
    t_r = np.where(rng.random(t_b.shape) < 0.3, 0, t_b).astype(np.int32)
    d_r = np.where(rng.random(d_b.shape) < 0.3, 0, d_b).astype(np.int32)
    args = [a if a.shape[1] else None for a in (d_b, t_b, d_r, t_r)]
    want = np.asarray(jax_live_decisions(*[None if a is None else jnp.asarray(a) for a in args]))
    got = live_decisions(*[None if a is None else torch.from_numpy(a) for a in args])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np_live_decisions(*args))
    assert set(np.unique(want)) >= ({0, 1, 2} if F_t and F_d else {1, 2} if F_t else {0, 1})


def _bucket_seqs(genomes, rng):
    """Sequences for every bucket (short, mid, long, past max_seq_len),
    more of them than one batch of each, and empty ones."""
    host, target = genomes["host"], genomes["target"]
    seqs = []
    for lo, hi in ((0, 512), (513, 1024), (1025, 2048), (2049, 2600)):
        for _ in range(10):
            n = int(rng.integers(lo, hi + 1))
            g = (host, target, None)[int(rng.integers(0, 3))]
            if g is None:
                seqs.append("".join("ACGT"[i] for i in rng.integers(0, 4, n)))
            else:
                s = int(rng.integers(0, len(g) - n))
                seqs.append(g[s : s + n])
    seqs += ["", "ACGT"]
    return seqs


@pytest.mark.parametrize("mid_len", [0, 1024], ids=["two_buckets", "mid_bucket"])
def test_live_classifier_decides_as_jax(world, mid_len):
    genomes, filters = world
    seqs = _bucket_seqs(genomes, np.random.default_rng(mid_len))
    cfg = dict(batch_size=8, mid_len=mid_len)
    port = scheduler.LiveClassifier(
        [filters["port"]["target"]], [filters["port"]["host"]], scheduler.LiveConfig(**cfg), device="cpu"
    )
    ref = jax_scheduler.LiveClassifier(
        [filters["jax"]["target"]], [filters["jax"]["host"]], jax_scheduler.LiveConfig(**cfg)
    )
    assert port.bucket_lens == ref.bucket_lens == ([512, 1024, 2048] if mid_len else [512, 2048])
    assert port._batch == ref._batch
    got = port.decide(seqs)
    np.testing.assert_array_equal(got, ref.decide(seqs))
    assert set(got.tolist()) == {0, 1, 2}
    assert port.decide([]).shape == (0,)


@pytest.mark.parametrize("kind", ["target_only", "deplete_only"])
def test_live_classifier_one_kind_decides_as_jax(world, kind):
    genomes, filters = world
    seqs = _bucket_seqs(genomes, np.random.default_rng(7))[::3]
    names = (["target"], []) if kind == "target_only" else ([], ["host"])
    port = scheduler.LiveClassifier(
        *[[filters["port"][n] for n in ns] for ns in names], scheduler.LiveConfig(batch_size=8), device="cpu"
    )
    ref = jax_scheduler.LiveClassifier(
        *[[filters["jax"][n] for n in ns] for ns in names], jax_scheduler.LiveConfig(batch_size=8)
    )
    np.testing.assert_array_equal(port.decide(seqs), ref.decide(seqs))
    with pytest.raises(ValueError, match="at least one filter"):
        scheduler.LiveClassifier([], [], scheduler.LiveConfig(), device="cpu")


def test_out_of_range_mid_len_is_ignored_as_in_the_reference():
    """Parity with a known fault of the reference (ADVICE r5,
    scheduler.py:100): a mid_len outside (512, max_seq_len) is dropped
    without a word.  The port keeps that, so both give the same buckets."""
    for mid in (0, 300, 512, 700, 2048, 4096):
        for max_len in (2048, 400):
            a = scheduler.LiveConfig(mid_len=mid, max_seq_len=max_len, batch_size=64)
            b = jax_scheduler.LiveConfig(mid_len=mid, max_seq_len=max_len, batch_size=64)
            widths = scheduler.live_bucket_widths(a)
            assert widths == jax_scheduler.live_bucket_widths(b)
            assert scheduler.live_bucket_batches(a, widths) == jax_scheduler.live_bucket_batches(b, widths)
    assert scheduler.live_bucket_widths(scheduler.LiveConfig(mid_len=4096)) == [512, 2048]
