"""The port's graft-entry contract (``readbouncer_tpu_torch/graft_entry.py``)
against the JAX one (``__graft_entry__.py``), on the CPU.

* ``entry()``'s forward with the params of JAX's
  ``init_gru_params(PRNGKey(0), hidden=48)`` carried over by
  ``params_from_jax`` is within 1e-4 (absolute) of the JAX contract's
  ``fn``, on its zero frames and on numpy-seeded random frames;
* ``dryrun_steps`` at n=8 and n=2 with ``device="cpu"``: the per-filter
  maxima bit-equal and the decisions equal to the same JAX steps on the
  8-device CPU mesh of tests/conftest.py, and the loss within rtol 1e-5,
  as tests/test_parallel.py compares the sharded train step.

The JAX contract's ``dryrun_multichip`` returns nothing, so ``_jax_steps``
repeats its body with the results kept: it must follow
``__graft_entry__.py::dryrun_multichip`` (its lines 60-111) step for
step.  The dryrun test also runs the contract itself at the same n, so
the copy cannot stand in for a contract that no longer runs.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as jax_contract
from readbouncer_tpu.classify.math import ci_and_threshold_batch as jax_thresholds
from readbouncer_tpu.ibf.query import FilterStack as JaxStack
from readbouncer_tpu.ibf.storage import IBFData as JaxIBF
from readbouncer_tpu.models.train import init_gru_params as jax_init
from readbouncer_tpu.models.train import make_sharded_train_step as jax_sharded_step
from readbouncer_tpu.models.train import synthetic_ctc_batch as jax_ctc_batch
from readbouncer_tpu.parallel.mesh import BINS_AXIS, DATA_AXIS
from readbouncer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from readbouncer_tpu.parallel.sharded import ShardedFilterStack as JaxSharded
from readbouncer_tpu.parallel.sharded import ShardedLiveClassifier as JaxShardedLive
from readbouncer_tpu.stream.scheduler import LiveConfig as JaxLiveConfig
from readbouncer_tpu_torch import graft_entry
from readbouncer_tpu_torch.models.train import param_tree

torch.set_num_threads(1)


def _jax_steps(n: int) -> dict:
    """__graft_entry__.dryrun_multichip's three steps on jax.devices()[:n],
    with their results kept; follows __graft_entry__.py:60-111."""
    bins_shards = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = jax_make_mesh({DATA_AXIS: n // bins_shards, BINS_AXIS: bins_shards}, jax.devices()[:n])
    rng = np.random.default_rng(7)
    k, h, rows = 13, 3, 512
    filters = []
    for name in ("target", "deplete"):
        bits = rng.integers(0, 1 << 32, size=(rows, 2), dtype=np.uint32)
        filters.append(JaxIBF(kmer_size=k, hash_functions=h, num_bins=50, bits=bits,
                              fragment_length=1000, name=name))
    sharded = JaxSharded(JaxStack(filters), mesh)
    R, L = 4 * (n // bins_shards), 64
    reads = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    lengths = np.full((R,), L, dtype=np.int32)
    thr_b = jax_thresholds(lengths, k, 0.1, 0.95)
    thr_r = jax_thresholds(lengths, k, 0.08, 0.95)
    mb, mr = sharded.max_counts_dual(reads, lengths, np.asarray(thr_b), np.asarray(thr_r))
    live = JaxShardedLive(filters[:1], filters[1:], JaxLiveConfig(batch_size=max(32, R), max_seq_len=512), mesh)
    dec = live.decide(["".join("ACGT"[b] for b in row) for row in reads])
    params = jax_init(jax.random.PRNGKey(0), hidden=48)
    optimizer = optax.adam(1e-3)
    step = jax_sharded_step(mesh, optimizer)
    _, _, loss = step(params, optimizer.init(params), jax_ctc_batch(rng, batch=R, frames_t=48))
    return {"mb": np.asarray(mb), "mr": np.asarray(mr), "decisions": np.asarray(dec), "loss": float(loss)}


def test_entry_forward_matches_the_jax_contract():
    jax_fn, (frames,) = jax_contract.entry()
    jax_params = jax_init(jax.random.PRNGKey(0), hidden=48)
    fn, (port_frames,) = graft_entry.entry("cpu", params=param_tree(jax_params, "cpu"))
    assert tuple(port_frames.shape) == frames.shape == (8, 128, 66)
    assert port_frames.dtype == torch.float32 and not port_frames.any()
    rand = np.random.default_rng(0).standard_normal((8, 128, 66), dtype=np.float32)
    for x in (frames, rand):
        want = np.asarray(jax_fn(x))
        got = fn(torch.from_numpy(x))
        assert tuple(got.shape) == want.shape == (8, 128, 5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_entry_defaults_to_the_card_and_seeds_its_own_params():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry.entry()
    fn, (frames,) = graft_entry.entry("cpu")
    fn2, _ = graft_entry.entry("cpu")
    out = fn(frames + 0.5)
    assert tuple(out.shape) == (8, 128, 5) and bool(torch.isfinite(out).all())
    assert torch.equal(out, fn2(frames + 0.5))  # the same seeded init


@pytest.mark.parametrize("n", [8, 2])
def test_dryrun_steps_match_the_jax_steps(n):
    want = _jax_steps(n)
    params = param_tree(jax_init(jax.random.PRNGKey(0), hidden=48), "cpu")
    got = graft_entry.dryrun_steps(n, "cpu", params=params)
    assert got["mesh"] == {"data": n // 2, "bins": 2}
    np.testing.assert_array_equal(got["mb"].numpy(), want["mb"])
    np.testing.assert_array_equal(got["mr"].numpy(), want["mr"])
    np.testing.assert_array_equal(got["decisions"], want["decisions"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    jax_contract.dryrun_multichip(n)
    graft_entry.dryrun_multichip(n, "cpu")
