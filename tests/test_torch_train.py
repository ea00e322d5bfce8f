"""The port's CTC trainer (models/train.py), its metrics (models/eval.py)
and tools/train_basecaller.py against the JAX package's.

Tolerances: the loss within 1e-5 relative and each gradient leaf within
1e-4 of its largest magnitude of JAX's ``ctc_loss(precision="highest")``
on a batch with ragged frame and label lengths; four steps of the
trainer's optimizer (global-norm clip 1.0, Adam, optax's cosine decay)
within 2e-5 relative in the loss and 1e-5 in the params of optax's
chain, which ``clip_grad_norm_`` dividing by ``norm + 1e-6`` where optax
divides by ``norm`` leaves room for; the data-parallel step over 8 CPU
shards within 1e-5 of the single step (SGD: Adam's first step is
lr * g / (|g| + eps), about lr * sign(g), which turns the rounding of a
gradient near 0 into a difference of up to 2 * lr)."""

import importlib.util
import math
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from readbouncer_tpu.models import eval as jax_eval
from readbouncer_tpu.models import train as jax_train
from readbouncer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from readbouncer_tpu_torch.models import eval as port_eval
from readbouncer_tpu_torch.models.gru import LAYER_KEYS
from readbouncer_tpu_torch.models.train import (
    cosine_decay,
    ctc_loss,
    init_gru_params,
    make_sharded_train_step,
    make_train_step,
    param_leaves,
    param_tree,
    synthetic_ctc_batch,
)
from readbouncer_tpu_torch.models.weights import load_params_npz
from readbouncer_tpu_torch.parallel.mesh import make_mesh
from readbouncer_tpu_torch.tools import train_basecaller

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOP = ("w_in", "b_in", "w_out", "b_out")


def _leaves_np(tree):
    """A JAX / numpy tree's leaves in the port's ``param_leaves`` order."""
    return [np.asarray(tree[k]) for k in TOP] + [np.asarray(l[k]) for l in tree["layers"] for k in LAYER_KEYS]


def _flat(params):
    return torch.cat([p.detach().reshape(-1) for p in param_leaves(params)]).numpy()


def test_init_gru_params_layout():
    """Same tree, shapes and dtypes as the JAX package's; zero biases,
    Glorot-normal weights; leaves require grad; a seed fixes the draw."""
    H, window, layers = 24, 66, 3
    params = init_gru_params(torch.Generator().manual_seed(0), hidden=H, window=window, num_layers=layers)
    ref = jax_train.init_gru_params(jax.random.PRNGKey(0), hidden=H, window=window, num_layers=layers)
    assert set(params) == set(ref) and len(params["layers"]) == len(ref["layers"]) == layers
    assert all(set(l) == set(r) for l, r in zip(params["layers"], ref["layers"]))
    for got, want in zip(param_leaves(params), _leaves_np(ref)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32 and got.requires_grad
        if got.dim() == 1:
            assert not got.any()
        else:
            std = math.sqrt(2.0 / sum(got.shape))
            assert abs(float(got.detach().std()) / std - 1) < 0.1
    again = init_gru_params(torch.Generator().manual_seed(0), hidden=H, window=window, num_layers=layers)
    np.testing.assert_array_equal(_flat(again), _flat(params))


def test_synthetic_ctc_batch_matches_jax():
    for seed in (0, 5):
        got = synthetic_ctc_batch(np.random.default_rng(seed), batch=6, frames_t=30, window=8, max_label=7)
        want = jax_train.synthetic_ctc_batch(np.random.default_rng(seed), batch=6, frames_t=30, window=8,
                                            max_label=7)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_ctc_loss_and_gradients_match_jax():
    """B=4, 2 layers, H=16, ragged frame and label lengths; the JAX params
    carried over by params_from_jax (param_tree)."""
    rng = np.random.default_rng(0)
    ref = jax_train.init_gru_params(jax.random.PRNGKey(1), hidden=16, window=8, num_layers=2)
    frames, frame_lens, labels, label_lens = synthetic_ctc_batch(rng, batch=4, frames_t=24, window=8, max_label=6)
    frame_lens = np.array([24, 21, 18, 24], np.int32)
    assert len(set(label_lens.tolist())) > 1
    batch = (frames, frame_lens, labels, label_lens)
    want_loss, want_grads = jax.value_and_grad(jax_train.ctc_loss)(ref, *batch, precision="highest")
    params = param_tree(jax.tree.map(np.asarray, ref), device="cpu")
    loss = ctc_loss(params, *batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for p, w in zip(param_leaves(params), _leaves_np(want_grads)):
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_optimizer_steps_match_optax():
    """Four steps of clip_grad_norm_(1.0) + Adam + LambdaLR(cosine_decay)
    against optax.chain(clip_by_global_norm(1.0), adam(cosine_decay_schedule))."""
    rng = np.random.default_rng(0)
    steps, lr = 4, 2e-2
    ref = jax_train.init_gru_params(jax.random.PRNGKey(1), hidden=16, window=8, num_layers=2)
    batches = [synthetic_ctc_batch(rng, batch=4, frames_t=24, window=8, max_label=6) for _ in range(steps)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.05)))
    jstep, jstate, jparams = jax_train.make_train_step(tx, precision="highest"), tx.init(ref), ref
    params = param_tree(jax.tree.map(np.asarray, ref), device="cpu")
    step = make_train_step(lambda leaves: torch.optim.Adam(leaves, lr=lr), max_grad_norm=1.0)
    opt = step.init(params)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(steps, alpha=0.05))
    for b in batches:
        jparams, jstate, jloss = jstep(jparams, jstate, b)
        params, opt, loss = step(params, opt, b)
        sched.step()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    np.testing.assert_allclose(_flat(params), np.concatenate([x.ravel() for x in _leaves_np(jparams)]),
                               rtol=0, atol=1e-5)
    assert [cosine_decay(10, 0.05)(c) for c in (0, 10, 20)] == pytest.approx(
        [float(optax.cosine_decay_schedule(1.0, 10, alpha=0.05)(c)) for c in (0, 10, 20)])


def test_sharded_step_matches_single_step():
    """data:8 over 8 CPU shards against one step on the whole batch of 16
    (both SGD); the loss also equals the JAX sharded step's on its 8
    virtual devices (same params, Adam)."""
    rng = np.random.default_rng(0)
    batch = synthetic_ctc_batch(rng, batch=16, frames_t=24, window=8, max_label=6)
    ref = jax_train.init_gru_params(jax.random.PRNGKey(2), hidden=16, window=8)
    results = []
    for make in (lambda f: make_train_step(f), lambda f: make_sharded_train_step(make_mesh("data:8", ["cpu"] * 8), f)):
        params = param_tree(jax.tree.map(np.asarray, ref), device="cpu")
        step = make(lambda leaves: torch.optim.SGD(leaves, lr=0.1))
        params, _, loss = step(params, step.init(params), batch)
        results.append((float(loss), _flat(params)))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=0, atol=1e-5)
    tx = optax.adam(1e-3)
    _, _, jloss = jax_train.make_sharded_train_step(jax_make_mesh({"data": 8, "bins": 1}), tx)(ref, tx.init(ref), batch)
    np.testing.assert_allclose(results[1][0], float(jloss), rtol=1e-5)


def test_eval_matches_jax():
    rng = np.random.default_rng(4)
    strs = ["", "A", "ACGT"] + ["".join("ACGT"[i] for i in rng.integers(0, 4, int(n))) for n in rng.integers(1, 60, 12)]
    for a in strs:
        for b in strs[::3]:
            assert port_eval.levenshtein(a, b) == jax_eval.levenshtein(a, b)
            assert port_eval.sequence_identity(a, b) == jax_eval.sequence_identity(a, b)
    assert port_eval.levenshtein("ACGT", "AGGT") == 1 and port_eval.sequence_identity("ACGT", "AGGT") == 0.75
    assert port_eval.batch_identity(strs[3:], strs[:-3:-1] * 6) == jax_eval.batch_identity(strs[3:], strs[:-3:-1] * 6)
    assert port_eval.batch_identity([], []) == 0.0


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_script", ROOT / "scripts" / "train_basecaller.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_basecaller_tool(tmp_path, capsys):
    """make_batch equals the JAX script's draw for draw; two fine-tuning
    steps from the tracked synth48 net on the CPU keep its identity and
    save to --out, which the tool requires (the tracked net is never its
    default target)."""
    script = _jax_script()
    for kw in ({}, {"jitter": 2, "drift": 0.05}):
        got = train_basecaller.make_batch(np.random.default_rng(7), 3, 40, **kw)
        want = script.make_batch(np.random.default_rng(7), 3, 40, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(SystemExit):
        train_basecaller.parse_args(["--steps", "1"])
    tracked = ROOT / "data" / "gru_synth48.npz"
    before = tracked.read_bytes()
    out = tmp_path / "tuned.npz"
    assert train_basecaller.main(["--device", "cpu", "--steps", "2", "--batch", "4", "--init", str(tracked),
                                  "--out", str(out)]) == 0
    text = capsys.readouterr().out
    ident = float(text.split("eval_identity=clean ")[1].split()[0])
    assert ident >= 0.95 and "ms per step on cpu" in text
    assert tracked.read_bytes() == before
    tuned = load_params_npz(out)
    assert [np.shape(x) for x in _leaves_np(tuned)] == [np.shape(x) for x in _leaves_np(load_params_npz(tracked))]
