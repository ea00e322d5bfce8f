"""The port's GRU (K3's plain version, the framing and the forward)
against the JAX package: ``_gru_layer`` (lax.scan), the Pallas kernel
in interpret mode, ``gru_logits`` on the trained synth48 net, and
PyTorch's own ``nn.GRU``.

Tolerances: 1e-5 absolute on f32 hidden states and logits.  Both sides
run f32 products at full precision on the CPU; what differs is the
order of the sums inside each product, a few ulps per step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readbouncer_tpu.models.gru import GRUBasecallerModel as JaxModel
from readbouncer_tpu.models.gru import _gru_layer as jax_gru_layer
from readbouncer_tpu.models.gru import frame_signal as jax_frame_signal
from readbouncer_tpu.models.gru import frame_signal_jnp
from readbouncer_tpu.models.gru import gru_logits as jax_gru_logits
from readbouncer_tpu.models.gru import med_mad_normalize as jax_normalize
from readbouncer_tpu.models.weights import load_params_npz as jax_load_params
from readbouncer_tpu.models.weights import synth_weights_path as jax_synth_path
from readbouncer_tpu.ops.gru_pallas import gru_layer_pallas, gru_logits_pallas
from readbouncer_tpu.stream.replay import sequence_to_signal
from readbouncer_tpu_torch.models.gru import (
    GRUBasecallerModel,
    frame_signal,
    frame_signal_t,
    gru_logits,
    med_mad_normalize,
    params_from_jax,
)
from readbouncer_tpu_torch.models.weights import load_params_npz, synth_weights_path
from readbouncer_tpu_torch.ops import gru as ops

torch.set_num_threads(1)

ATOL = 1e-5


def _layer(rng, H):
    s = 1.0 / np.sqrt(H)
    return {
        "w_zrn": rng.uniform(-s, s, (H, 3 * H)).astype(np.float32),
        "b_zrn": rng.uniform(-s, s, 3 * H).astype(np.float32),
        "r_zr": rng.uniform(-s, s, (H, 2 * H)).astype(np.float32),
        "b_hzr": rng.uniform(-s, s, 2 * H).astype(np.float32),
        "rn": rng.uniform(-s, s, (H, H)).astype(np.float32),
        "bhn": rng.uniform(-s, s, H).astype(np.float32),
    }


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _synth48():
    return load_params_npz(synth_weights_path("synth48"))


def _signals(rng, n, length):
    """Normalised squiggles of random sequences, [n, length] f32."""
    out = []
    for _ in range(n):
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, length // 9 + 1))
        out.append(med_mad_normalize(sequence_to_signal(seq, rng=rng)[:length]))
    return np.stack(out)


@pytest.mark.parametrize("H", [48, 96])
def test_layer_plain_matches_jax_scan_and_pallas(H):
    """B=5 (no tile multiple), T=24; forward and reverse scans."""
    rng = np.random.default_rng(H)
    layer = _layer(rng, H)
    x = rng.normal(size=(5, 24, H)).astype(np.float32)
    xg = x @ layer["w_zrn"] + layer["b_zrn"]
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    want = np.asarray(jax_gru_layer(jl, jnp.asarray(x), "highest"))
    pallas = np.asarray(gru_layer_pallas(jl, jnp.asarray(xg), interpret=True))
    got = ops.gru_layer_plain(_t(layer), torch.from_numpy(xg)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    # reverse = flip, scan, flip; the wrapper on a CPU tensor is the plain loop
    want_rev = np.flip(np.asarray(jax_gru_layer(jl, jnp.asarray(np.flip(x, 1).copy()), "highest")), 1)
    before = ops.gru_layer.launches
    got_rev = ops.gru_layer(_t(layer), torch.from_numpy(xg), reverse=True).numpy()
    assert ops.gru_layer.launches == before  # the plain version launches nothing
    np.testing.assert_allclose(got_rev, want_rev, atol=ATOL, rtol=0)


def test_layer_plain_matches_torch_nn_gru():
    """PyTorch's GRU is the same reset-after form with gates in (r, z, n)
    order; loaded with the reordered weights it computes the same ys."""
    H = 48
    rng = np.random.default_rng(3)
    p = _layer(rng, H)
    x = rng.normal(size=(7, 30, H)).astype(np.float32)
    wz, wr, wn = np.split(p["w_zrn"], 3, axis=1)
    bz, br, bn = np.split(p["b_zrn"], 3)
    rz, rr = np.split(p["r_zr"], 2, axis=1)
    bhz, bhr = np.split(p["b_hzr"], 2)
    gru = torch.nn.GRU(H, H, batch_first=True)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.from_numpy(np.concatenate([wr.T, wz.T, wn.T])))
        gru.bias_ih_l0.copy_(torch.from_numpy(np.concatenate([br, bz, bn])))
        gru.weight_hh_l0.copy_(torch.from_numpy(np.concatenate([rr.T, rz.T, p["rn"].T])))
        gru.bias_hh_l0.copy_(torch.from_numpy(np.concatenate([bhr, bhz, p["bhn"]])))
        want = gru(torch.from_numpy(x))[0].numpy()
    xg = torch.from_numpy(x) @ torch.from_numpy(p["w_zrn"]) + torch.from_numpy(p["b_zrn"])
    np.testing.assert_allclose(ops.gru_layer_plain(_t(p), xg).numpy(), want, atol=ATOL, rtol=0)


def test_framing_matches_jax():
    rng = np.random.default_rng(4)
    sig = rng.normal(size=(3, 1601)).astype(np.float32)
    want = np.asarray(frame_signal_jnp(jnp.asarray(sig), 66, 5))
    got = frame_signal_t(torch.from_numpy(sig), 66, 5)
    assert got.shape == want.shape == (3, 308, 66)
    np.testing.assert_array_equal(got.numpy(), want)
    raw = rng.normal(100.0, 10.0, 777).astype(np.float32)
    np.testing.assert_array_equal(med_mad_normalize(raw), jax_normalize(raw))
    for s, m in ((raw, None), (raw[:40], None), (raw, 50)):
        np.testing.assert_array_equal(
            frame_signal(s, 66, 5, max_frames=m), jax_frame_signal(s, 66, 5, max_frames=m)
        )


def test_params_from_jax_gives_the_same_numbers():
    tree = jax_load_params(jax_synth_path("synth48"))
    mine = _synth48()
    state = params_from_jax(tree)
    assert list(state)[:4] == ["w_in", "b_in", "w_out", "b_out"]
    assert len(tree["layers"]) == 4 and tree["w_in"].shape == (66, 48)
    for k in ("w_in", "b_in", "w_out", "b_out"):
        np.testing.assert_array_equal(state[k].numpy(), tree[k])
        np.testing.assert_array_equal(mine[k], tree[k])
    for i, layer in enumerate(tree["layers"]):
        for k, v in layer.items():
            np.testing.assert_array_equal(state[f"layers.{i}.{k}"].numpy(), v)
            np.testing.assert_array_equal(mine["layers"][i][k], v)
    model = GRUBasecallerModel(mine, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert (model.window, model.hidden) == (66, 48)


def test_logits_match_jax_on_synth48():
    """The trained net on framed squiggles: plain forward, the model's
    kernel-path forward (plain loop on the CPU) against JAX gru_logits
    and gru_logits_pallas(interpret=True); argmax tokens equal."""
    rng = np.random.default_rng(5)
    sig = _signals(rng, 3, (64 - 1) * 5 + 66)
    frames = np.array(frame_signal_jnp(jnp.asarray(sig), 66, 5))  # [3, 64, 66]
    tree = jax_load_params(jax_synth_path("synth48"))
    jparams = {
        **{k: jnp.asarray(tree[k]) for k in ("w_in", "b_in", "w_out", "b_out")},
        "layers": [{k: jnp.asarray(v) for k, v in l.items()} for l in tree["layers"]],
    }
    want = np.asarray(jax_gru_logits(jparams, jnp.asarray(frames), precision="highest"))
    pallas = np.asarray(gru_logits_pallas(jparams, jnp.asarray(frames), precision="highest", interpret=True))
    model = GRUBasecallerModel(_synth48(), device="cpu")
    plain = gru_logits(model.params, torch.from_numpy(frames)).numpy()
    kern = model.logits(torch.from_numpy(frames)).numpy()
    for got in (plain, kern):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_tokens_from_f16_signal_match_jax():
    """The greedy path: an f16 signal batch in, uint8 argmax ids out."""
    rng = np.random.default_rng(6)
    sig = _signals(rng, 4, (80 - 1) * 5 + 66).astype(np.float16)
    jmodel = JaxModel(None, params_in=jax_load_params(jax_synth_path("synth48")))
    want = np.asarray(jmodel.tokens_from_signal(sig))
    got = GRUBasecallerModel(_synth48(), device="cpu").tokens_from_signal(torch.from_numpy(sig))
    assert got.dtype == torch.uint8 and got.shape == want.shape == (4, 80)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gru_layer_checks_its_operands():
    rng = np.random.default_rng(7)
    p = _t(_layer(rng, 8))
    xg = torch.zeros(2, 3, 24)
    with pytest.raises(ValueError, match="xg"):
        ops.gru_layer(p, xg.double())
    with pytest.raises(ValueError, match="xg"):
        ops.gru_layer(p, torch.zeros(2, 3, 23))
    with pytest.raises(ValueError, match="rn"):
        ops.gru_layer({**p, "rn": torch.zeros(8, 9)}, xg)
    with pytest.raises(ValueError, match="hidden width"):
        ops.gru_layer(_t(_layer(rng, 97)), torch.zeros(1, 1, 3 * 97))
    assert ops.gru_layer(p, torch.zeros(0, 3, 24)).shape == (0, 3, 8)
    assert ops.gru_layer(p, torch.zeros(2, 0, 24)).shape == (2, 0, 8)
