"""The port's GRUBasecaller on the CPU against the JAX package's: the same
decoded reads for uniform, ragged and split batches and for the beam
decoder on the trained synth48 net; the rnn*.txt parser on a net this
test writes; read identity on synthetic chunks.

Reads are compared for equality: the tokens are argmaxes of logits that
agree to ~1e-6 (tests/test_torch_gru.py), and the signal crosses to both
forwards as the same f16 values.
"""

import numpy as np
import pytest
import torch

from readbouncer_tpu.models.basecaller import GRUBasecaller as JaxCaller
from readbouncer_tpu.models.eval import batch_identity
from readbouncer_tpu.models.weights import load_deepnano_weights as jax_load_deepnano
from readbouncer_tpu.stream.replay import sequence_to_signal
from readbouncer_tpu_torch.errors import WeightsError
from readbouncer_tpu_torch.models.basecaller import GRUBasecaller
from readbouncer_tpu_torch.models.weights import load_deepnano_weights

torch.set_num_threads(1)

T = 320  # frames of one 0.4 s chunk at 4 kHz, padded to a multiple of 64


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _pair(**kw):
    return GRUBasecaller(device="cpu", **kw), JaxCaller(**kw)


@pytest.fixture(scope="module")
def synth48():
    return _pair(network="synth48", max_frames=T)


def test_uniform_chunks_decode_as_jax(synth48):
    """The steady live tick: equal-length 1,600-sample chunks (the
    vectorised median/MAD path)."""
    port, ref = synth48
    rng = np.random.default_rng(1)
    sigs = [sequence_to_signal(_rand_seq(rng, 200), rng=rng)[:1600] for _ in range(6)]
    assert {len(s) for s in sigs} == {1600}
    got = port.basecall(sigs)
    assert got == ref.basecall(sigs)
    assert all(len(s) > 100 for s in got)


def test_ragged_batch_decodes_as_jax(synth48):
    port, ref = synth48
    rng = np.random.default_rng(2)
    sigs = [sequence_to_signal(_rand_seq(rng, int(n)), rng=rng) for n in (3, 40, 120, 177, 60)]
    assert port.basecall(sigs) == ref.basecall(sigs)
    assert port.basecall([]) == ref.basecall([]) == []


def test_split_batch_decodes_as_jax():
    """Past split_threshold the batch goes as two halves."""
    port, ref = _pair(network="synth48", max_frames=T, split_threshold=4)
    rng = np.random.default_rng(3)
    sigs = [sequence_to_signal(_rand_seq(rng, 178), rng=rng) for _ in range(7)]
    got = port.basecall(sigs)
    assert got == ref.basecall(sigs)
    port.split_threshold = 256
    assert port.basecall(sigs) == got


def test_beam_decoder_decodes_as_jax():
    port, ref = _pair(network="synth48", max_frames=64, decoder="beam")
    rng = np.random.default_rng(4)
    sigs = [sequence_to_signal(_rand_seq(rng, int(n)), rng=rng) for n in (20, 35)]
    got = port.basecall(sigs)
    assert got == ref.basecall(sigs)
    assert all(got)


def _write_rnn(path, rng, H):
    """A DeepNano-blitz rnn*.txt net: 52 (dims, values) line pairs."""
    shapes = [(66, H), (H,)]
    for _ in range(4):
        shapes += [(H, H), (H, H), (H,), (H,), (H, H), (H, H), (H, H), (H, H), (H,), (H,), (H,), (H,)]
    shapes += [(H, 5), (5,)]
    with open(path, "w") as f:
        for shp in shapes:
            vals = rng.uniform(-0.4, 0.4, size=int(np.prod(shp)))
            f.write(" ".join(map(str, shp)) + "\n" + " ".join(repr(float(v)) for v in vals) + "\n")


@pytest.mark.parametrize("gate_order", ["zrn", "rzn"])
def test_rnn_txt_parser_and_caller_match_jax(tmp_path, gate_order):
    rng = np.random.default_rng(5)
    _write_rnn(tmp_path / "rnn16.txt", rng, 16)
    mine = load_deepnano_weights(tmp_path / "rnn16.txt", gate_order=gate_order)
    ref = jax_load_deepnano(tmp_path / "rnn16.txt", gate_order=gate_order)
    for k in ("w_in", "b_in", "w_out", "b_out"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(ref, k))
    for a, b in zip(mine.layers, ref.layers):
        for k in vars(b):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    port, jax_caller = _pair(network="16", weights_dir=str(tmp_path), gate_order=gate_order, max_frames=T)
    sigs = [sequence_to_signal(_rand_seq(rng, 150), rng=rng) for _ in range(3)]
    assert port.basecall(sigs) == jax_caller.basecall(sigs)
    (tmp_path / "rnn17.txt").write_text("2 2\n1 2 3\n")
    with pytest.raises(WeightsError, match="expected 4 values"):
        load_deepnano_weights(tmp_path / "rnn17.txt")


def test_trained_net_identity_on_synthetic_chunks():
    """tests/test_basecaller_e2e.py's accuracy bar, on the port."""
    caller = GRUBasecaller(network="synth48", device="cpu")
    rng = np.random.default_rng(777)
    seqs = [_rand_seq(rng, int(rng.integers(150, 400))) for _ in range(12)]
    calls = caller.basecall([sequence_to_signal(s, rng=rng) for s in seqs])
    ident = batch_identity(seqs, calls)
    assert ident >= 0.95, f"trained GRU identity {ident:.3f} < 0.95"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: device=None would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GRUBasecaller(network="synth48")
