"""Card-only tests of the live path: the CUDA kernel K3 against its plain
version, and the basecaller and live classifier on the card against the
same code on the CPU.  Each test skips inside its body where there is no
card.

Like tests/test_torch_gpu.py this file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=. python -m pytest tests/test_torch_gpu.py tests/test_torch_gpu_gru.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from readbouncer_tpu_torch.ibf.build import build_ibf_records
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.models.basecaller import GRUBasecaller
from readbouncer_tpu_torch.ops import gru as ops
from readbouncer_tpu_torch.stream.replay import sequence_to_signal
from readbouncer_tpu_torch.stream.scheduler import LiveClassifier, LiveConfig

torch.set_num_threads(1)


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _layer(rng, H, dev):
    s = 1.0 / np.sqrt(H)
    shapes = {"r_zr": (H, 2 * H), "b_hzr": (2 * H,), "rn": (H, H), "bhn": (H,)}
    return {k: torch.from_numpy(rng.uniform(-s, s, v).astype(np.float32)).to(dev) for k, v in shapes.items()}


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,T,H,reverse", [(1, 1, 48, False), (37, 50, 96, True), (256, 320, 48, False), (300, 7, 5, True)]
)
def test_gru_layer_kernel_matches_plain(B, T, H, reverse):
    """Any B, T and H <= 96; 1e-5 absolute (the kernel sums each gate's
    dot product in another order than the plain loop's matmul)."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(B + T + H)
    layer = _layer(rng, H, dev)
    xg = torch.from_numpy(rng.normal(size=(B, T, 3 * H)).astype(np.float32)).to(dev)
    before = ops.gru_layer.launches
    got = ops.gru_layer(layer, xg, reverse=reverse)
    torch.cuda.synchronize()
    assert ops.gru_layer.launches == before + 1
    want = ops.gru_layer_plain(layer, xg, reverse=reverse)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_basecaller_on_the_card_matches_the_cpu():
    dev = _cuda_or_skip()
    rng = np.random.default_rng(3)
    sigs = [sequence_to_signal("".join("ACGT"[i] for i in rng.integers(0, 4, int(n))), rng=rng)
            for n in (180, 178, 90, 200, 177)]
    sigs = [s[:1600] for s in sigs]
    card = GRUBasecaller(network="synth48", max_frames=320, device=dev)
    cpu = GRUBasecaller(network="synth48", max_frames=320, device="cpu")
    before = ops.gru_layer.launches
    got = card.basecall(sigs)
    assert ops.gru_layer.launches == before + 4  # one launch per layer
    assert got == cpu.basecall(sigs)


@pytest.mark.gpu
def test_live_classifier_on_the_card_matches_the_cpu():
    dev = _cuda_or_skip()
    rng = np.random.default_rng(4)
    genomes = ["".join("ACGT"[i] for i in rng.integers(0, 4, 6000)) for _ in range(2)]
    params = IBFParams(fragment_length=2000)
    filters = [build_ibf_records([(f"g{i}", g)], params, name=f"g{i}", device="cpu")[0]
               for i, g in enumerate(genomes)]
    seqs = []
    for i in range(120):
        g = genomes[i % 2]
        n = int(rng.integers(0, 2500))
        s = int(rng.integers(0, len(g) - n))
        seqs.append(g[s : s + n] if i % 3 else "".join("ACGT"[j] for j in rng.integers(0, 4, n)))
    cfg = LiveConfig(batch_size=16, mid_len=1024)
    got = LiveClassifier(filters[:1], filters[1:], cfg, device=dev).decide(seqs)
    want = LiveClassifier(filters[:1], filters[1:], cfg, device="cpu").decide(seqs)
    np.testing.assert_array_equal(got, want)
