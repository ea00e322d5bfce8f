"""Card-only tests of the last slice: the count routes on CUDA tensors, the
graft-entry contract's forward and dryrun on the card.  Each test skips inside
its body where there is no card.

Like tests/test_torch_gpu.py this file imports neither JAX nor the JAX
package:

    PYTHONPATH=. python -m pytest tests/test_torch_gpu_probes.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from readbouncer_tpu_torch import graft_entry
from readbouncer_tpu_torch.ibf.query import ACCUMS, counts
from readbouncer_tpu_torch.models.gru import gru_logits
from readbouncer_tpu_torch.models.train import host_params, init_gru_params, param_tree
from readbouncer_tpu_torch.ops import gru as gru_ops
from readbouncer_tpu_torch.ops import ibf_count
from readbouncer_tpu_torch.tools import proto_counts_layout

torch.set_num_threads(1)


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_count_routes_on_the_card_equal_k1_and_the_cpu():
    """ripple, tree and the flat layouts on CUDA tensors equal the K1
    route, which launches K1, and the CPU's counts (tolerance 0)."""
    dev = _cuda_or_skip()
    bits, reads, lengths = proto_counts_layout.proto_inputs(64, 250, 8, 20_011)
    args = [torch.from_numpy(x) for x in (bits.view(np.int32), reads, lengths)]
    want = counts(*args, k=13, h=3, rows=20_011)
    before = ibf_count.accumulate_planes.launches
    for accum in ACCUMS:
        got = counts(*(a.to(dev) for a in args), k=13, h=3, rows=20_011, accum=accum)
        assert torch.equal(got.cpu(), want), accum
    assert ibf_count.accumulate_planes.launches == before + 1
    res = proto_counts_layout.run_proto_counts_layout(dev, 64, 250, 8, 20_011, reps=1)
    assert all(res["matches"].values()), res["matches"]


@pytest.mark.gpu
def test_entry_on_the_card_runs_k3():
    dev = _cuda_or_skip()
    fn, (frames,) = graft_entry.entry()
    assert frames.device.type == "cuda" and tuple(frames.shape) == (8, 128, 66)
    before = gru_ops.gru_layer.launches
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 128, 66), dtype=np.float32)).to(dev)
    out = fn(x)
    assert gru_ops.gru_layer.launches == before + 4
    cpu_fn, _ = graft_entry.entry("cpu")
    with torch.no_grad():
        plain = gru_logits(fn.args[0], x, kernel=False)
    assert tuple(out.shape) == (8, 128, 5)
    assert float((out - plain).abs().max()) <= 1e-4
    assert tuple(cpu_fn(x.cpu()).shape) == (8, 128, 5)


@pytest.mark.gpu
def test_dryrun_on_the_card_launches_k1_and_k2():
    dev = _cuda_or_skip()
    # the same net on the CPU: a CPU generator would draw other values
    cpu_params = param_tree(host_params(init_gru_params(torch.Generator(device=dev).manual_seed(0))), "cpu")
    b1, b2 = ibf_count.accumulate_planes.launches, ibf_count.planes_dual_max.launches
    got = graft_entry.dryrun_steps(2)
    assert ibf_count.accumulate_planes.launches > b1 and ibf_count.planes_dual_max.launches > b2
    assert got["mesh"] == {"data": 1, "bins": 2} and np.isfinite(got["loss"])
    cpu = graft_entry.dryrun_steps(2, "cpu", params=cpu_params)
    assert torch.equal(got["mb"].cpu(), cpu["mb"]) and torch.equal(got["mr"].cpu(), cpu["mr"])
    np.testing.assert_array_equal(got["decisions"], cpu["decisions"])
    np.testing.assert_allclose(got["loss"], cpu["loss"], rtol=1e-4)
