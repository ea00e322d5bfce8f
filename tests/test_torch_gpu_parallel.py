"""Card-only tests of this slice's modules: the bins-sharded stack over
``cuda:0`` repeated against the unsharded stack, a train step on the card
against the same step on the CPU, and the remote basecaller's round trip
through a server running the card's GRU.  Each test skips inside its body
where there is no card.

Like tests/test_torch_gpu.py this file imports neither JAX nor the JAX
package:

    PYTHONPATH=. python -m pytest tests/test_torch_gpu_parallel.py --noconftest -q -p no:cacheprovider
"""

import socket
import threading

import numpy as np
import pytest
import torch

from readbouncer_tpu_torch.classify.engine import encode_batch
from readbouncer_tpu_torch.classify.fused import stack_dual_max
from readbouncer_tpu_torch.classify.math import ci_and_threshold_batch
from readbouncer_tpu_torch.ibf.build import build_ibf_records
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.query import FilterStack
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.models.basecaller import GRUBasecaller
from readbouncer_tpu_torch.models.remote import RemoteBasecaller, serve_basecalls
from readbouncer_tpu_torch.models.train import (
    host_params, init_gru_params, make_sharded_train_step, make_train_step, param_leaves, param_tree,
    synthetic_ctc_batch,
)
from readbouncer_tpu_torch.ops import gru as gru_ops
from readbouncer_tpu_torch.ops import ibf_count
from readbouncer_tpu_torch.parallel.mesh import make_mesh
from readbouncer_tpu_torch.parallel.sharded import ShardedFilterStack
from readbouncer_tpu_torch.stream.replay import sequence_to_signal

torch.set_num_threads(1)


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand_seq(rng, n):
    return "".join("ACGT"[b] for b in rng.integers(0, 4, int(n)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["bins:2", "data:2,bins:2", "bins:4"])
def test_sharded_maxima_on_card_match_unsharded(shape):
    """Three real filters of 4 bins padded to 3, 2 and 3 words (blocks cut
    filters), 64 reads: the sharded maxima equal the unsharded stack's,
    and K1 and K2 each launch once per cell."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(5)
    genomes = [_rand_seq(rng, 4000) for _ in range(3)]
    filters = []
    for i, (g, w) in enumerate(zip(genomes, (3, 2, 3))):
        ibf, _ = build_ibf_records([(f"g{i}", g)], IBFParams(kmer_size=13, fragment_length=1000),
                                   name=f"f{i}", device=dev)
        filters.append(IBFData(bits=np.pad(ibf.bits, ((0, 0), (0, w - ibf.words))), kmer_size=13,
                               hash_functions=ibf.hash_functions, num_bins=ibf.num_bins, name=f"f{i}"))
    stack = FilterStack(filters, dev)
    mesh = make_mesh(shape, [dev] * {"bins:2": 2, "data:2,bins:2": 4, "bins:4": 4}[shape])
    sharded = ShardedFilterStack(stack, mesh)
    L = 150
    seqs = []
    for i in range(64):
        m = int(rng.integers(60, L + 1))
        g = genomes[i % 3] if i % 4 != 3 else _rand_seq(rng, 4000)
        s = int(rng.integers(0, len(g) - m))
        seqs.append(g[s : s + m])
    reads, lens = encode_batch(seqs, L)
    tb, tr = (ci_and_threshold_batch(lens, 13, e, 0.95) for e in (0.1, 0.08))
    before = (ibf_count.accumulate_planes.launches, ibf_count.planes_dual_max.launches)
    mb, mr = sharded.max_counts_dual(reads, lens, tb, tr)
    cells = mesh.size
    assert (ibf_count.accumulate_planes.launches - before[0], ibf_count.planes_dual_max.launches - before[1]) == (
        cells, cells)
    assert mb.device.type == "cuda"
    tab = [torch.from_numpy(ci_and_threshold_batch(np.arange(L + 1), 13, e, 0.95).astype(np.int32)).to(dev)
           for e in (0.1, 0.08)]
    ub, ur = stack_dual_max(stack, torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev), *tab)
    assert torch.equal(mb, ub) and torch.equal(mr, ur)
    assert bool((mb.amax(dim=0) > 0).all())


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu():
    """One Adam step at B=8, 2 layers, H=16 on the card and on the CPU from
    the same params: loss within 1e-4 relative, params within 1e-5; the
    data:2 step over cuda:0 twice equals the single step (SGD); K3 never
    launches in training."""
    dev = _cuda_or_skip()
    batch = synthetic_ctc_batch(np.random.default_rng(0), batch=8, frames_t=40, window=8, max_label=8)
    init = host_params(init_gru_params(torch.Generator().manual_seed(3), hidden=16, window=8, num_layers=2))
    k3 = gru_ops.gru_layer.launches
    out = {}
    for where in ("cpu", dev):
        params = param_tree(init, where)
        step = make_train_step(lambda leaves: torch.optim.Adam(leaves, lr=1e-3))
        params, _, loss = step(params, step.init(params), batch)
        out[str(where)] = (float(loss), torch.cat([p.detach().cpu().reshape(-1) for p in param_leaves(params)]))
    (lc, pc), (lg, pg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert float((pg - pc).abs().max()) <= 1e-5
    flat = {}
    for name, make in (("single", lambda f: make_train_step(f)),
                       ("sharded", lambda f: make_sharded_train_step(make_mesh("data:2", [dev, dev]), f))):
        params = param_tree(init, dev)
        step = make(lambda leaves: torch.optim.SGD(leaves, lr=0.1))
        params, _, loss = step(params, step.init(params), batch)
        flat[name] = (float(loss), torch.cat([p.detach().reshape(-1) for p in param_leaves(params)]))
    assert abs(flat["sharded"][0] - flat["single"][0]) <= 1e-5 * abs(flat["single"][0])
    assert float((flat["sharded"][1] - flat["single"][1]).abs().max()) <= 1e-5
    assert gru_ops.gru_layer.launches == k3


@pytest.mark.gpu
def test_remote_round_trip_over_card_gru():
    """A server whose basecall is the synth48 GRU on the card: the remote
    client returns, read for read, what the card's GRU returns for the
    int16-truncated signals, and K3 launched."""
    dev = _cuda_or_skip()
    caller = GRUBasecaller(network="synth48", max_frames=320, device=dev)
    rng = np.random.default_rng(777)
    sigs = [sequence_to_signal(_rand_seq(rng, int(rng.integers(150, 170))), rng=rng) for _ in range(6)]
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        with srv:
            serve_basecalls(srv, caller.basecall)

    threading.Thread(target=run, daemon=True).start()
    before = gru_ops.gru_layer.launches
    bc = RemoteBasecaller(port=srv.getsockname()[1], batch_size=4)
    try:
        got = bc.basecall(sigs)
    finally:
        bc.close()
    assert gru_ops.gru_layer.launches > before
    want = [caller.basecall([s.astype(np.float32).astype(np.int16).astype(np.float32)])[0] for s in sigs]
    assert got == want and all(len(s) > 100 for s in got)
