"""Card-only test of a mesh that spans processes: two processes of one gloo
group run the bins-sharded stack on ``bins:2`` over the default devices
(each process's visible card, ``cuda:0``) and on ``data:2,bins:2``, each
naming ``cuda:0`` twice.  Both ranks' maxima equal the unsharded stack's
on the card, and each rank launches K1 and K2 once per owned cell.
Skips inside the test body where there is no card.

Like tests/test_torch_gpu.py this file imports neither JAX nor the JAX
package:

    PYTHONPATH=. python -m pytest tests/test_torch_gpu_mesh.py --noconftest -q -p no:cacheprovider
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

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

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

WORKER = """\
import json, sys
from datetime import timedelta
import numpy as np, torch
from readbouncer_tpu_torch.ibf.query import FilterStack
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.ops import ibf_count
from readbouncer_tpu_torch.parallel import distributed
from readbouncer_tpu_torch.parallel.mesh import make_mesh, parse_mesh_shape
from readbouncer_tpu_torch.parallel.sharded import ShardedFilterStack
pid, port, work, shape = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
distributed.TIMEOUT = timedelta(seconds=60)
distributed.init_distributed(f"127.0.0.1:{port}", 2, pid)
dev = torch.device("cuda", 0)
stack = FilterStack([IBFData.load(f"{work}/f{i}.ribf", name=f"f{i}") for i in range(3)], "cpu")
per_rank = int(np.prod(list(parse_mesh_shape(shape).values()))) // 2
# bins:2 over the default devices: inside the group, every process's visible cards
mesh = make_mesh(shape) if per_rank == 1 else make_mesh(shape, distributed.global_devices([dev] * per_rank))
sharded = ShardedFilterStack(stack, mesh)
z = np.load(f"{work}/inputs.npz")
ibf_count.accumulate_planes.launches = ibf_count.planes_dual_max.launches = 0
mb, mr = sharded.max_counts_dual(z["reads"], z["lens"], z["tb"], z["tr"])
torch.cuda.synchronize()
print("RESULT " + json.dumps({
    "ok": bool(np.array_equal(mb.cpu().numpy(), z["ub"]) and np.array_equal(mr.cpu().numpy(), z["ur"])),
    "device": str(mb.device), "cells": len(sharded.cells), "ranks": mesh.ranks.tolist(),
    "launches": [ibf_count.accumulate_planes.launches, ibf_count.planes_dual_max.launches],
}))
distributed.shutdown_distributed()
"""


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand_seq(rng, n):
    return "".join("ACGT"[b] for b in rng.integers(0, 4, int(n)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["bins:2", "data:2,bins:2"])
def test_two_process_maxima_on_card_match_unsharded(shape, tmp_path):
    """Three real filters of 4 bins padded to 3, 2 and 3 words (blocks cut
    filters), 64 reads: both ranks' maxima equal the unsharded stack's,
    and each rank launches K1 and K2 once per owned cell."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(5)
    genomes = [_rand_seq(rng, 4000) for _ in range(3)]
    filters = []
    for i, (g, w) in enumerate(zip(genomes, (3, 2, 3))):
        ibf, _ = build_ibf_records([(f"g{i}", g)], IBFParams(kmer_size=13, fragment_length=1000),
                                   name=f"f{i}", device=dev)
        filters.append(IBFData(bits=np.pad(ibf.bits, ((0, 0), (0, w - ibf.words))), kmer_size=13,
                               hash_functions=ibf.hash_functions, num_bins=ibf.num_bins, name=f"f{i}"))
        filters[-1].save(tmp_path / f"f{i}.ribf")
    stack = FilterStack(filters, dev)
    L = 150
    seqs = []
    for i in range(64):
        m = int(rng.integers(60, L + 1))
        g = genomes[i % 3] if i % 4 != 3 else _rand_seq(rng, 4000)
        s = int(rng.integers(0, len(g) - m))
        seqs.append(g[s : s + m])
    reads, lens = encode_batch(seqs, L)
    tb, tr = (ci_and_threshold_batch(lens, 13, e, 0.95) for e in (0.1, 0.08))
    tab = [torch.from_numpy(ci_and_threshold_batch(np.arange(L + 1), 13, e, 0.95).astype(np.int32)).to(dev)
           for e in (0.1, 0.08)]
    ub, ur = stack_dual_max(stack, torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev), *tab)
    assert bool((ub.amax(dim=0) > 0).all())
    np.savez(tmp_path / "inputs.npz", reads=reads, lens=lens, tb=tb, tr=tr, ub=ub.cpu().numpy(),
             ur=ur.cpu().numpy())
    (tmp_path / "worker.py").write_text(textwrap.dedent(WORKER))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(r), port, str(tmp_path), shape],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
            if p.returncode != 0:
                break
    except subprocess.TimeoutExpired:
        pytest.fail("workers timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed: {err[-3000:]}"
        res = json.loads(next(ln for ln in out.splitlines() if ln.startswith("RESULT "))[len("RESULT "):])
        assert res["ok"] and res["device"] == "cuda:0", (rank, res)
        assert res["ranks"] == {"bins:2": [0, 1], "data:2,bins:2": [[0, 0], [1, 1]]}[shape]
        assert res["launches"] == [res["cells"]] * 2 and res["cells"] == {"bins:2": 1, "data:2,bins:2": 2}[shape]
