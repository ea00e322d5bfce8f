"""A mesh that spans processes: the port's bins-sharded stack over two
processes of one gloo group on the CPU, against the JAX package.

Each test starts two workers (a free local port, a group timeout of 60 s
through ``distributed.TIMEOUT``, ``communicate(timeout=120)``, both killed
if one fails); the workers import no JAX, the test computes the JAX
oracle.  ``global_devices`` lists both processes' devices in rank order;
``make_mesh`` over them gives each cell its owning rank, and each rank
copies only its cells' word blocks and makes one max all-reduce per
call.  On tests/test_distributed.py's inputs (``default_rng(41)``, a
3,000 bp target, 8 reads of 280 bp, thresholds at error 0.1 and 0.08)
both ranks' maxima on ``bins:2`` and ``data:2,bins:2`` are bit-equal to
JAX's single-process ``FilterStack.counts`` + ``max_counts``; on
tests/test_torch_parallel.py's world the cross-process
``ShardedLiveClassifier`` decides as JAX's ``LiveClassifier``."""

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

from readbouncer_tpu.classify.engine import encode_batch as jax_encode_batch
from readbouncer_tpu.classify.math import ci_and_threshold_batch as jax_thresholds
from readbouncer_tpu.ibf.build import build_ibf as jax_build_ibf
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu.ibf.query import FilterStack as JaxStack
from readbouncer_tpu.ibf.storage import IBFData as JaxIBF
from readbouncer_tpu.stream.scheduler import LiveClassifier as JaxLiveClassifier
from readbouncer_tpu.stream.scheduler import LiveConfig as JaxLiveConfig
from readbouncer_tpu_torch.ibf.build import build_ibf_records
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.storage import IBFData

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

PRELUDE = """\
import json, sys
from datetime import timedelta
import numpy as np, torch
from readbouncer_tpu_torch.parallel import distributed
torch.set_num_threads(1)
distributed.TIMEOUT = timedelta(seconds=60)
pid, work = int(sys.argv[1]), sys.argv[3]
distributed.init_distributed(f"127.0.0.1:{sys.argv[2]}", 2, pid)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, body, *args) -> list[dict]:
    """``body`` in two processes of one gloo group; each rank's ``RESULT``
    line, parsed, in rank order.  Both are killed if one fails or
    outlasts 120 s."""
    script = tmp_path / "worker.py"
    script.write_text(PRELUDE + textwrap.dedent(body) + "\ndistributed.shutdown_distributed()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [
        subprocess.Popen([sys.executable, str(script), str(i), port, str(tmp_path), *map(str, args)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True, cwd=tmp_path)
        for i in range(2)
    ]
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
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed: {err[-3000:]}"
    results = []
    for out, _ in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert len(lines) == 1, out
        results.append(json.loads(lines[0][len("RESULT "):]))
    return results


def test_global_devices_mesh_and_collective(tmp_path):
    """Two ranks naming 1 and 2 CPU devices: the global list in rank order
    with owning ranks; a mesh over it owns its cells by rank; the max
    all-reduce of int32; meshes the group cannot hold raise ValueError, a
    non-int32 reduce TypeError, a train step over a spanning mesh
    ValueError; a mesh of plain devices stays the process's own."""
    res = _run_ranks(tmp_path, """
        from readbouncer_tpu_torch.models.train import make_sharded_train_step
        from readbouncer_tpu_torch.parallel.distributed import allreduce_max, global_devices
        from readbouncer_tpu_torch.parallel.mesh import make_mesh
        devs = global_devices(["cpu"] * (pid + 1))
        mesh = make_mesh("data:3", devs)
        errors = []
        for make in (lambda: make_mesh("bins:4", devs), lambda: make_mesh("data:2", devs[1:]),
                     lambda: allreduce_max(torch.ones(2)),
                     lambda: make_sharded_train_step(mesh, lambda leaves: None)):
            try:
                make()
                errors.append(None)
            except (ValueError, TypeError) as e:
                errors.append(f"{type(e).__name__}: {e}")
        local = make_mesh("bins:2", ["cpu"] * 2)
        x = torch.tensor([[pid, 5 - pid], [-3, 2 * pid]], dtype=torch.int32)
        print("RESULT " + json.dumps({
            "devs": [[d.rank, str(d.device)] for d in devs], "ranks": mesh.ranks.tolist(),
            "owns": [mesh.owns(data=i) for i in range(3)], "spans": mesh.spans_processes,
            "local": [local.spans_processes, local.ranks.tolist()], "max": allreduce_max(x).tolist(),
            "errors": errors,
        }))
    """)
    for rank, r in enumerate(res):
        assert r["devs"] == [[0, "cpu"], [1, "cpu"], [1, "cpu"]]
        assert r["ranks"] == [0, 1, 1] and r["spans"]
        assert r["owns"] == [rank == 0, rank == 1, rank == 1]
        assert r["local"] == [False, [rank, rank]]
        assert r["max"] == [[1, 5], [-3, 2]]
        assert r["errors"] == [
            "ValueError: mesh shape {'bins': 4} needs 4 devices, have 3",
            # rank 1's own two devices are a mesh of rank 1 alone
            "ValueError: the mesh holds no device of process 0" if rank == 0 else None,
            "TypeError: allreduce_max takes int32 tensors, got torch.float32",
            "ValueError: the train step's mesh must be this process's own; it spans processes",
        ]


@pytest.fixture(scope="module")
def target_world(tmp_path_factory):
    """tests/test_distributed.py's bins-sharded inputs: the filter of a
    3,000 bp target (JAX build, k=13) saved as .ribf, its 8 reads of 280 bp,
    and JAX's single-process maxima at error 0.1 and 0.08."""
    td = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(41)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    (td / "targetA.fasta").write_text(f">targetA\n{ref}\n")
    ibf, _ = jax_build_ibf([td / "targetA.fasta"], JaxParams(kmer_size=13, fragment_length=100_000),
                           name="targetA")
    ibf.save(td / "targetA.ribf")
    stack = JaxStack([ibf])
    assert stack.words % 2 == 0
    seqs = [ref[i * 300 : i * 300 + 280] for i in range(8)]
    reads, lens = jax_encode_batch(seqs, 280)
    thr_b, thr_r = (jax_thresholds(lens, 13, e, 0.95) for e in (0.1, 0.08))
    counts = stack.counts(reads, lens)
    want = [np.asarray(stack.max_counts(counts, t)).tolist() for t in (thr_b, thr_r)]
    np.savez(td / "inputs.npz", reads=reads, lens=lens, thr_b=thr_b, thr_r=thr_r)
    return td, want


@pytest.mark.parametrize("shape", ["bins:2", "data:2,bins:2"])
def test_cross_process_maxima_match_jax(target_world, shape, tmp_path):
    """Both ranks' maxima bit-equal to JAX's single-process oracle; each
    rank holds only its cells' blocks: on bins:2 its own block (half the
    bits), on data:2,bins:2 (each rank naming the CPU twice) its data row's
    two blocks."""
    td, want = target_world
    res = _run_ranks(tmp_path, """
        from readbouncer_tpu_torch.ibf.query import FilterStack
        from readbouncer_tpu_torch.ibf.storage import IBFData
        from readbouncer_tpu_torch.parallel.distributed import global_devices
        from readbouncer_tpu_torch.parallel.mesh import make_mesh, parse_mesh_shape
        from readbouncer_tpu_torch.parallel.sharded import ShardedFilterStack
        td, shape = sys.argv[4], sys.argv[5]
        stack = FilterStack([IBFData.load(f"{td}/targetA.ribf", name="targetA")], "cpu")
        per_rank = int(np.prod(list(parse_mesh_shape(shape).values()))) // 2
        sharded = ShardedFilterStack(stack, make_mesh(shape, global_devices(["cpu"] * per_rank)))
        z = np.load(f"{td}/inputs.npz")
        mb, mr = sharded.max_counts_dual(z["reads"], z["lens"], z["thr_b"], z["thr_r"])
        print("RESULT " + json.dumps({
            "b": mb.tolist(), "r": mr.tolist(), "cells": sharded.cells,
            "blocks": sorted(j for _, j in sharded._blocks), "bits": sharded.bits_bytes,
            "all_bits": stack.bits.numel() * 4,
        }))
    """, td, shape)
    for rank, r in enumerate(res):
        assert [r["b"], r["r"]] == want, f"rank {rank}"
        if shape == "bins:2":
            assert r["cells"] == [[0, rank]] and r["blocks"] == [rank] and 2 * r["bits"] == r["all_bits"]
        else:
            assert r["cells"] == [[rank, 0], [rank, 1]] and r["blocks"] == [0, 1] and r["bits"] == r["all_bits"]
    assert max(map(max, want[0])) > 0


def test_cross_process_live_classifier_matches_jax(tmp_path):
    """tests/test_torch_parallel.py's world (three 4-bin filters padded to
    3, 2 and 3 words, one target and two depletes, merged into 8 words):
    ShardedLiveClassifier over a bins:2 mesh across the two processes
    decides 40 reads over two buckets and an empty sequence in both ranks
    as JAX's LiveClassifier."""
    rng = np.random.default_rng(5)
    genomes = ["".join("ACGT"[b] for b in rng.integers(0, 4, 4000)) for _ in range(3)]
    jax_f = []
    for i, (g, w) in enumerate(zip(genomes, (3, 2, 3))):
        ibf, _ = build_ibf_records([(f"g{i}", g)], IBFParams(kmer_size=13, fragment_length=1000),
                                   name=f"f{i}", device="cpu")
        kw = dict(kmer_size=13, hash_functions=ibf.hash_functions, num_bins=ibf.num_bins, name=f"f{i}")
        bits = np.pad(ibf.bits, ((0, 0), (0, w - ibf.words)))
        IBFData(bits=bits.copy(), **kw).save(tmp_path / f"f{i}.ribf")
        jax_f.append(JaxIBF(bits=bits.copy(), **kw))
    rng = np.random.default_rng(9)
    seqs = []
    for i in range(40):  # tests/test_torch_parallel.py::_reads(rng, genomes, 40, 30, 900)
        m = int(rng.integers(30, 900))
        if i % 4 == 3:
            seqs.append("".join("ACGT"[b] for b in rng.integers(0, 4, m)))
        else:
            s = int(rng.integers(0, len(genomes[i % 4]) - m))
            seqs.append(genomes[i % 4][s : s + m])
    seqs.append("")
    (tmp_path / "seqs.json").write_text(json.dumps(seqs))
    want = JaxLiveClassifier(jax_f[:1], jax_f[1:], JaxLiveConfig(batch_size=16, max_seq_len=1024)).decide(seqs)
    assert set(want.tolist()) == {0, 1, 2}
    res = _run_ranks(tmp_path, """
        from readbouncer_tpu_torch.ibf.storage import IBFData
        from readbouncer_tpu_torch.parallel.distributed import global_devices
        from readbouncer_tpu_torch.parallel.mesh import make_mesh
        from readbouncer_tpu_torch.parallel.sharded import ShardedLiveClassifier
        from readbouncer_tpu_torch.stream.scheduler import LiveConfig
        f = [IBFData.load(f"{work}/f{i}.ribf", name=f"f{i}") for i in range(3)]
        mesh = make_mesh("bins:2", global_devices(["cpu"]))
        live = ShardedLiveClassifier(f[:1], f[1:], LiveConfig(batch_size=16, max_seq_len=1024), mesh)
        sharded = live._stacks[0][1]
        dec = live.decide(json.load(open(f"{work}/seqs.json")))
        print("RESULT " + json.dumps({"dec": dec.tolist(), "words": sharded.stack.words,
                                      "blocks": [j for _, j in sharded._blocks]}))
    """)
    for rank, r in enumerate(res):
        assert r["dec"] == want.tolist(), f"rank {rank}"
        assert r["words"] == 8 and r["blocks"] == [rank]


def test_cli_mesh_shape_stays_per_process(tmp_path, capsys):
    """The CLI's target with ``[TPU] mesh_shape = "bins:2"`` under ``[TPU]
    coordinator`` in two processes: each replays its share of the reads
    over a mesh of its own, so the two decision CSVs are disjoint and
    together the single-process run's (host reads unblocked, target reads
    stopped).  The JAX CLI builds that mesh over both processes' devices
    and decides the second process's reads as the first's (ROADMAP)."""
    import csv

    from readbouncer_tpu_torch.main import main as port_main

    rng = np.random.default_rng(23)
    refs = {n: "".join("ACGT"[i] for i in rng.integers(0, 4, 3000)) for n in ("targetA", "host")}
    for name, seq in refs.items():
        ibf, _ = build_ibf_records([(name, seq)], IBFParams(kmer_size=13, fragment_length=100_000), name=name,
                                   device="cpu")
        ibf.save(tmp_path / f"{name}.ribf")
    starts = np.random.default_rng(77).integers(0, 1000, 3)
    (tmp_path / "live.fasta").write_text("".join(
        f">{n[0]}_{i}\n{refs[n][s:s + 2000]}\n" for n in refs for i, s in enumerate(starts)))
    port = _free_port()

    def config(name, rank=None):
        coord = "" if rank is None else f'coordinator = "127.0.0.1:{port}"\nnum_processes = 2\nprocess_id = {rank}\n'
        cfg = tmp_path / f"{name}.toml"
        cfg.write_text(
            f'usage = "target"\noutput_directory = "{tmp_path / name}"\nlog_directory = "{tmp_path / name}_log"\n\n'
            f'[IBF]\nkmer_size = 13\ntarget_files = ["{tmp_path}/targetA.ribf"]\n'
            f'deplete_files = ["{tmp_path}/host.ribf"]\nexp_seq_error_rate = 0.1\n\n'
            f'[MinKNOW]\nchannels = [1, 6]\n\n[Basecaller]\ncaller = "Oracle"\n\n'
            f'[TPU]\nbatch_size = 16\nreplay_file = "{tmp_path}/live.fasta"\nmesh_shape = "bins:2"\n{coord}'
        )
        return cfg

    def decisions(name):
        rows = list(csv.reader(open(tmp_path / name / "read_until_decision_stats.csv"), delimiter=";"))[1:]
        return {r[0]: r[4] for r in rows}

    assert port_main(["--config", str(config("solo")), "--device", "cpu"]) == 0
    capsys.readouterr()
    script = tmp_path / "cli.py"
    script.write_text("import sys\nfrom readbouncer_tpu_torch.main import main\n"
                      "sys.exit(main(['--config', sys.argv[1], '--device', 'cpu']))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(config(f"h{r}", r))], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    solo, h0, h1 = decisions("solo"), decisions("h0"), decisions("h1")
    assert solo == {f"t_{i}": "stop_receiving" for i in range(3)} | {f"h_{i}": "unblock" for i in range(3)}
    assert h0 and h1 and not (set(h0) & set(h1)) and {**h0, **h1} == solo
