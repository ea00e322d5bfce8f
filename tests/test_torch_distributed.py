"""The port's multi-process layer (parallel/distributed.py) against the
JAX package's.

The single-process helpers are held against JAX's in-process; the real
multi-process paths run two processes joined in a gloo group on the CPU
(a free local port, ``communicate(timeout=120)``): the collectives, a
sharded ``classify_read_files`` whose summed counters equal the
single-process port's and JAX's, the CLI's ``classify`` and ``target``
under ``[TPU] coordinator``, and the data-parallel train step with its
gradients averaged across the processes."""

import csv
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

from readbouncer_tpu.classify.engine import classify_read_files as jax_classify_read_files
from readbouncer_tpu.ibf.build import build_ibf as jax_build_ibf
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu.parallel import distributed as jax_dist
from readbouncer_tpu_torch.classify.engine import classify_read_files
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.main import main as port_main
from readbouncer_tpu_torch.parallel.distributed import aggregate_counters, allgather_pytree, host_shard

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs, what):
    """(stdout, stderr) of each process; all killed if one outlasts 120 s."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{what} timed out")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, f"{what} failed: {err[-3000:]}"
    return outs


def _run_two(tmp_path, body, *args):
    """Run ``body`` in two processes of one gloo group (rank in argv[1]);
    returns the parsed ``RESULT`` line that rank 0 prints."""
    script = tmp_path / "worker.py"
    script.write_text(
        "import json, sys\n"
        "from readbouncer_tpu_torch.parallel.distributed import init_distributed, shutdown_distributed\n"
        "pid = int(sys.argv[1])\n"
        "init_distributed(f'127.0.0.1:{sys.argv[2]}', 2, pid)\n"
        + textwrap.dedent(body)
        + "\nshutdown_distributed()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [
        subprocess.Popen([sys.executable, str(script), str(i), port, *map(str, args)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True, cwd=tmp_path)
        for i in range(2)
    ]
    outs = _wait(procs, "workers")
    lines = [ln for out, _ in outs for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert len(lines) == 1, outs
    return json.loads(lines[0][len("RESULT "):])


def test_host_shard_matches_jax():
    for n_items in (0, 1, 7, 10, 33):
        items = list(range(n_items))
        for count in (1, 2, 3, 8):
            shards = [host_shard(items, i, count) for i in range(count)]
            assert shards == [jax_dist.host_shard(items, i, count) for i in range(count)]
            assert sum(shards, []) == items
    assert host_shard(list(range(10))) == list(range(10))  # one process: everything


def test_single_process_aggregation_matches_jax():
    """One process: allgather adds a length-1 axis; counters come back as
    given, ints exact above 2**53 (where float64 is not)."""
    tree = {"a": np.arange(3), "b": [np.ones((2, 2)), 4]}
    g = allgather_pytree(tree)
    assert g["a"].shape == (1, 3) and g["b"][0].shape == (1, 2, 2) and g["b"][1].shape == (1,)
    big = (1 << 53) + 1
    counters = {"x": 2, "y": 1.5, "n": big, "m": np.int64(3)}
    agg = aggregate_counters(counters)
    assert agg == jax_dist.aggregate_counters(counters) == {"x": 2, "y": 1.5, "n": big, "m": 3}
    assert isinstance(agg["n"], int) and agg["n"] == big


def test_two_process_gloo_cluster(tmp_path):
    """Two processes: rank and size, host shards, counters summed exactly
    (an int above 2**53 included) and a tree gathered."""
    res = _run_two(tmp_path, """
        import numpy as np
        from readbouncer_tpu_torch.parallel.distributed import (
            aggregate_counters, allgather_pytree, host_shard, is_distributed, process_count, process_index)
        assert is_distributed() and process_count() == 2 and process_index() == pid
        mine = host_shard(list(range(7)))
        total = aggregate_counters({"n": len(mine), "s": float(sum(mine)), "big": (1 << 53) + pid})
        g = allgather_pytree({"rank": np.array([pid, 10 * pid])})
        if pid == 0:
            print("RESULT " + json.dumps({**total, "g": g["rank"].tolist()}))
    """)
    assert res == {"n": 7, "s": float(sum(range(7))), "big": (1 << 54) + 1, "g": [[0, 0], [1, 10]]}


@pytest.fixture(scope="module")
def classify_world(tmp_path_factory):
    """tests/test_distributed.py's classify world: a target and a host
    genome of 3 kb (filters built by the JAX package, k=13), 6 target and
    5 host reads of 400 bp and one short read, shuffled."""
    td = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(23)

    def rand_seq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    refs = {"targetA": rand_seq(3000), "host": rand_seq(3000)}
    for name, seq in refs.items():
        (td / f"{name}.fasta").write_text(f">{name}\n{seq}\n")
        ibf, _ = jax_build_ibf([td / f"{name}.fasta"], JaxParams(kmer_size=13, fragment_length=100_000), name=name)
        ibf.save(td / f"{name}.ribf")
    reads = []
    for name, n in (("targetA", 6), ("host", 5)):
        for i in range(n):
            s = int(rng.integers(0, 2600))
            reads.append((f"{name}_{i}", refs[name][s : s + 400]))
    reads.append(("short_0", "ACGT" * 20))
    rng.shuffle(reads)
    (td / "reads.fasta").write_text("".join(f">{rid}\n{seq}\n" for rid, seq in reads))
    return td


def _ids(path):
    if not path.exists():
        return set()
    return {ln[1:].split()[0] for ln in path.read_text().splitlines() if ln.startswith(">")}


COUNTERS = ("found", "failed", "too_short", "read_counter")


def test_two_process_classify_sums_to_single_process(classify_world, tmp_path):
    """classify_read_files(shard=(i, 2)) in two processes: disjoint
    ``.h0`` / ``.h1`` FASTAs whose union is the single-process output, and
    summed counters equal to the single-process port's and to JAX's."""
    td = classify_world
    load = lambda n: IBFData.load(td / f"{n}.ribf", name=n)
    solo = classify_read_files([td / "reads.fasta"], [load("targetA")], [load("host")], 0.1,
                               tmp_path / "solo", verbose=False, device="cpu")
    from readbouncer_tpu.ibf.storage import IBFData as JaxIBFData

    jload = lambda n: JaxIBFData.load(td / f"{n}.ribf", name=n)
    jax_solo = jax_classify_read_files([td / "reads.fasta"], [jload("targetA")], [jload("host")], 0.1,
                                       tmp_path / "jax", verbose=False)
    total = _run_two(tmp_path, """
        from readbouncer_tpu_torch.classify.engine import classify_read_files
        from readbouncer_tpu_torch.ibf.storage import IBFData
        from readbouncer_tpu_torch.parallel.distributed import aggregate_counters
        td = sys.argv[3]
        load = lambda n: IBFData.load(f"{td}/{n}.ribf", name=n)
        res = classify_read_files([f"{td}/reads.fasta"], [load("targetA")], [load("host")], 0.1,
                                  "multi", verbose=False, shard=(pid, 2), output_suffix=f".h{pid}",
                                  device="cpu")
        total = aggregate_counters({"found": res.found, "failed": res.failed, "too_short": res.too_short,
                                    "read_counter": res.read_counter, "t": res.per_target["targetA"]})
        if pid == 0:
            print("RESULT " + json.dumps(total))
    """, td)
    for ref in (solo, jax_solo):
        assert [total[k] for k in COUNTERS] == [getattr(ref, k) for k in COUNTERS]
        assert total["t"] == ref.per_target["targetA"]
    assert solo.found > 0 and solo.too_short == 1
    for stem in ("targetA", "unclassified"):
        h0, h1 = (_ids(tmp_path / "multi" / f"{stem}.h{i}.fasta") for i in range(2))
        assert not (h0 & h1), f"{stem}: shard outputs overlap"
        assert (h0 | h1) == _ids(tmp_path / "solo" / f"{stem}.fasta") == _ids(tmp_path / "jax" / f"{stem}.fasta")


def _cli_config(td, out, usage, rank=None, port=None):
    cfg = Path(out).with_suffix(".toml")
    coord = "" if rank is None else f'coordinator = "127.0.0.1:{port}"\nnum_processes = 2\nprocess_id = {rank}\n'
    cfg.write_text(
        f'usage = "{usage}"\noutput_directory = "{out}"\nlog_directory = "{out}_log"\n\n'
        f'[IBF]\nkmer_size = 13\ntarget_files = ["{td}/targetA.ribf"]\ndeplete_files = ["{td}/host.ribf"]\n'
        f'read_files = ["{td}/reads.fasta"]\nexp_seq_error_rate = 0.1\n\n'
        f'[MinKNOW]\nchannels = [1, 6]\n\n[Basecaller]\ncaller = "Oracle"\n\n'
        f'[TPU]\nbatch_size = 16\nreplay_file = "{td}/live_reads.fasta"\n{coord}'
    )
    return cfg


def _report(stdout, usage):
    start = "Final Results" if usage == "classify" else "Number of classified reads"
    lines = stdout[stdout.index(start):].splitlines()
    lines = lines[: next(i for i, ln in enumerate(lines) if ln.startswith("Real time") or ln.startswith("-----"))]
    return [ln for ln in lines if "time" not in ln and "Time" not in ln and "latency" not in ln]


def _decisions(out_dir):
    path = out_dir / "read_until_decision_stats.csv"
    return {r[0]: r[4] for r in list(csv.reader(open(path), delimiter=";"))[1:]} if path.exists() else {}


@pytest.mark.parametrize("usage", ["classify", "target"])
def test_two_process_cli(classify_world, tmp_path, capsys, usage):
    """``python -m readbouncer_tpu_torch`` in two processes under
    ``[TPU] coordinator``: classify writes disjoint ``.h0`` / ``.h1``
    FASTAs and rank 0 prints the single-process report; target replays
    each process's share of reads and channels, and the two decision CSVs
    are disjoint and together the single-process run's decisions."""
    td = classify_world
    rng = np.random.default_rng(77)
    genomes = {n: (td / f"{n}.fasta").read_text().split("\n")[1] for n in ("targetA", "host")}
    (td / "live_reads.fasta").write_text("".join(
        f">{n[0]}_{i}\n{genomes[n][s:s + 2000]}\n"
        for n in ("targetA", "host") for i, s in enumerate(rng.integers(0, 1000, 3))
    ))
    assert port_main(["--config", str(_cli_config(td, tmp_path / "solo", usage)), "--device", "cpu"]) == 0
    solo_out = capsys.readouterr().out
    port = _free_port()
    for rank in range(2):
        _cli_config(td, tmp_path / f"h{rank}", usage, rank, port)
    script = tmp_path / "cli.py"
    script.write_text("import sys\nfrom readbouncer_tpu_torch.main import main\n"
                      "sys.exit(main(['--config', sys.argv[1], '--device', 'cpu']))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path / f"h{r}.toml")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = _wait(procs, "CLI processes")
    if usage == "classify":
        assert "Final Results" not in outs[1][0]
        assert _report(outs[0][0], usage) == _report(solo_out, usage)
        for stem in ("targetA", "unclassified"):
            h0, h1 = (_ids(tmp_path / f"h{r}" / f"{stem}.h{r}.fasta") for r in range(2))
            assert not (h0 & h1) and (h0 | h1) == _ids(tmp_path / "solo" / f"{stem}.fasta")
    else:
        h0, h1 = _decisions(tmp_path / "h0"), _decisions(tmp_path / "h1")
        assert h0 and h1 and not (set(h0) & set(h1))
        solo = _decisions(tmp_path / "solo")
        assert {**h0, **h1} == solo and sum(d == "unblock" for d in solo.values()) == 3


def test_two_process_sharded_train_step(tmp_path):
    """make_sharded_train_step over a data:2 mesh in each of two processes
    (4 shards of 2 reads in all): the gradients are averaged across the
    processes, so both end with the params and the loss of one
    single-process step on the whole batch of 8."""
    from readbouncer_tpu_torch.models.train import (
        init_gru_params, make_train_step, param_leaves, synthetic_ctc_batch)

    batch = synthetic_ctc_batch(np.random.default_rng(0), batch=8, frames_t=20, window=8, max_label=5)
    params = init_gru_params(torch.Generator().manual_seed(2), hidden=8, window=8, num_layers=2)
    step = make_train_step(lambda leaves: torch.optim.SGD(leaves, lr=0.1))
    params, _, loss = step(params, step.init(params), batch)
    np.savez(tmp_path / "batch.npz", *batch)
    res = _run_two(tmp_path, """
        import numpy as np, torch
        from readbouncer_tpu_torch.models.train import init_gru_params, make_sharded_train_step, param_leaves
        from readbouncer_tpu_torch.parallel.mesh import make_mesh
        torch.set_num_threads(1)
        z = np.load("batch.npz")
        batch = [z[f"arr_{i}"][4 * pid : 4 * pid + 4] for i in range(4)]
        params = init_gru_params(torch.Generator().manual_seed(2), hidden=8, window=8, num_layers=2)
        step = make_sharded_train_step(make_mesh("data:2", ["cpu"] * 2),
                                       lambda leaves: torch.optim.SGD(leaves, lr=0.1))
        params, _, loss = step(params, step.init(params), batch)
        flat = torch.cat([p.detach().reshape(-1) for p in param_leaves(params)])
        print("RESULT " + json.dumps({"loss": float(loss), "params": flat.tolist()}) if pid == 0 else "")
    """)
    want = torch.cat([p.detach().reshape(-1) for p in param_leaves(params)]).numpy()
    np.testing.assert_allclose(res["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(np.array(res["params"]), want, rtol=0, atol=1e-5)
