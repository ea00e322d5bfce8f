"""The tiny live world of tests/test_live_e2e.py, for both packages.

Two random 6 kb genomes ("host", depleted; "target"), one filter each
built by the JAX package (k=13, one bin) and loaded by each package from
the same .ribf files; replayed reads made once with numpy and handed to
both packages' ReplaySource; and a run of either package's live sampler
reduced to what must be equal across the two.
"""

from __future__ import annotations

import numpy as np

from readbouncer_tpu.ibf.build import build_ibf as jax_build_ibf
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu.ibf.storage import IBFData as JaxIBFData
from readbouncer_tpu.stream import replay as jax_replay
from readbouncer_tpu.stream import scheduler as jax_scheduler
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.stream import replay, scheduler

PACKAGES = {"port": (replay, scheduler), "jax": (jax_replay, jax_scheduler)}


def rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def make_world(tmp):
    rng = np.random.default_rng(21)
    genomes = {"host": rand_seq(rng, 6000), "target": rand_seq(rng, 6000)}
    filters = {"port": {}, "jax": {}}
    for name, seq in genomes.items():
        (tmp / f"{name}.fasta").write_text(f">{name}\n{seq}\n")
        ibf, _ = jax_build_ibf([tmp / f"{name}.fasta"], JaxParams(kmer_size=13, fragment_length=100_000),
                               name=name)
        ibf.save(tmp / f"{name}.ribf")
        filters["jax"][name] = JaxIBFData.load(tmp / f"{name}.ribf", name=name)
        filters["port"][name] = IBFData.load(tmp / f"{name}.ribf", name=name)
    return genomes, filters


def make_reads(rng, genome, n, length, prefix):
    """(read_id, signal, sequence) triples of substrings of ``genome``."""
    out = []
    for i in range(n):
        start = int(rng.integers(0, len(genome) - length))
        seq = genome[start : start + length]
        out.append((f"{prefix}_{i}", jax_replay.sequence_to_signal(seq, rng=rng), seq))
    return out


def run_live(pkg, filters, reads, out_dir, basecaller, targets=("target",), depletes=("host",),
             channels=None, max_ticks=100, handle_sigint=False, **cfg):
    """One live run of package ``pkg``; returns (outcome dict, sampler)."""
    rp, sch = PACKAGES[pkg]
    src = rp.ReplaySource(
        reads=[rp.ReplayRead(rid, sig.copy(), seq) for rid, sig, seq in reads],
        channels=channels or len(reads),
    )
    live_cfg = sch.LiveConfig(batch_size=16, **cfg)
    kw = {"device": "cpu"} if pkg == "port" else {}
    classifier = sch.LiveClassifier(
        [filters[pkg][t] for t in targets], [filters[pkg][d] for d in depletes], live_cfg, **kw
    )
    sampler = sch.AdaptiveSampler(src, basecaller, classifier, output_dir=out_dir, cfg=live_cfg)
    stats = sampler.run(max_ticks=max_ticks, handle_sigint=handle_sigint)
    csv = (out_dir / "read_until_decision_stats.csv").read_text().splitlines()
    outcome = {
        "stats": (stats.classified, stats.unclassified, stats.unblocked, stats.stop_received,
                  stats.ticks, stats.reads_processed, stats.actions_succeeded, stats.actions_failed,
                  stats.avg_read_len.n, stats.avg_read_len.mean),
        "source": dict(src.stats),
        "reads": {r.read_id: (r.unblocked, r.stopped, r.emitted) for r in src.reads},
        "fasta": {n: (out_dir / n).read_text() for n in ("TargetReads.fasta", "DepletedReads.fasta")},
        # the last column is the processing time, which differs run to run
        "csv": [row.rsplit(";", 1)[0] for row in csv],
    }
    return outcome, sampler
