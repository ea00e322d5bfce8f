"""Command line: ``python -m readbouncer_tpu_torch --config file.toml``.

The torch counterpart of readbouncer_tpu/main.py for the usages this
port covers, on the same TOML schema (config.py):

* ``build`` — build a ``.ribf`` filter from each FASTA input on the
  card and save it to ``<output>/<stem>.ribf``;
* ``update`` — append the target FASTAs' sequences to the filter
  ``[IBF] update_filter`` as new bins and save it to
  ``<output>/<stem>.ribf``;
* ``classify`` — load the filters (building the FASTA inputs first),
  classify the read files, write the per-target FASTAs and
  ``unclassified.fasta`` and print the final results block;
* ``target`` — the live adaptive-sampling loop over a replayed signal
  source (``[TPU] replay_file`` or ``replay_signals``): basecall each
  0.4 s chunk (the Oracle caller or the GRU), decide it against the
  filters, send unblock / stop_receiving actions, write
  ``TargetReads.fasta``, ``DepletedReads.fasta`` and the decision CSV;
* ``test`` — bring the replay source up and report its first window.

``[Basecaller] caller = "Guppy"`` or ``"remote"`` basecalls through a
TCP basecall server (models/remote.py); ``[TPU] mesh_shape`` runs the
live classifier bins-sharded over a device mesh (parallel/sharded.py);
``[TPU] coordinator`` joins a multi-process run (parallel/distributed.py):
``classify`` shards the read records over the processes, writes
``<name>.h<rank>.fasta`` and rank 0 prints the summed report, ``target``
and ``test`` replay the process's share of reads and channels, and
``build`` and ``update`` run in every process as in one.  The device is
the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from readbouncer_tpu_torch.config import ConfigReader
from readbouncer_tpu_torch.utils.logging import get_logger, setup_loggers

__all__ = [
    "main", "run_program", "get_filters", "filter_output_path", "make_replay_source",
    "make_basecaller", "live_config",
]

def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="readbouncer-tpu-torch",
        description="Nanopore read classification against IBF indexes on a CUDA card",
    )
    p.add_argument("--config", required=True, help="TOML configuration file")
    p.add_argument("--verbose", action="store_true", help="echo progress to stdout")
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: cuda; 'cpu' runs the plain versions)",
    )
    from readbouncer_tpu_torch import __version__

    p.add_argument("--version", action="version", version=f"readbouncer-tpu-torch {__version__}")
    return p.parse_args(argv)


def filter_output_path(output_dir: Path, source: Path) -> Path:
    """<output>/<fasta stem>.ribf (reference .ibf naming: ibfbuild.hpp:38-44)."""
    return output_dir / (source.stem + ".ribf")


def get_filters(config: ConfigReader, files: list[Path], device, verbose: bool = False) -> list:
    """Load-or-build each input (reference: getIBF, src/main/ibfbuild.hpp:69-180):
    filter files load directly; FASTA inputs are built on ``device`` and
    saved first."""
    from readbouncer_tpu_torch.ibf.build import build_ibf
    from readbouncer_tpu_torch.ibf.params import IBFParams
    from readbouncer_tpu_torch.ibf.storage import IBFData, sniff

    log = get_logger("IbfLog")
    out = []
    for f in map(Path, files):
        if sniff(f):
            log.info("loading filter file %s", f)
            out.append(IBFData.load(f, name=f.stem))
            continue
        params = IBFParams(
            kmer_size=config.ibf.kmer_size,
            fragment_length=config.ibf.fragment_size,
            hash_functions=config.tpu.hash_functions,
            max_fp=config.tpu.max_fp,
        )
        log.info("building filter from %s (k=%d, fragment=%d)", f, params.kmer_size, params.fragment_length)
        ibf, stats = build_ibf([f], params, name=f.stem, device=device)
        dest = filter_output_path(config.output_dir, f)
        ibf.save(dest)
        log.info(
            "built %s: %d bins, %d bits, %.2fs",
            dest, stats.total_bins_declared, stats.filter_size_bits, stats.build_seconds,
        )
        if verbose:
            print(f"built {dest}: {stats.total_bins_declared} bins, {stats.filter_size_bits} bits")
        out.append(ibf)
    return out


def run_build(config: ConfigReader, device, verbose: bool) -> int:
    """reference: main.cpp:286-345 (build usage builds every input file)."""
    get_filters(config, config.ibf.target_files + config.ibf.deplete_files, device, verbose)
    return 0


def run_update(config: ConfigReader, device, verbose: bool) -> int:
    """Append new references to an existing filter (usage="update"),
    written to <output>/<stem>.ribf (reference package: main.py:90-120;
    IBF::update_filter, src/IBF/IBFBuild.cpp:223-321)."""
    from readbouncer_tpu_torch.ibf.build import update_ibf
    from readbouncer_tpu_torch.ibf.params import IBFParams
    from readbouncer_tpu_torch.ibf.storage import IBFData

    log = get_logger("IbfLog")
    src = config.ibf.update_filter
    ibf = IBFData.load(src, name=Path(src).stem)
    params = IBFParams(
        kmer_size=ibf.kmer_size,
        fragment_length=ibf.fragment_length or config.ibf.fragment_size,
        hash_functions=ibf.hash_functions,
        max_fp=ibf.max_fp,
        hash_scheme=ibf.scheme,
    )
    ibf, stats = update_ibf(ibf, config.ibf.target_files, params, device=device)
    dest = filter_output_path(config.output_dir, Path(src))
    ibf.save(dest)
    log.info(
        "updated %s -> %s: +%d bins (%d total), %d bits",
        src, dest, stats.new_bins, ibf.num_bins, stats.filter_size_bits,
    )
    if verbose:
        print(f"updated {dest}: +{stats.new_bins} bins ({ibf.num_bins} total)")
    return 0


def run_classify(config: ConfigReader, device, verbose: bool) -> int:
    """reference: main.cpp:346-369 -> classify_reads."""
    from readbouncer_tpu_torch.classify.engine import ClassifyResults, classify_read_files
    from readbouncer_tpu_torch.parallel.distributed import aggregate_counters, process_count, process_index

    targets = get_filters(config, config.ibf.target_files, device, verbose)
    depletes = get_filters(config, config.ibf.deplete_files, device, verbose)
    n_proc, idx = process_count(), process_index()
    results = classify_read_files(
        read_files=config.ibf.read_files,
        target_filters=targets,
        deplete_filters=depletes,
        error_rate=config.ibf.error_rate,
        output_dir=config.output_dir,
        significance=config.tpu.significance,
        chunk_length=config.ibf.chunk_length,
        max_chunks=config.ibf.max_chunks,
        batch_size=config.tpu.batch_size,
        verbose=(n_proc == 1),
        shard=(idx, n_proc),
        output_suffix=f".h{idx}" if n_proc > 1 else "",
        transfer_mode=config.tpu.transfer_mode,
        pipeline_depth=config.tpu.pipeline_depth,
        packing=config.tpu.packing,
        device=device,
    )
    if n_proc > 1:
        # rank 0 reports the counters summed over every process's shard
        summed = aggregate_counters({
            "found": results.found,
            "failed": results.failed,
            "too_short": results.too_short,
            "read_counter": results.read_counter,
            **{f"t:{k}": v for k, v in results.per_target.items()},
        })
        if idx == 0:
            agg = ClassifyResults(
                found=summed["found"],
                failed=summed["failed"],
                too_short=summed["too_short"],
                read_counter=summed["read_counter"],
                per_target={k[2:]: v for k, v in summed.items() if k.startswith("t:")},
                avg_classify_seconds=results.avg_classify_seconds,
            )
            print(agg.report(config.ibf.chunk_length))
    return 0


def make_replay_source(config: ConfigReader):
    """The MinKNOW stand-in: a replayed signal stream honoring the
    chunk/action timing contract (recorded signals, or squiggles
    synthesized from a FASTA).  In a multi-process run each process
    replays its share of the reads over its share of the channels."""
    from readbouncer_tpu_torch.errors import ConfigError
    from readbouncer_tpu_torch.stream.replay import ReplaySource

    if not config.tpu.replay_file and not config.tpu.replay_signals:
        raise ConfigError(
            "target/test usage needs TPU.replay_file (FASTA, squiggles "
            "synthesized) or TPU.replay_signals (recorded raw-signal "
            ".npz) — the replayed signal source standing in for a live "
            "MinKNOW run"
        )
    from readbouncer_tpu_torch.parallel.distributed import host_shard, process_count

    channels = config.minknow.max_channel - config.minknow.min_channel + 1
    if config.tpu.replay_signals:
        src = ReplaySource.from_signals(
            config.tpu.replay_signals,
            channels=channels,
            break_seconds=config.tpu.break_reads_after_seconds,
        )
    else:
        src = ReplaySource.from_fasta(
            [config.tpu.replay_file],
            channels=channels,
            break_seconds=config.tpu.break_reads_after_seconds,
        )
    if process_count() > 1:
        src.reads = host_shard(src.reads)
        src.channels = max(1, len(host_shard(list(range(src.channels)))))
        src.__post_init__()
    return src


def make_basecaller(config: ConfigReader, source, device):
    """The [Basecaller] caller: "Oracle" inverts the synthetic pore model;
    "DeepNano" (and any other GPU-server name) is the GRU on the card,
    its max_frames sized for one chunk window (padded to a multiple of
    64) from the loaded net's window and stride and the source's sample
    rate; "Guppy" / "remote" is a client of the basecall server at
    ``[Basecaller] host`` and ``port``."""
    caller = config.basecaller.caller.lower()
    if caller == "oracle":
        from readbouncer_tpu_torch.stream.replay import NearestLevelBasecaller

        return NearestLevelBasecaller()
    if caller in ("guppy", "remote"):
        from readbouncer_tpu_torch.models.remote import RemoteBasecaller

        return RemoteBasecaller(host=config.basecaller.host, port=int(config.basecaller.port))
    from readbouncer_tpu_torch.models.basecaller import GRUBasecaller

    basecaller = GRUBasecaller(
        network=config.basecaller.network,
        weights_dir=config.basecaller.weights_dir,
        gate_order=config.basecaller.gate_order,
        device=device,
    )
    w, st = basecaller.model.window, basecaller.frame_stride
    chunk_samples = int(source.sample_rate * config.tpu.break_reads_after_seconds)
    frames = (max(chunk_samples, w) - w) // st + 1
    basecaller.max_frames = -(-frames // 64) * 64
    return basecaller


def live_config(config: ConfigReader):
    """The LiveConfig of a target run."""
    from readbouncer_tpu_torch.stream.scheduler import LiveConfig

    return LiveConfig(
        error_rate=config.ibf.error_rate,
        significance=config.tpu.significance,
        batch_size=config.tpu.batch_size,
        overlap_ticks=config.tpu.overlap_ticks,
        mid_len=config.tpu.live_mid_len,
    )


def live_mesh(config: ConfigReader, device):
    """The mesh of ``[TPU] mesh_shape`` for the sharded live classifier:
    over this process's visible cards, or with ``--device cpu`` over as
    many CPU shards as the shape asks.  Under ``[TPU] coordinator`` each
    process replays its own share of the reads, so the mesh stays the
    process's own (never the group's)."""
    import math

    import torch

    from readbouncer_tpu_torch.device import resolve_device
    from readbouncer_tpu_torch.parallel.mesh import make_mesh, parse_mesh_shape

    shape = parse_mesh_shape(config.tpu.mesh_shape)
    if resolve_device(device).type == "cpu":
        devices = ["cpu"] * math.prod(shape.values())
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return make_mesh(shape, devices)


def run_target(config: ConfigReader, device, verbose: bool) -> int:
    """reference: adaptive_sampling, src/main/adaptive_sampling.hpp:555-774."""
    from readbouncer_tpu_torch.stream.control import ReplayConnection
    from readbouncer_tpu_torch.stream.scheduler import AdaptiveSampler, LiveClassifier

    log = get_logger("RUClientLog")
    # a mesh the devices cannot hold fails here, before any work
    mesh = live_mesh(config, device) if config.tpu.mesh_shape else None
    targets = get_filters(config, config.ibf.target_files, device, verbose)
    depletes = get_filters(config, config.ibf.deplete_files, device, verbose)
    source = make_replay_source(config)
    # bootstrap as the reference's adaptive_sampling does (connect ->
    # wait for acquisition -> set chunk cadence; adaptive_sampling.hpp:590-634)
    conn = ReplayConnection(source, config.minknow.flowcell or "replay").connect()
    conn.acquisition.has_started()
    conn.analysis.set_break_reads_after_seconds(config.tpu.break_reads_after_seconds)
    log.info(conn.summary())
    basecaller = make_basecaller(config, source, device)
    cfg = live_config(config)
    if mesh is not None:
        from readbouncer_tpu_torch.parallel.sharded import ShardedLiveClassifier

        classifier = ShardedLiveClassifier(targets, depletes, cfg, mesh)
        log.info("live classifier: mesh %s", config.tpu.mesh_shape)
    else:
        classifier = LiveClassifier(targets, depletes, cfg, device=device)
    sampler = AdaptiveSampler(source, basecaller, classifier, output_dir=config.output_dir, cfg=cfg)
    log.info("live run starting: %d queued reads", len(source.reads))
    # Ctrl-C requests a graceful stop: actions drain and the final block
    # still prints (reference SIGINT handler, src/main/main.cpp:69-78)
    stats = sampler.run(handle_sigint=True)
    print(stats.report())
    log.info("live run finished after %d ticks", stats.ticks)
    return 0


def run_test(config: ConfigReader, device, verbose: bool) -> int:
    """Connection test (reference: test_connection,
    src/main/connection_test.hpp:36-155): bring the stream up, probe one
    chunk window, report.  The reference's unblock-all load test is
    disabled there (connection_test.hpp:75) and is not carried over."""
    from readbouncer_tpu_torch.stream.control import ReplayConnection

    source = make_replay_source(config)
    conn = ReplayConnection(source, config.minknow.flowcell or "replay").connect()
    chunks = source.tick()
    print(f"Connection to replay source successful: {conn.summary()}")
    print(f"{len(chunks)} chunks in first window")
    return 0


def run_program(config: ConfigReader, device=None, verbose: bool = False) -> int:
    """reference: run_program, src/main/main.cpp:274-404."""
    dispatch = {
        "build": run_build,
        "classify": run_classify,
        "update": run_update,
        "target": run_target,
        "test": run_test,
    }
    return dispatch[config.usage](config, device, verbose)


def _resource_report(wall_seconds: float) -> str:
    """Real/CPU/peak-RSS summary (reference: src/main/main.cpp:439-444)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return (
        f"Real time : {wall_seconds:.3f} sec\n"
        f"CPU time  : {ru.ru_utime + ru.ru_stime:.3f} sec\n"
        f"Peak RSS  : {ru.ru_maxrss / 1024.0:.1f} MBytes"
    )


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    t0 = time.monotonic()
    config = ConfigReader(args.config).parse()
    if config.tpu.coordinator:
        from readbouncer_tpu_torch.errors import ConfigError
        from readbouncer_tpu_torch.parallel.distributed import init_distributed, shutdown_distributed

        try:
            init_distributed(config.tpu.coordinator, config.tpu.num_processes, config.tpu.process_id)
        except ConfigError as e:
            print(f"readbouncer-tpu-torch: {e}", file=sys.stderr)
            return 2
        try:
            return _run(args, config, t0)
        finally:
            shutdown_distributed()
    return _run(args, config, t0)


def _run(args: argparse.Namespace, config: ConfigReader, t0: float) -> int:
    setup_loggers(config.log_dir)
    config.create_log()
    log = get_logger("ReadBouncerLog")
    log.info("usage=%s config=%s device=%s", config.usage, args.config, args.device)
    try:
        rc = run_program(config, device=args.device, verbose=args.verbose)
    except Exception:
        log.exception("run failed")
        raise
    if rc == 0:
        print(_resource_report(time.monotonic() - t0))
    return rc


if __name__ == "__main__":
    sys.exit(main())
