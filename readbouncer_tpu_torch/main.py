"""Command line: ``python -m readbouncer_tpu_torch --config file.toml``.

The torch counterpart of readbouncer_tpu/main.py for the usages this
port covers, on the same TOML schema (config.py):

* ``classify`` — load the ``.ribf`` filters, classify the read files,
  write the per-target FASTAs and ``unclassified.fasta`` and print the
  final results block;
* ``target`` — the live adaptive-sampling loop over a replayed signal
  source (``[TPU] replay_file`` or ``replay_signals``): basecall each
  0.4 s chunk (the Oracle caller or the GRU), decide it against the
  ``.ribf`` filters, send unblock / stop_receiving actions, write
  ``TargetReads.fasta``, ``DepletedReads.fasta`` and the decision CSV;
* ``test`` — bring the replay source up and report its first window.

``build`` and ``update``, FASTA filter inputs (which the reference builds
on the fly), the remote basecaller (``caller = "Guppy"``) and the device
mesh (``mesh_shape``) are not ported yet: they exit with status 2 and
name the ROADMAP item that ports them.  The device is the CUDA card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from readbouncer_tpu_torch.config import ConfigReader
from readbouncer_tpu_torch.utils.logging import get_logger, setup_loggers

__all__ = ["main", "run_program", "load_filters", "make_replay_source", "make_basecaller", "live_config"]

NOT_PORTED = {
    "build": "M13 (build usage, FASTA filter inputs) in ROADMAP.md",
    "update": "M12 (update usage) in ROADMAP.md",
    "remote": "M8 (models/remote.py, the remote basecaller) in ROADMAP.md",
    "mesh": "M9 (parallel/, the device mesh and multi-process runs) in ROADMAP.md",
}
USAGES_NOT_PORTED = ("build", "update")


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


def load_filters(files: list[Path]) -> list | None:
    """Load each .ribf input; None when one is not a filter file (a
    FASTA, which the reference's getIBF builds: not ported yet)."""
    from readbouncer_tpu_torch.ibf.storage import IBFData, sniff

    log = get_logger("IbfLog")
    out = []
    for f in map(Path, files):
        if not sniff(f):
            return None
        log.info("loading filter file %s", f)
        out.append(IBFData.load(f, name=f.stem))
    return out


def _not_ported(what: str, item: str) -> int:
    print(
        f"{what} is not ported to readbouncer_tpu_torch yet; "
        f"see {item} (python -m readbouncer_tpu runs it)",
        file=sys.stderr,
    )
    return 2


def run_classify(config: ConfigReader, device, verbose: bool) -> int:
    """reference: main.cpp:346-369 -> classify_reads."""
    from readbouncer_tpu_torch.classify.engine import classify_read_files

    targets = load_filters(config.ibf.target_files)
    depletes = load_filters(config.ibf.deplete_files)
    if targets is None or depletes is None:
        return _not_ported("building filters from FASTA inputs", NOT_PORTED["build"])
    classify_read_files(
        read_files=config.ibf.read_files,
        target_filters=targets,
        deplete_filters=depletes,
        error_rate=config.ibf.error_rate,
        output_dir=config.output_dir,
        significance=config.tpu.significance,
        chunk_length=config.ibf.chunk_length,
        max_chunks=config.ibf.max_chunks,
        batch_size=config.tpu.batch_size,
        transfer_mode=config.tpu.transfer_mode,
        pipeline_depth=config.tpu.pipeline_depth,
        packing=config.tpu.packing,
        device=device,
    )
    return 0


def make_replay_source(config: ConfigReader):
    """The MinKNOW stand-in: a replayed signal stream honoring the
    chunk/action timing contract (recorded signals, or squiggles
    synthesized from a FASTA)."""
    from readbouncer_tpu_torch.errors import ConfigError
    from readbouncer_tpu_torch.stream.replay import ReplaySource

    if not config.tpu.replay_file and not config.tpu.replay_signals:
        raise ConfigError(
            "target/test usage needs TPU.replay_file (FASTA, squiggles "
            "synthesized) or TPU.replay_signals (recorded raw-signal "
            ".npz) — the replayed signal source standing in for a live "
            "MinKNOW run"
        )
    channels = config.minknow.max_channel - config.minknow.min_channel + 1
    if config.tpu.replay_signals:
        return ReplaySource.from_signals(
            config.tpu.replay_signals,
            channels=channels,
            break_seconds=config.tpu.break_reads_after_seconds,
        )
    return ReplaySource.from_fasta(
        [config.tpu.replay_file],
        channels=channels,
        break_seconds=config.tpu.break_reads_after_seconds,
    )


def make_basecaller(config: ConfigReader, source, device):
    """The [Basecaller] caller: "Oracle" inverts the synthetic pore model;
    "DeepNano" (and any other GPU-server name) is the GRU on the card,
    its max_frames sized for one chunk window (padded to a multiple of
    64) from the loaded net's window and stride and the source's sample
    rate.  None for the remote caller, which is not ported."""
    caller = config.basecaller.caller.lower()
    if caller == "oracle":
        from readbouncer_tpu_torch.stream.replay import NearestLevelBasecaller

        return NearestLevelBasecaller()
    if caller in ("guppy", "remote"):
        return None
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


def run_target(config: ConfigReader, device, verbose: bool) -> int:
    """reference: adaptive_sampling, src/main/adaptive_sampling.hpp:555-774."""
    from readbouncer_tpu_torch.stream.control import ReplayConnection
    from readbouncer_tpu_torch.stream.scheduler import AdaptiveSampler, LiveClassifier

    if config.tpu.mesh_shape:
        return _not_ported("the live classifier over a device mesh (TPU.mesh_shape)", NOT_PORTED["mesh"])
    if config.basecaller.caller.lower() in ("guppy", "remote"):
        return _not_ported(f"caller '{config.basecaller.caller}'", NOT_PORTED["remote"])
    log = get_logger("RUClientLog")
    targets = load_filters(config.ibf.target_files)
    depletes = load_filters(config.ibf.deplete_files)
    if targets is None or depletes is None:
        return _not_ported("building filters from FASTA inputs", NOT_PORTED["build"])
    source = make_replay_source(config)
    # bootstrap as the reference's adaptive_sampling does (connect ->
    # wait for acquisition -> set chunk cadence; adaptive_sampling.hpp:590-634)
    conn = ReplayConnection(source, config.minknow.flowcell or "replay").connect()
    conn.acquisition.has_started()
    conn.analysis.set_break_reads_after_seconds(config.tpu.break_reads_after_seconds)
    log.info(conn.summary())
    basecaller = make_basecaller(config, source, device)
    cfg = live_config(config)
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
    if config.usage in USAGES_NOT_PORTED:
        return _not_ported(f"usage '{config.usage}'", NOT_PORTED[config.usage])
    dispatch = {"classify": run_classify, "target": run_target, "test": run_test}
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
