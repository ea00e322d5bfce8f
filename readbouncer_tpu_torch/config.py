"""TOML configuration — same schema as the reference.

A copy of readbouncer_tpu/config.py: the port reads the same TOML files.

Mirrors ConfigReader (reference: src/config/configReader.cpp:59-439):
top-level ``usage``/``output_directory``/``log_directory`` plus the
``[IBF]``, ``[MinKNOW]`` and ``[Basecaller]`` tables with the reference's
defaults.  ``create_log`` echoes the effective config like the
reference's configLog.toml (src/config/configReader.cpp:98-200).

Extra (TPU-rebuild) keys, all optional and defaulted, live in the
``[TPU]`` table: batch sizes, replay source for the streaming harness,
and mesh shape — surfacing the constants the reference hard-codes
(SURVEY.md §5.6).
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field

from readbouncer_tpu_torch.errors import ConfigError, MissingInputError
from pathlib import Path

__all__ = ["IBFParamsConfig", "MinKNOWParams", "BasecallerParams", "TPUParams", "ConfigReader"]


@dataclass
class IBFParamsConfig:
    """[IBF] table (reference: src/config/configReader.cpp:232-350)."""

    kmer_size: int = 13
    fragment_size: int = 100_000
    threads: int = 1
    error_rate: float = 0.1  # exp_seq_error_rate
    chunk_length: int = 250
    max_chunks: int = 5
    target_files: list[Path] = field(default_factory=list)
    deplete_files: list[Path] = field(default_factory=list)
    read_files: list[Path] = field(default_factory=list)
    # usage="update": the existing .ribf to extend with target_files
    # (rebuild-specific: the reference's IBF::update_filter exists but is
    # unreachable from any TOML usage, src/IBF/IBFBuild.cpp:223)
    update_filter: Path | None = None


@dataclass
class MinKNOWParams:
    """[MinKNOW] table (reference: src/config/configReader.cpp:353-386)."""

    host: str = "127.0.0.1"
    port: str = "9501"
    flowcell: str = ""
    min_channel: int = 1
    max_channel: int = 512
    token_path: str = ""


@dataclass
class BasecallerParams:
    """[Basecaller] table (reference: src/config/configReader.cpp:393-420)."""

    caller: str = "DeepNano"
    host: str = "127.0.0.1"
    port: str = "5555"
    threads: int = 3
    config: str = "dna_r9.4.1_450bps_fast"
    # TPU rebuild: which DeepNano-blitz net to load (48/56/64/80/96)
    network: str = "48"
    weights_dir: str = ""
    # rnn*.txt gate-group assignment ("zrn" | "rzn") — switches the
    # documented interpretation ambiguity of the source-less prebuilt
    # deepnano2 library without a code change (docs/BASECALLER.md)
    gate_order: str = "zrn"


@dataclass
class TPUParams:
    """[TPU] table — rebuild-specific knobs (absent from the reference;
    surfaces SURVEY.md §5.6 hard-coded constants as config)."""

    batch_size: int = 1024
    significance: float = 0.95
    hash_functions: int = 3
    max_fp: float = 0.01
    # phase-B uploads: "serial" | "overlap" | "auto"
    # (classify.engine.choose_transfer_mode); read-pool packing: "auto"
    # (2-bit for pure-ACGT batches, base-243 where a batch holds an N) |
    # "2bit" | "base243" (classify.engine.ClassifyEngine)
    transfer_mode: str = "serial"
    packing: str = "auto"
    # host batches in flight in classify (2 = double-buffered: encode/
    # upload of batch i+1 and writes of batch i-1 overlap device compute)
    pipeline_depth: int = 2
    break_reads_after_seconds: float = 0.4
    action_pacing_seconds: float = 0.4
    unblock_duration: float = 0.1
    # live cross-tick pipelining: basecall(t) collected during tick t+1
    # (hides transfers, delays decisions one tick — see BENCHMARKS.md)
    overlap_ticks: bool = False
    # extra live length bucket between 512 and max_seq_len (0 = off):
    # trims the once_seen-retry p95 tail at the cost of one more
    # program compile at startup (stream/scheduler.LiveConfig.mid_len)
    live_mid_len: int = 0
    replay_file: str = ""  # FASTA replay source (squiggles synthesized)
    # recorded raw-signal replay: an .npz of per-read float sample
    # arrays (ReplaySource.from_signals) — the stand-in for the
    # reference's MinKNOW bulk-FAST5 playback run (README.md:266-323).
    # Takes precedence over replay_file when both are set.
    replay_signals: str = ""
    mesh_shape: str = ""  # e.g. "data:4,bins:2"
    # multi-host: jax.distributed coordinator ("host0:8476"); empty = single
    # process.  Input shards per host; GSPMD runs over the global mesh.
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1


class ConfigReader:
    """Parse + validate a ReadBouncer TOML config file."""

    VALID_USAGES = ("build", "classify", "update", "target", "test")

    def __init__(self, config_file: str | Path):
        self.config_file = Path(config_file)
        with open(self.config_file, "rb") as f:
            self._raw = tomllib.load(f)
        self.usage: str = ""
        self.output_dir: Path = Path(".")
        self.log_dir: Path = Path(".")
        self.ibf = IBFParamsConfig()
        self.minknow = MinKNOWParams()
        self.basecaller = BasecallerParams()
        self.tpu = TPUParams()

    # -- parsing ---------------------------------------------------------
    def parse_general(self) -> None:
        """reference: src/config/configReader.cpp:59-90."""
        try:
            self.usage = str(self._raw["usage"])
        except KeyError as e:
            raise ConfigError("config file must set 'usage'") from e
        if self.usage not in self.VALID_USAGES:
            raise ConfigError(
                f"usage must be one of {self.VALID_USAGES}, got {self.usage!r}"
            )
        self.output_dir = Path(self._raw.get("output_directory", "."))
        self.log_dir = Path(self._raw.get("log_directory", "."))
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.log_dir.mkdir(parents=True, exist_ok=True)

    def read_ibf(self) -> None:
        """reference: src/config/configReader.cpp:232-350."""
        t = self._raw.get("IBF", {})
        self.ibf.kmer_size = int(t.get("kmer_size", 13))
        self.ibf.fragment_size = int(t.get("fragment_size", 100_000))
        self.ibf.threads = int(t.get("threads", 1))
        self.ibf.error_rate = float(t.get("exp_seq_error_rate", 0.1))
        self.ibf.chunk_length = int(t.get("chunk_length", 250))
        self.ibf.max_chunks = int(t.get("max_chunks", 5))
        self.ibf.target_files = [Path(p) for p in t.get("target_files", [])]
        self.ibf.deplete_files = [Path(p) for p in t.get("deplete_files", [])]
        rf = t.get("read_files", [])
        self.ibf.read_files = [Path(p) for p in rf]
        uf = t.get("update_filter", "")
        self.ibf.update_filter = Path(uf) if uf else None
        if self.usage != "test":
            if not self.ibf.target_files and not self.ibf.deplete_files:
                raise MissingInputError(
                    "at least one of IBF.target_files / IBF.deplete_files is required"
                )
        if self.usage == "classify" and not self.ibf.read_files:
            raise MissingInputError("classify usage requires IBF.read_files")
        if self.usage == "update":
            if self.ibf.update_filter is None:
                raise MissingInputError(
                    "update usage requires IBF.update_filter (the .ribf to extend)"
                )
            if not self.ibf.target_files:
                raise MissingInputError(
                    "update usage requires IBF.target_files (new references to append)"
                )

    def read_minknow(self) -> None:
        """reference: src/config/configReader.cpp:353-386."""
        t = self._raw.get("MinKNOW", {})
        self.minknow.flowcell = str(t.get("flowcell", ""))
        self.minknow.host = str(t.get("host", "127.0.0.1"))
        self.minknow.port = str(t.get("port", "9501"))
        self.minknow.token_path = str(t.get("token_path", ""))
        channels = t.get("channels", [])
        if len(channels) == 2:
            self.minknow.min_channel = int(channels[0])
            self.minknow.max_channel = int(channels[1])

    def read_basecaller(self) -> None:
        """reference: src/config/configReader.cpp:393-420."""
        t = self._raw.get("Basecaller", {})
        self.basecaller.caller = str(t.get("caller", "DeepNano"))
        self.basecaller.host = str(t.get("host", "127.0.0.1"))
        self.basecaller.port = str(t.get("port", "5555"))
        self.basecaller.threads = int(t.get("threads", 3))
        self.basecaller.config = str(t.get("config", "dna_r9.4.1_450bps_fast"))
        self.basecaller.network = str(t.get("network", "48"))
        self.basecaller.weights_dir = str(t.get("weights_dir", ""))
        self.basecaller.gate_order = str(t.get("gate_order", "zrn"))

    def read_tpu(self) -> None:
        t = self._raw.get("TPU", {})
        for name in vars(self.tpu):
            if name in t:
                cur = getattr(self.tpu, name)
                setattr(self.tpu, name, type(cur)(t[name]))

    def parse(self) -> "ConfigReader":
        self.parse_general()
        self.read_ibf()
        if self.usage in ("target", "test"):
            self.read_minknow()
            self.read_basecaller()
        self.read_tpu()
        return self

    # -- effective-config echo ------------------------------------------
    @staticmethod
    def _toml_str(v) -> str:
        """Double-quoted TOML string with backslashes/quotes escaped."""
        s = str(v).replace("\\", "\\\\").replace('"', '\\"')
        return f'"{s}"'

    def create_log(self) -> Path:
        """Write configLog.toml with the effective settings
        (reference: src/config/configReader.cpp:98-200)."""
        q = self._toml_str
        out = self.log_dir / "configLog.toml"
        lines = [
            f"usage = {q(self.usage)}",
            f"output_directory = {q(self.output_dir)}",
            f"log_directory = {q(self.log_dir)}",
            "",
            "[IBF]",
            f"kmer_size = {self.ibf.kmer_size}",
            f"fragment_size = {self.ibf.fragment_size}",
            f"threads = {self.ibf.threads}",
            f"exp_seq_error_rate = {self.ibf.error_rate}",
            f"chunk_length = {self.ibf.chunk_length}",
            f"max_chunks = {self.ibf.max_chunks}",
            f"target_files = [{', '.join(q(p) for p in self.ibf.target_files)}]",
            f"deplete_files = [{', '.join(q(p) for p in self.ibf.deplete_files)}]",
            f"read_files = [{', '.join(q(p) for p in self.ibf.read_files)}]",
            f"update_filter = {q(self.ibf.update_filter or '')}",
            "",
            "[MinKNOW]",
            f"host = {q(self.minknow.host)}",
            f"port = {q(self.minknow.port)}",
            f"flowcell = {q(self.minknow.flowcell)}",
            f"channels = [{self.minknow.min_channel}, {self.minknow.max_channel}]",
            "",
            "[Basecaller]",
            f"caller = {q(self.basecaller.caller)}",
            f"threads = {self.basecaller.threads}",
            f"network = {q(self.basecaller.network)}",
            f"gate_order = {q(self.basecaller.gate_order)}",
            "",
            "[TPU]",
        ]
        for name in vars(self.tpu):
            v = getattr(self.tpu, name)
            if isinstance(v, bool):
                lines.append(f"{name} = {str(v).lower()}")
            elif isinstance(v, str):
                lines.append(f"{name} = {q(v)}")
            else:
                lines.append(f"{name} = {v}")
        out.write_text("\n".join(lines) + "\n")
        return out
