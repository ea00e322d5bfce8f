"""Run-control surface over the replay source — the MinKNOW service layer.

A copy of readbouncer_tpu/stream/control.py (the port imports nothing of the JAX
package).

The reference talks to MinKNOW through one gRPC client per service
(namespace readuntil, src/minknow/*): Manager resolves the per-flowcell
RPC port, Instance/Device report identity, Acquisition gates on run
state, AnalysisConfiguration sets the chunk cadence, and
ReadUntilClient bootstraps them all (TLS + token auth).  The rebuild's
sequencer is the in-process replay source (SURVEY.md §2.1 item 3), so
these services become thin state views over it — but the SURFACE is
kept, so the CLI (main.run_target / run_test) performs the same
bootstrap sequence as the reference's adaptive_sampling
(src/main/adaptive_sampling.hpp:590-634) and a real gRPC backend could
be slotted behind the same classes.

| reference class (src/minknow/)      | here                      |
|-------------------------------------|---------------------------|
| ReadUntilClient::connect RUC.cpp:43 | ReplayConnection.connect  |
| Manager::resolveRpcPort Mgr.cpp:64  | Manager.resolve_rpc_port  |
| Instance (version) Inst.cpp:17      | Instance.version          |
| Device (type/id/state) Dev.cpp:21   | Device.device_type/id     |
| Acquisition::hasStarted Acq.cpp:19  | Acquisition.has_started   |
| Acquisition::isFinished Acq.cpp:53  | Acquisition.is_finished   |
| AnalysisConfiguration::set_break_   | AnalysisConfiguration.    |
|   reads_after_seconds AC.cpp:28     |   set_break_reads_after_seconds |
"""

from __future__ import annotations

from dataclasses import dataclass

from readbouncer_tpu_torch.errors import ConfigError
from readbouncer_tpu_torch.stream.replay import ReplaySource

__all__ = [
    "Manager",
    "Instance",
    "Device",
    "Acquisition",
    "AnalysisConfiguration",
    "ReplayConnection",
]

_VERSION = "replay-1"


@dataclass
class Manager:
    """Port resolution (reference: Manager::resolveRpcPort, Manager.cpp:64-75).

    The replay backend has no real RPC port; the resolved value is a
    stable placeholder so bootstrap logging matches the reference flow.
    """

    flowcell: str
    base_port: int = 9501

    def resolve_rpc_port(self) -> int:
        return self.base_port

    def token_path(self) -> str:  # local-auth token (Manager.cpp:94-102)
        return ""


@dataclass
class Instance:
    """Version info (reference: Instance.cpp:17-33)."""

    def version(self) -> str:
        return _VERSION


@dataclass
class Device:
    """Device identity/state (reference: Device.cpp:21-52)."""

    source: ReplaySource
    flowcell: str = "replay"

    def device_type(self) -> str:
        return "REPLAY"

    def device_id(self) -> str:
        return self.flowcell

    def state(self) -> str:
        return "DEVICE_READY" if not self.source.finished else "DEVICE_DISCONNECTED"


@dataclass
class Acquisition:
    """Run-state gates (reference: Acquisition.cpp:19-73).

    has_started blocks-in-the-reference until PROCESSING; replay runs
    are started by construction, so it returns immediately — the call
    sites keep the same shape.
    """

    source: ReplaySource

    def has_started(self) -> bool:
        return True

    def is_finished(self) -> bool:
        return self.source.finished


@dataclass
class AnalysisConfiguration:
    """Chunk cadence control (reference: Analysis_Configuration.cpp:28-82)."""

    source: ReplaySource

    def set_break_reads_after_seconds(self, seconds: float) -> None:
        self.source.break_seconds = seconds
        self.source.chunk_samples = int(self.source.sample_rate * seconds)

    def break_reads_after_seconds(self) -> float:
        return self.source.break_seconds


class ReplayConnection:
    """The ReadUntilClient analog: bootstrap every service for a run
    (reference: ReadUntilClient::connect, ReadUntilClient.cpp:43-146 —
    manager port -> auth -> per-device services)."""

    def __init__(self, source: ReplaySource, flowcell: str = "replay"):
        self.source = source
        self.flowcell = flowcell
        self.connected = False

    def connect(self) -> "ReplayConnection":
        if not self.source.reads and self.source.finished:
            raise ConfigError(
                f"flowcell {self.flowcell!r}: replay source has no reads"
            )
        self.manager = Manager(self.flowcell)
        self.instance = Instance()
        self.device = Device(self.source, self.flowcell)
        self.acquisition = Acquisition(self.source)
        self.analysis = AnalysisConfiguration(self.source)
        self.connected = True
        return self

    def summary(self) -> str:
        return (
            f"connected to {self.device.device_type()} {self.device.device_id()} "
            f"(version {self.instance.version()}, port {self.manager.resolve_rpc_port()}): "
            f"{len(self.source.reads)} queued reads, {self.source.channels} channels, "
            f"chunk window {self.analysis.break_reads_after_seconds()} s"
        )
