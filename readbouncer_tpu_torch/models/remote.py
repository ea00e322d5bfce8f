"""Out-of-process basecaller client — the torch counterpart of
readbouncer_tpu/models/remote.py, the Guppy-server slot.

The reference's second basecaller is a client to an external GPU
basecall server (GuppyBasecaller, reference:
src/basecaller/Guppy/GuppyBasecaller.cpp + the vendored GuppyCPPClient).
This client speaks a newline-delimited-JSON protocol to any TCP basecall
server and keeps the reference client's semantics:

* signals are converted float -> int16 before transmission
  (reference: GuppyBasecaller.cpp:78-80),
* each read is submitted with a ``read_tag`` and results are re-joined
  by tag, tolerating out-of-order completion
  (reference: GuppyBasecaller.cpp:137-140),
* submissions are batched (initial batch 200,
  reference: GuppyBasecaller.hpp:34),
* connect has a bounded timeout (30 s in the reference,
  GuppyBasecaller.cpp:24), and so has every read.

Wire protocol (one JSON object per line, UTF-8):
  client -> server: {"tag": int, "signal": [int16, ...]}
  server -> client: {"tag": int, "seq": "ACGT..."}

The short-result pending/concat logic (<250 bp parked for the read's
next chunk) lives in the live scheduler like for every other caller
(stream/scheduler.py), not here.  Host code only: nothing here touches a
device.
"""

from __future__ import annotations

import json
import socket

import numpy as np

from readbouncer_tpu_torch.errors import BasecallerError
from readbouncer_tpu_torch.models.basecaller import Basecaller

__all__ = ["RemoteBasecaller", "serve_basecalls"]


class RemoteBasecaller(Basecaller):
    """TCP client to an external basecall server (the Guppy slot)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 5555,
        batch_size: int = 200,  # reference: GuppyBasecaller.hpp:34
        connect_timeout: float = 30.0,  # reference: GuppyBasecaller.cpp:24
        read_timeout: float = 60.0,  # a hung server raises, never stalls
    ):
        self.host = host
        self.port = int(port)
        self.batch_size = batch_size
        self.connect_timeout = connect_timeout
        self.read_timeout = read_timeout
        self._sock: socket.socket | None = None
        self._rx = b""
        self._next_tag = 0

    def _connect(self) -> socket.socket:
        if self._sock is None:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=self.connect_timeout
                )
            except OSError as e:
                raise BasecallerError(
                    f"cannot reach basecall server at {self.host}:{self.port}: {e}"
                ) from e
            self._sock.settimeout(self.read_timeout)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        # a half-read line or unconsumed responses must not survive into
        # the next connection: a retried basecall() would join stale
        # tags against a fresh batch
        self._rx = b""

    def _recv_line(self, sock: socket.socket) -> dict:
        while b"\n" not in self._rx:
            try:
                data = sock.recv(65536)
            except socket.timeout:
                raise BasecallerError(
                    f"basecall server sent no response within "
                    f"{self.read_timeout:.0f}s"
                ) from None
            if not data:
                raise BasecallerError("basecall server closed the connection")
            self._rx += data
        line, self._rx = self._rx.split(b"\n", 1)
        return json.loads(line)

    def _try_recv_line(self, sock: socket.socket) -> dict | None:
        """Parse one response iff it can be had without blocking."""
        import select

        while b"\n" not in self._rx:
            r, _, _ = select.select([sock], [], [], 0)
            if not r:
                return None
            data = sock.recv(65536)
            if not data:
                raise BasecallerError("basecall server closed the connection")
            self._rx += data
        line, self._rx = self._rx.split(b"\n", 1)
        return json.loads(line)

    def basecall(self, signals: list[np.ndarray]) -> list[str]:
        """Submit a batch, re-join results by read tag.

        Sends one read at a time and drains any responses already
        available between sends: a serial request/response server (like
        serve_basecalls) answers while the client is still submitting,
        and a multi-MB whole-batch sendall against such a server can
        deadlock once both sockets' buffers fill — so sends and receives
        interleave, and the final collection loop runs under
        ``read_timeout``.
        """
        if not signals:
            return []
        try:
            return self._basecall_inner(signals)
        except BasecallerError:
            # the stream is desynced (timeout/EOF mid-batch): drop the
            # connection so a retry starts clean instead of consuming
            # stale responses against new tags
            self.close()
            raise
        except socket.timeout as e:
            self.close()
            raise BasecallerError(
                f"basecall server stalled (no progress within "
                f"{self.read_timeout:.0f}s)"
            ) from e
        except OSError as e:
            self.close()
            raise BasecallerError(f"basecall connection failed: {e}") from e

    def _basecall_inner(self, signals: list[np.ndarray]) -> list[str]:
        sock = self._connect()
        tags = []
        out: dict[int, str] = {}
        pending = 0
        for sig in signals:
            # flow control: at most batch_size requests outstanding (the
            # reference client's submission-batch bound,
            # GuppyBasecaller.hpp:34) — bounds the server-side queue and
            # both sockets' buffered bytes
            while pending >= self.batch_size:
                resp = self._recv_line(sock)
                out[int(resp["tag"])] = str(resp["seq"])
                pending -= 1
            tag = self._next_tag
            self._next_tag += 1
            tags.append(tag)
            # float signal -> int16, exactly like the reference client
            i16 = np.asarray(sig, dtype=np.float32).astype(np.int16)
            sock.sendall(
                (json.dumps({"tag": tag, "signal": i16.tolist()}) + "\n").encode()
            )
            pending += 1
            while pending:  # results may arrive in any order
                resp = self._try_recv_line(sock)
                if resp is None:
                    break
                out[int(resp["tag"])] = str(resp["seq"])
                pending -= 1
        while pending:
            resp = self._recv_line(sock)
            out[int(resp["tag"])] = str(resp["seq"])
            pending -= 1
        return [out[t] for t in tags]


def serve_basecalls(
    server_sock: socket.socket, basecall_fn, max_requests: int | None = None
) -> int:
    """Minimal single-connection basecall server loop (test/reference
    harness — run a real model behind it to stand in for guppy_basecall
    server).  Returns the number of reads served."""
    conn, _ = server_sock.accept()
    served = 0
    rx = b""
    try:
        with conn:
            while max_requests is None or served < max_requests:
                while b"\n" not in rx:
                    data = conn.recv(65536)
                    if not data:
                        return served
                    rx += data
                line, rx = rx.split(b"\n", 1)
                req = json.loads(line)
                sig = np.asarray(req["signal"], dtype=np.float32)
                seq = basecall_fn([sig])[0]
                conn.sendall(
                    (json.dumps({"tag": req["tag"], "seq": seq}) + "\n").encode()
                )
                served += 1
    except (ConnectionResetError, BrokenPipeError):
        pass
    return served
