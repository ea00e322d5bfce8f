"""The port's RemoteBasecaller (the out-of-process, Guppy-slot basecall
client, models/remote.py) on the cases of tests/test_remote_basecaller.py,
against a local server (``serve_basecalls`` in a thread): float -> int16
on the wire, re-join by tag out of order, batched submission without a
deadlock on multi-MB batches, a bounded connect; and the live loop
through the remote caller, equal to the JAX package's."""

import json
import socket
import threading

import numpy as np
import pytest
import torch

from readbouncer_tpu.models.remote import RemoteBasecaller as JaxRemote
from readbouncer_tpu.models.remote import serve_basecalls as jax_serve
from readbouncer_tpu.stream.replay import NearestLevelBasecaller as JaxOracle
from readbouncer_tpu_torch.errors import BasecallerError
from readbouncer_tpu_torch.models.remote import RemoteBasecaller, serve_basecalls
from readbouncer_tpu_torch.stream.replay import NearestLevelBasecaller, sequence_to_signal
from torch_live_world import make_reads, make_world, run_live

torch.set_num_threads(1)


def _start_server(basecall_fn, serve=serve_basecalls):
    """serve_basecalls over one connection in a thread: (port, thread, [reads served])."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    served = []

    def run():
        with srv:
            served.append(serve(srv, basecall_fn))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv.getsockname()[1], t, served


def _one_shot_server(handler):
    """A server that hands its one connection to ``handler``; returns the port."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        conn, _ = srv.accept()
        with conn, srv:
            handler(conn)

    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[1]


def test_remote_basecaller_round_trip():
    rng = np.random.default_rng(3)
    seqs = ["".join("ACGT"[i] for i in rng.integers(0, 4, 120)) for _ in range(7)]
    # noise below the int16 truncation floor keeps the oracle exact
    sigs = [sequence_to_signal(s, 9, 0.0, rng) for s in seqs]
    port, _, _ = _start_server(NearestLevelBasecaller().basecall)
    bc = RemoteBasecaller(port=port, batch_size=3)
    try:
        assert bc.basecall(sigs) == seqs
    finally:
        bc.close()


def test_remote_basecaller_large_batch_no_deadlock():
    """~7 MB of JSON against a serial request/response server: sends and
    receives interleave, so neither socket's buffer wedges."""
    n, samples = 12, 100_000
    sigs = [np.full(samples, 100.0, np.float32) for _ in range(n)]
    port, t, served = _start_server(lambda batch: ["A" * 5 for _ in batch])
    bc = RemoteBasecaller(port=port, read_timeout=30.0)
    try:
        assert bc.basecall(sigs) == ["A" * 5] * n
    finally:
        bc.close()
    t.join(10)
    assert served == [n]


def test_remote_basecaller_out_of_order_tags():
    def reversing(conn):
        rx = b""
        while rx.count(b"\n") < 4:
            rx += conn.recv(65536)
        for req in reversed([json.loads(ln) for ln in rx.split(b"\n") if ln]):
            seq = "A" * (req["tag"] % 5 + 1)
            conn.sendall((json.dumps({"tag": req["tag"], "seq": seq}) + "\n").encode())

    bc = RemoteBasecaller(port=_one_shot_server(reversing), batch_size=4)
    try:
        assert bc.basecall([np.zeros(10, np.float32)] * 4) == ["A" * (t % 5 + 1) for t in range(4)]
    finally:
        bc.close()


def test_remote_basecaller_int16_conversion():
    seen = {}

    def capture(conn):
        rx = b""
        while b"\n" not in rx:
            rx += conn.recv(65536)
        req = json.loads(rx.split(b"\n")[0])
        seen["signal"] = req["signal"]
        conn.sendall((json.dumps({"tag": req["tag"], "seq": "ACGT"}) + "\n").encode())

    bc = RemoteBasecaller(port=_one_shot_server(capture))
    try:
        assert bc.basecall([np.array([80.7, -3.2, 125.9], np.float32)]) == ["ACGT"]
    finally:
        bc.close()
    assert seen["signal"] == [80, -3, 125]  # truncated like the reference


def test_remote_basecaller_unreachable_and_stalled_raise():
    """No server: BasecallerError within the connect timeout.  A server
    that never answers: BasecallerError after the read timeout, and the
    connection is dropped so a retry starts clean."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    with pytest.raises(BasecallerError, match="cannot reach"):
        RemoteBasecaller(port=dead, connect_timeout=0.5).basecall([np.zeros(10, np.float32)])
    done = threading.Event()
    bc = RemoteBasecaller(port=_one_shot_server(lambda conn: done.wait(10)), read_timeout=0.5)
    with pytest.raises(BasecallerError, match="no response"):
        bc.basecall([np.zeros(10, np.float32)])
    done.set()
    assert bc._sock is None and bc._rx == b""


def test_live_pipeline_with_remote_basecaller_matches_jax(tmp_path):
    """The live loop through each package's remote caller, each against
    its own server running the Oracle: every outcome equal, and the
    depletion reads unblocked."""
    genomes, filters = make_world(tmp_path)
    rng = np.random.default_rng(13)
    reads = make_reads(rng, genomes["host"], 2, 3000, "h") + make_reads(rng, genomes["target"], 2, 3000, "t")
    outcomes = {}
    for pkg, client, serve, oracle in (("port", RemoteBasecaller, serve_basecalls, NearestLevelBasecaller),
                                       ("jax", JaxRemote, jax_serve, JaxOracle)):
        port, _, _ = _start_server(oracle().basecall, serve)
        bc = client(port=port)
        (tmp_path / pkg).mkdir()
        try:
            outcomes[pkg], _ = run_live(pkg, filters, reads, tmp_path / pkg, bc, max_ticks=40)
        finally:
            bc.close()
    assert outcomes["port"] == outcomes["jax"]
    assert {rid: v[0] for rid, v in outcomes["port"]["reads"].items()} == {
        "h_0": True, "h_1": True, "t_0": False, "t_1": False}
