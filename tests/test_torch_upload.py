"""The port's upload path against the JAX package's.

Packed read pools (``pack4_np`` 2-bit, ``pack5_np`` base 243) made by the
native ``pack_codes`` and unpacked on the device, the packed and indexed
classifiers, ``job.packing`` per host batch, the overlapped phase-B pool
(``overlap_pool``), ``choose_transfer_mode`` and its probe, the congested
``transfer_mode="auto"`` driver and the packed live decide.  The same
numpy-seeded inputs go through both packages on the CPU (the port's
kernels' plain versions); packed bytes and decisions must be equal.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from readbouncer_tpu.classify import engine as jax_engine_mod
from readbouncer_tpu.classify import fused as jax_fused
from readbouncer_tpu.classify.engine import ClassifyEngine as JaxEngine
from readbouncer_tpu.ibf.query import FilterStack as JaxStack
from readbouncer_tpu.stream import scheduler as jax_scheduler
from readbouncer_tpu_torch.classify import engine as engine_mod
from readbouncer_tpu_torch.classify import fused
from readbouncer_tpu_torch.classify.engine import ClassifyEngine, choose_transfer_mode, pack_codes
from readbouncer_tpu_torch.ibf.query import FilterStack
from readbouncer_tpu_torch.native import CALLS
from readbouncer_tpu_torch.stream import scheduler
from test_torch_engine import _assert_same, _mixed_reads, filters  # noqa: F401
from torch_live_world import make_world

torch.set_num_threads(1)

CL = 250


def _codes(rng, R, L, n_share):
    """Random base codes; a share ``n_share`` of them N (code 4)."""
    enc = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    enc[rng.random((R, L)) < n_share] = 4
    return enc


def _read_only(a):
    """``a`` as the native encode returns it: a read-only view of bytes."""
    return np.frombuffer(a.tobytes(), dtype=np.uint8).reshape(a.shape)


def _varied_reads(genomes, rng, n, C):
    """Reads of 1..C chunks and past C*CL, on-target, deplete and random."""
    seqs = _mixed_reads(genomes, rng, n=n, length=C * CL + 300)
    cuts = [CL, CL + 13, CL + 200, 2 * CL, 2 * CL + 1, 3 * CL - 5, C * CL, C * CL + 300]
    return [s[: cuts[i % len(cuts)]] for i, s in enumerate(seqs)]


class _Lines(logging.Handler):
    """The messages logged on one named logger, at INFO and up."""

    def __init__(self, name):
        super().__init__()
        self.lines, self.logger = [], logging.getLogger(name)

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def test_pack_codes_and_copies_bit_equal_to_jax():
    """The native pack_codes and the numpy copies give JAX's pack4_np /
    pack5_np bytes at L % 3 and L % 4 in {0, 1, 2}, on read-only input,
    on the first ``width`` columns and on a column slice; the N flag
    covers the whole buffer."""
    rng = np.random.default_rng(3)
    for L in (12, 13, 14, 250, 1000, 1249):
        assert {L % 3, L % 4} <= {0, 1, 2}
        for n_share in (0.0, 0.01):
            enc = _codes(rng, 9, L, n_share)
            ro = _read_only(enc)
            has_n = bool((enc > 3).any())
            for packing, jax_pack, port_pack in (
                ("2bit", jax_fused.pack4_np, fused.pack4_np),
                ("base243", jax_fused.pack5_np, fused.pack5_np),
            ):
                for width in (L, L // 2 + 1):
                    want = jax_pack(enc[:, :width])
                    got, flag = pack_codes(ro, packing, width)
                    np.testing.assert_array_equal(got, want)
                    np.testing.assert_array_equal(port_pack(enc[:, :width]), want)
                    assert flag == has_n
                    assert got.shape[1] == fused.packed_bytes_per_read(width, packing)
                    assert fused.packed_bytes_per_read(width, packing) == jax_fused.packed_bytes_per_read(width, packing)
                got, flag = pack_codes(ro[:, 5:], packing)
                np.testing.assert_array_equal(got, jax_pack(enc[:, 5:]))
                assert flag == bool((enc[:, 5:] > 3).any())
    before = CALLS["pack_codes"]
    assert pack_codes(np.zeros((0, 7), np.uint8), "base243")[0].shape == (0, 3)
    assert CALLS["pack_codes"] == before + 1
    for bad, match in (((np.zeros((2, 8), np.int32), "2bit"), "uint8"),
                       ((np.zeros((2, 8), np.uint8), "3bit"), "packing"),
                       ((np.zeros((2, 8), np.uint8)[:, ::2], "2bit"), "adjacent")):
        with pytest.raises(ValueError, match=match):
            pack_codes(*bad)


def test_unpack_matches_jax():
    """unpack4 / unpack5 on tensors give unpack4_jnp / unpack5_jnp's codes,
    padding cut, and invert the packs."""
    rng = np.random.default_rng(4)
    for L in (12, 13, 14, 250, 1000, 1249):
        acgt, dna5 = _codes(rng, 7, L, 0.0), _codes(rng, 7, L, 0.05)
        for enc, pack, unpack, unpack_jnp in (
            (acgt, fused.pack4_np, fused.unpack4, jax_fused.unpack4_jnp),
            (dna5, fused.pack5_np, fused.unpack5, jax_fused.unpack5_jnp),
        ):
            packed = pack(enc)
            got = unpack(torch.from_numpy(packed), L)
            assert got.dtype == torch.uint8 and got.shape == (7, L)
            np.testing.assert_array_equal(got.numpy(), np.asarray(unpack_jnp(jnp.asarray(packed), L)))
            np.testing.assert_array_equal(got.numpy(), enc)
        every = np.arange(256, dtype=np.uint8)[None, :]  # any byte, as JAX reads it
        for unpack, unpack_jnp in ((fused.unpack4, jax_fused.unpack4_jnp), (fused.unpack5, jax_fused.unpack5_jnp)):
            np.testing.assert_array_equal(unpack(torch.from_numpy(every), 700).numpy(),
                                          np.asarray(unpack_jnp(jnp.asarray(every), 700)))


def test_packed_and_indexed_classifiers_match_jax(filters):
    """PackedClassifier and IndexedClassifier against the JAX programs
    (make_fused_classify_packed_fn / make_fused_classify_indexed_fn) on
    one pool: result words and pending flags per batch."""
    genomes, (jt, jd), (tt, td) = filters
    C, B, n = 3, 16, 40
    seqs = _varied_reads(genomes, np.random.default_rng(8), n, C)
    seqs[3] = seqs[3][:60] + "N" + seqs[3][61:]
    enc, lens = engine_mod.encode_batch(seqs, C * CL)
    jst, jsd = JaxStack(jt), JaxStack(jd)
    pst, psd = FilterStack(tt, "cpu"), FilterStack(td, "cpu")
    n_pad = -(-n // B) * B
    lens_pad = np.concatenate([lens, np.zeros(n_pad - n, np.int32)])
    for c_chunks, packing in ((1, "2bit"), (C, "base243"), (2, "2bit")):
        enc_c = np.where(enc > 3, 0, enc) if packing == "2bit" else enc  # 2-bit pools hold no N
        pool, _ = pack_codes(enc_c, packing, c_chunks * CL)
        want_fn = jax_fused.make_fused_classify_packed_fn(jst, jsd, CL, c_chunks, 0.1, 0.95, B, packing=packing)
        got_fn = fused.PackedClassifier(fused.FusedClassifier(pst, psd, CL, c_chunks, 0.1, 0.95), B, packing)
        flat = np.concatenate([pool, np.zeros((n_pad - n, pool.shape[1]), np.uint8)]).reshape(-1)
        for s in range(0, n, B):
            want_res, want_pend = want_fn(jnp.asarray(flat), jnp.asarray(lens_pad), s)
            got_res, got_pend = got_fn(torch.from_numpy(pool.copy()), torch.from_numpy(lens.copy()), s)
            m = got_res.shape[0]
            np.testing.assert_array_equal(got_res.numpy(), np.asarray(want_res)[:m])
            np.testing.assert_array_equal(got_pend.numpy(), np.asarray(want_pend)[:m])
    # the indexed phase-B pool: chunks 1..C-1 of every read, base 243
    pool, _ = pack_codes(enc[:, CL:], "base243")
    words = -(-pool.shape[1] // 4)
    pool_u32 = np.pad(pool, ((0, 0), (0, 4 * words - pool.shape[1]))).reshape(-1).view("<u4")
    lb_all = np.maximum(lens - CL, 0).astype(np.int32)
    idx = np.flatnonzero(lens > CL).astype(np.int32)[::-1].copy()
    idx_pad = np.concatenate([idx, np.zeros(-(-idx.size // B) * B - idx.size, np.int32)])
    for c_rest in (1, C - 1):
        want_fn = jax_fused.make_fused_classify_indexed_fn(jst, jsd, CL, c_rest, 0.1, 0.95, B, words, attempt_offset=1)
        got_fn = fused.IndexedClassifier(fused.FusedClassifier(pst, psd, CL, c_rest, 0.1, 0.95, attempt_offset=1), B)
        for s in range(0, idx.size, B):
            want_res, want_pend = want_fn(jnp.asarray(pool_u32), jnp.asarray(lb_all), jnp.asarray(idx_pad), s)
            got_res, got_pend = got_fn(torch.from_numpy(pool.copy()), torch.from_numpy(lb_all), torch.from_numpy(idx), s)
            m = got_res.shape[0]
            np.testing.assert_array_equal(got_res.numpy(), np.asarray(want_res)[:m])
            assert not got_pend.any() and not np.asarray(want_pend).any()


def test_job_packing_per_host_batch(filters):
    """``packing="auto"`` resolves per host batch (2-bit without N,
    base 243 with one anywhere in the batch, even past chunk 0), a pinned
    packing stays, and ``"2bit"`` pinned on a batch with N raises the JAX
    package's ValueError, in both packages."""
    genomes, (jt, jd), (tt, td) = filters
    seqs = _varied_reads(genomes, np.random.default_rng(6), 16, 3)
    late_n = list(seqs)
    late_n[5] = late_n[5][:600] + "N" + late_n[5][601:]  # an N in chunk 2 only
    kw = dict(error_rate=0.1, chunk_length=CL, max_chunks=3, batch_size=8)
    for packing, batch, want in (("auto", seqs, "2bit"), ("auto", late_n, "base243"),
                                 ("base243", seqs, "base243"), ("2bit", seqs, "2bit")):
        jax_job = JaxEngine(jt, jd, packing=packing, **kw).classify_submit(batch)
        job = ClassifyEngine(tt, td, packing=packing, device="cpu", **kw).classify_submit(batch)
        assert job.packing == jax_job.packing == want
        _assert_same(jax_job.finish(), job.finish())
    for make in (lambda: JaxEngine(jt, jd, packing="2bit", **kw),
                 lambda: ClassifyEngine(tt, td, packing="2bit", device="cpu", **kw)):
        with pytest.raises(ValueError, match="packing='2bit' pinned but this batch contains N bases"):
            make().classify_submit(late_n)


def test_overlap_pool_matches_serial_waves_and_jax(filters):
    """``overlap_pool=True`` (the base-243 phase-B pool uploaded at submit,
    rows gathered by index) decides as the serial route, the chunk-wave
    oracle and the JAX engine with ``overlap_pool=True``, on reads of 1..C
    chunks; the indexed route is taken, and skipped when no read has a
    second chunk."""
    genomes, (jt, jd), (tt, td) = filters
    C = 4
    seqs = _varied_reads(genomes, np.random.default_rng(12), 56, C)
    kw = dict(error_rate=0.1, chunk_length=CL, max_chunks=C, batch_size=8, batch_size_b=8)
    want = JaxEngine(jt, jd, overlap_pool=True, **kw).classify_sequences(seqs)
    assert want[0].any() and not want[0].all() and len(set(want[2].tolist())) >= 3
    overlap = ClassifyEngine(tt, td, overlap_pool=True, device="cpu", **kw)
    serial = ClassifyEngine(tt, td, device="cpu", **kw)
    job = overlap.classify_submit(seqs)
    assert job.dev_pool is not None and job.dev_pool.shape == (len(seqs), -(-(C - 1) * CL // 3))
    _assert_same(want, job.finish())
    assert any(k[0] == "indexed" for k in overlap._fused)
    _assert_same(want, overlap.classify_sequences_pipelined(seqs, host_batch_reads=24, depth=2))
    _assert_same(want, serial.classify_sequences(seqs))
    _assert_same(want, serial.classify_sequences_waves(seqs))
    assert not any(k[0] == "indexed" for k in serial._fused)
    short = [s[:CL] for s in seqs[:10]]
    job = overlap.classify_submit(short)
    assert job.dev_pool is None
    _assert_same(JaxEngine(jt, jd, overlap_pool=True, **kw).classify_sequences(short), job.finish())


def test_choose_transfer_mode_and_probe(filters):
    """choose_transfer_mode as the JAX package's: a probe at or over
    0.08 s means overlap, under it serial, each logged; fixed modes pass
    through, a bad one raises; the real probe times a host copy on the
    CPU."""
    _, (jt, _), (tt, _) = filters
    engine = ClassifyEngine(tt, [], 0.1, batch_size=8, device="cpu")
    jax_e = JaxEngine(jt, [], 0.1, batch_size=8)
    for choose, e in ((choose_transfer_mode, engine), (jax_engine_mod.choose_transfer_mode, jax_e)):
        with _Lines("test-transfer") as got:
            log = got.logger
            assert choose("auto", e, probe_fn=lambda nb: 0.4, logger=log) is True
            assert choose("auto", e, probe_fn=lambda nb: 0.08, logger=log) is True
            assert choose("AUTO", e, probe_fn=lambda nb: 0.02, logger=log) is False
            assert choose("overlap", e) is True and choose("serial", e) is False and choose(None, e) is False
            with pytest.raises(ValueError, match="transfer_mode"):
                choose("bogus", e)
        assert got.lines == [
            "transfer_mode=auto: 512 KB H2D probe took 400.0 ms -> overlap",
            "transfer_mode=auto: 512 KB H2D probe took 80.0 ms -> overlap",
            "transfer_mode=auto: 512 KB H2D probe took 20.0 ms -> serial",
        ]
    seen = []
    assert choose_transfer_mode("auto", engine, probe_bytes=1 << 12, probe_fn=lambda nb: seen.append(nb) or 0.0) is False
    assert seen == [1 << 12]
    assert 0.0 <= engine.probe_transfer_seconds(1 << 14) < 60.0
    assert engine._io.h2d_bytes == 0  # the probe is not the engine's traffic


def test_auto_transfer_mode_congested_driver(filters, tmp_path, monkeypatch):
    """transfer_mode="auto" with a congested probe (monkeypatched in both
    packages): the overlap route, host batches of at least 65,536 reads
    at depth 1, the same log lines as the JAX driver, and the same FASTAs
    and counters as the serial driver and the JAX driver."""
    genomes, (jt, jd), (tt, td) = filters
    seqs = _varied_reads(genomes, np.random.default_rng(21), 40, 3)
    seqs[7] = seqs[7][:90]  # too short
    reads = tmp_path / "reads.fasta"
    reads.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    kw = dict(error_rate=0.1, chunk_length=CL, max_chunks=3, batch_size=8, verbose=False, host_batch_reads=16)
    for cls in (engine_mod.ClassifyEngine, jax_engine_mod.ClassifyEngine):
        monkeypatch.setattr(cls, "probe_transfer_seconds", lambda self, nbytes=1 << 19: 0.4)
    batches = []
    submit = engine_mod.ClassifyEngine.classify_submit
    monkeypatch.setattr(engine_mod.ClassifyEngine, "classify_submit",
                        lambda self, s: batches.append((len(s), self.overlap_pool)) or submit(self, s))
    out = {}
    for name, fn, filt, mode in (
        ("port", engine_mod.classify_read_files, dict(target_filters=tt, deplete_filters=td, device="cpu"), "auto"),
        ("jax", jax_engine_mod.classify_read_files, dict(target_filters=jt, deplete_filters=jd), "auto"),
        ("serial", engine_mod.classify_read_files, dict(target_filters=tt, deplete_filters=td, device="cpu"), "serial"),
    ):
        with _Lines("ClassifyLog") as got:
            res = fn([reads], output_dir=tmp_path / name, transfer_mode=mode, **filt, **kw)
        out[name] = (res, [m for m in got.lines if not m.startswith("intermediate")])
    assert batches[0] == (39, True)  # one host batch of every read, overlap on
    assert out["port"][1] == out["jax"][1] == [
        "transfer_mode=auto: 512 KB H2D probe took 400.0 ms -> overlap",
        "transfer probe 400 ms: congested -> host_batch_reads=65536 depth=1",
    ]
    assert out["serial"][1] == [] and all(not ov for _, ov in batches[1:])
    assert out["port"][0].found > 0 and out["port"][0].too_short == 1
    for name in ("jax", "serial"):
        for key in ("found", "failed", "too_short", "read_counter", "per_target"):
            assert getattr(out["port"][0], key) == getattr(out[name][0], key), (name, key)
        for fasta in ("t0", "t1", "unclassified"):
            assert (tmp_path / "port" / f"{fasta}.fasta").read_text() == (tmp_path / name / f"{fasta}.fasta").read_text()


def test_packed_live_decides_as_jax(tmp_path):
    """LiveClassifier.decide ships base-243 reads through pack_codes (one
    call per batch) and decides as the JAX package's LiveClassifier;
    LiveFused(packed=True) on packed reads equals LiveFused on the
    unpacked ones, N bases included."""
    genomes, filters = make_world(tmp_path)
    rng = np.random.default_rng(31)
    seqs = []
    for n in rng.integers(0, 2600, size=60):
        g = genomes[("host", "target")[int(rng.integers(0, 2))]]
        s = int(rng.integers(0, len(g) - 2600))
        seqs.append(g[s : s + int(n)])
    seqs[4] = seqs[4][:100] + "NN" + seqs[4][102:]
    cfg = dict(batch_size=8, mid_len=1024)
    port = scheduler.LiveClassifier([filters["port"]["target"]], [filters["port"]["host"]],
                                    scheduler.LiveConfig(**cfg), device="cpu")
    ref = jax_scheduler.LiveClassifier([filters["jax"]["target"]], [filters["jax"]["host"]],
                                       jax_scheduler.LiveConfig(**cfg))
    assert all(f.packed for f in port._fused.values())
    before = CALLS["pack_codes"]
    got = port.decide(seqs)
    lens = np.array([len(s) for s in seqs])
    bounds = [-1] + port.bucket_lens[:-1] + [np.inf]
    batches = sum(-(-int(((lens > lo) & (lens <= hi)).sum()) // port._batch[w])
                  for lo, hi, w in zip(bounds, bounds[1:], port.bucket_lens))
    assert CALLS["pack_codes"] - before == batches
    np.testing.assert_array_equal(got, ref.decide(seqs))
    assert set(got.tolist()) == {0, 1, 2}
    width = port.short_len
    short = [s[:width] for s in seqs[:16]]
    enc, lens = engine_mod.encode_batch(short, width)
    stacks = (FilterStack([filters["port"]["target"]], "cpu"), FilterStack([filters["port"]["host"]], "cpu"))
    plain = fused.LiveFused(*stacks, width, 0.1, 0.95)
    packed = fused.LiveFused(*stacks, width, 0.1, 0.95, packed=True)
    lens_t = torch.from_numpy(lens.copy())
    np.testing.assert_array_equal(
        packed(torch.from_numpy(pack_codes(enc, "base243")[0].copy()), lens_t).numpy(),
        plain(torch.from_numpy(enc.copy()), lens_t).numpy(),
    )
