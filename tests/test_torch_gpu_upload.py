"""Card-only tests of the upload path: unpack4 / unpack5 on the card
against the host packs, the packed and indexed classifiers against the
unpacked classifier on the same reads, the engine's routes (packing,
overlap_pool) on the card against the CPU, and the packed live decide
against the unpacked one.  Each test skips inside its body where there is
no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=. python -m pytest tests/test_torch_gpu_upload.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from readbouncer_tpu_torch.classify import fused
from readbouncer_tpu_torch.classify.engine import ClassifyEngine, encode_batch, pack_codes
from readbouncer_tpu_torch.ibf.build import build_ibf_records
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.query import FilterStack
from readbouncer_tpu_torch.ops import ibf_count as ops

torch.set_num_threads(1)

CL = 250


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _world(dev):
    """Three 6 kb genomes' filters on ``dev`` and on the CPU, and 200
    reads of 1..3 chunks and past them, some random, one with N bases."""
    rng = np.random.default_rng(9)
    genomes = ["".join("ACGT"[i] for i in rng.integers(0, 4, 6000)) for _ in range(3)]
    params = IBFParams(fragment_length=2000)
    built = {d: [build_ibf_records([(f"g{i}", g)], params, name=f"g{i}", device=d)[0] for i, g in enumerate(genomes)]
             for d in (dev, "cpu")}
    seqs = []
    for i in range(200):
        g = genomes[i % 3]
        s = int(rng.integers(0, len(g) - 1000))
        seqs.append(g[s : s + int(rng.integers(250, 1000))] if i % 4 else
                    "".join("ACGT"[j] for j in rng.integers(0, 4, 800)))
    seqs[7] = seqs[7][:120] + "NN" + seqs[7][122:]
    return built[dev], built["cpu"], seqs


@pytest.mark.gpu
def test_unpack_on_the_card_inverts_the_packs():
    dev = _cuda_or_skip()
    rng = np.random.default_rng(1)
    for L in (12, 13, 14, 250, 1000):
        acgt = rng.integers(0, 4, size=(64, L)).astype(np.uint8)
        dna5 = rng.integers(0, 5, size=(64, L)).astype(np.uint8)
        for enc, packing, unpack in ((acgt, "2bit", fused.unpack4), (dna5, "base243", fused.unpack5)):
            packed, _ = pack_codes(enc, packing)
            got = unpack(torch.from_numpy(packed.copy()).to(dev), L)
            assert got.device.type == "cuda" and got.dtype == torch.uint8
            np.testing.assert_array_equal(got.cpu().numpy(), enc)


@pytest.mark.gpu
def test_packed_and_indexed_classifiers_match_the_unpacked_on_the_card():
    dev = _cuda_or_skip()
    filters, _, seqs = _world(dev)
    C, B = 3, 64
    targets, depletes = FilterStack(filters[:2], dev), FilterStack(filters[2:], dev)
    enc, lens = encode_batch(seqs, C * CL)
    acgt = np.where(enc > 3, 0, enc)  # a 2-bit pool holds no N
    dev_lens = torch.from_numpy(lens.copy()).to(dev)
    for n_chunks, packing, codes in ((1, "2bit", acgt), (C, "base243", enc), (2, "2bit", acgt)):
        plain = fused.FusedClassifier(targets, depletes, CL, n_chunks, 0.1, 0.95)
        packed = fused.PackedClassifier(plain, B, packing)
        pool = torch.from_numpy(pack_codes(codes, packing, n_chunks * CL)[0].copy()).to(dev)
        reads = torch.from_numpy(codes[:, : n_chunks * CL].copy()).to(dev)
        before = ops.accumulate_planes.launches
        for s in range(0, len(seqs), B):
            res, pend = packed(pool, dev_lens, s)
            c, b, a = plain(reads[s : s + B], dev_lens[s : s + B])
            assert torch.equal(res, fused.pack_results(c, b, a))
            assert torch.equal(pend, ~c & (dev_lens[s : s + B] > n_chunks * CL))
        assert ops.accumulate_planes.launches > before
    pool = torch.from_numpy(pack_codes(enc[:, CL:], "base243")[0].copy()).to(dev)
    lb = torch.from_numpy(np.maximum(lens - CL, 0).astype(np.int32)).to(dev)
    idx_np = np.flatnonzero(lens > CL).astype(np.int32)[::-1].copy()
    idx = torch.from_numpy(idx_np).to(dev)
    for c_rest in (1, C - 1):
        plain = fused.FusedClassifier(targets, depletes, CL, c_rest, 0.1, 0.95, attempt_offset=1)
        indexed = fused.IndexedClassifier(plain, B)
        for s in range(0, idx_np.size, B):
            rows = idx_np[s : s + B]
            res, pend = indexed(pool, lb, idx, s)
            reads = torch.from_numpy(np.ascontiguousarray(enc[rows, CL : CL * (1 + c_rest)])).to(dev)
            c, b, a = plain(reads, lb[idx[s : s + B].long()])
            assert torch.equal(res, fused.pack_results(c, b, a)) and not pend.any()


@pytest.mark.gpu
def test_engine_routes_on_the_card_match_the_cpu():
    dev = _cuda_or_skip()
    filters, cpu_filters, seqs = _world(dev)
    kw = dict(error_rate=0.1, chunk_length=CL, max_chunks=3, batch_size=64, batch_size_b=32)
    want = ClassifyEngine(cpu_filters[:2], cpu_filters[2:], device="cpu", **kw).classify_sequences(seqs)
    for opts in ({}, {"packing": "base243"}, {"overlap_pool": True}, {"packing": "base243", "overlap_pool": True}):
        engine = ClassifyEngine(filters[:2], filters[2:], device=dev, **opts, **kw)
        job = engine.classify_submit(seqs)
        assert job.packing == "base243"  # the batch holds an N
        assert (job.dev_pool is not None) == bool(opts.get("overlap_pool"))
        for w, g in zip(want, job.finish()):
            np.testing.assert_array_equal(g, w)
        for w, g in zip(want, engine.classify_sequences_pipelined(seqs, host_batch_reads=70, depth=2)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="2bit"):
        ClassifyEngine(filters[:2], filters[2:], device=dev, packing="2bit", **kw).classify_submit(seqs)
    assert 0.0 < ClassifyEngine(filters[:2], [], device=dev, **kw).probe_transfer_seconds() < 60.0


@pytest.mark.gpu
def test_packed_live_decide_on_the_card_matches_the_unpacked():
    dev = _cuda_or_skip()
    filters, _, seqs = _world(dev)
    stacks = (FilterStack(filters[:2], dev), FilterStack(filters[2:], dev))
    for width in (512, 2048):
        enc, lens = encode_batch([s[:width] for s in seqs], width)
        dev_lens = torch.from_numpy(lens.copy()).to(dev)
        plain = fused.LiveFused(*stacks, width, 0.1, 0.95)(torch.from_numpy(enc.copy()).to(dev), dev_lens)
        packed = torch.from_numpy(pack_codes(enc, "base243")[0].copy()).to(dev)
        got = fused.LiveFused(*stacks, width, 0.1, 0.95, packed=True)(packed, dev_lens)
        assert torch.equal(got, plain) and set(got.cpu().tolist()) >= {1, 2}
