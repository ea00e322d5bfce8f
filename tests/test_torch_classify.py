"""Port classify path (readbouncer_tpu_torch.classify) against the JAX package.

``classify_read_files`` of the port runs on the CPU (its kernels' plain
versions) on the fixtures of tests/test_fused.py and must give the JAX
function's output FASTAs and counters exactly; the upload options
(packing, overlap_pool) decide as the JAX engine's do, a pinned 2-bit
packing refuses N bases in both; bad options are refused.
"""

import numpy as np
import pytest
import torch

from readbouncer_tpu.classify.engine import ClassifyEngine as JaxEngine
from readbouncer_tpu.classify.engine import classify_read_files as jax_classify_read_files
from readbouncer_tpu_torch.classify.engine import ClassifyEngine, classify_read_files
from readbouncer_tpu_torch.errors import EmptyFilterError
from test_torch_engine import _assert_same, _mixed_reads, filters  # noqa: F401

torch.set_num_threads(1)


def test_engine_validation(filters, tmp_path):
    _, _, (tt, td) = filters
    kw = dict(error_rate=0.1, chunk_length=250, max_chunks=3, batch_size=8, device="cpu")
    with pytest.raises(ValueError, match="packing"):
        ClassifyEngine(tt, td, **{**kw, "packing": "3bit"})
    with pytest.raises(ValueError, match="max_chunks"):
        ClassifyEngine(tt, td, **{**kw, "max_chunks": 300})
    with pytest.raises(ValueError, match="transfer_mode"):
        classify_read_files([], tt, td, output_dir=tmp_path, transfer_mode="fast", **kw)
    with pytest.raises(EmptyFilterError):
        ClassifyEngine([], [], **kw)


def test_upload_options_change_no_decision(filters):
    """``packing`` and ``overlap_pool`` select the upload path (packed
    pools unpacked on the device, the indexed phase-B pool).  On reads
    with N bases, ``packing="2bit"`` raises in both packages, and every
    other (packing, overlap_pool) pair decides as the JAX engine with the
    same options does."""
    genomes, (jt, jd), (tt, td) = filters
    seqs = _mixed_reads(genomes, np.random.default_rng(77), n=24, length=600)
    for i in (2, 5, 9):
        s = seqs[i]
        seqs[i] = s[:100] + "N" + s[101:300] + "NNNN" + s[304:]
    kw = dict(error_rate=0.1, chunk_length=250, max_chunks=3, batch_size=8)
    for overlap_pool in (False, True):
        with pytest.raises(ValueError, match="2bit"):
            JaxEngine(jt, jd, packing="2bit", overlap_pool=overlap_pool, **kw).classify_sequences(seqs)
        with pytest.raises(ValueError, match="2bit"):
            ClassifyEngine(tt, td, packing="2bit", overlap_pool=overlap_pool, device="cpu", **kw).classify_sequences(seqs)
        for packing in ("auto", "base243"):
            want = JaxEngine(jt, jd, packing=packing, overlap_pool=overlap_pool, **kw).classify_sequences(seqs)
            assert want[0].any() and not want[0].all()
            e = ClassifyEngine(tt, td, packing=packing, overlap_pool=overlap_pool, device="cpu", **kw)
            _assert_same(want, e.classify_sequences(seqs))


def _read_set(genomes, rng):
    """Reads for classify_read_files: on/off target, too short, N-containing, long."""
    seqs = _mixed_reads(genomes, rng, n=40, length=600)
    seqs[4] = seqs[4][:100]  # too short
    seqs[6] = seqs[6][:200] + "N" + seqs[6][201:]
    seqs[8] = genomes["t1"][100:1500]  # longer than the chunk budget
    return [(f"read_{i} extra", s) for i, s in enumerate(seqs)]


@pytest.mark.parametrize(
    "transfer_mode,depth,host_batch",
    [("serial", 2, 16), ("overlap", 1, 64), ("serial", 3, 7), ("auto", 2, 64)],
)
def test_classify_read_files_matches_jax(filters, tmp_path, transfer_mode, depth, host_batch):
    genomes, (jt, jd), (tt, td) = filters
    records = _read_set(genomes, np.random.default_rng(13))
    reads = tmp_path / "reads.fasta"
    reads.write_text("".join(f">{i}\n{s}\n" for i, s in records))
    kw = dict(error_rate=0.1, chunk_length=250, max_chunks=3, batch_size=16, verbose=False,
              host_batch_reads=host_batch, pipeline_depth=depth, transfer_mode=transfer_mode)
    want = jax_classify_read_files([reads], jt, jd, output_dir=tmp_path / "jax", **kw)
    got = classify_read_files([reads], tt, td, output_dir=tmp_path / "port", device="cpu", **kw)
    for key in ("found", "failed", "too_short", "read_counter", "per_target"):
        assert getattr(got, key) == getattr(want, key), key
    assert want.found > 0 and want.too_short == 1
    for name in ("t0", "t1", "unclassified"):
        assert (tmp_path / "port" / f"{name}.fasta").read_text() == (
            tmp_path / "jax" / f"{name}.fasta"
        ).read_text()
    assert got.report(250).splitlines()[:4] == want.report(250).splitlines()[:4]
