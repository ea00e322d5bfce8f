"""The port's device mesh and bins-sharded classification against the
JAX package's, on 8 devices: JAX's 8 virtual CPU devices (conftest.py)
and the port's ``["cpu"] * 8``.

Per-filter maxima of ``ShardedFilterStack`` are bit-equal to the JAX
package's on each 8-device mesh of its tests, with filters of 3, 2 and 3
words so that block boundaries cut filters; ``ShardedLiveClassifier``
decides as JAX's does and as the port's ``LiveClassifier``; both packages
raise the same divisibility errors, the ADVICE r5 one included (a
derived bucket batch that does not divide over the data axis), which the
port mirrors for parity."""

import numpy as np
import pytest
import torch

from readbouncer_tpu.classify.math import ci_and_threshold_batch as jax_thresholds
from readbouncer_tpu.ibf.query import FilterStack as JaxStack
from readbouncer_tpu.ibf.storage import IBFData as JaxIBF
from readbouncer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from readbouncer_tpu.parallel.sharded import ShardedFilterStack as JaxSharded
from readbouncer_tpu.parallel.sharded import ShardedLiveClassifier as JaxShardedLive
from readbouncer_tpu.stream.scheduler import LiveConfig as JaxLiveConfig
from readbouncer_tpu_torch.classify.engine import encode_batch
from readbouncer_tpu_torch.classify.fused import stack_dual_max
from readbouncer_tpu_torch.classify.math import ci_and_threshold_batch
from readbouncer_tpu_torch.ibf.build import build_ibf_records
from readbouncer_tpu_torch.ibf.params import IBFParams
from readbouncer_tpu_torch.ibf.query import FilterStack
from readbouncer_tpu_torch.ibf.storage import IBFData
from readbouncer_tpu_torch.parallel.mesh import BINS_AXIS, DATA_AXIS, make_mesh, parse_mesh_shape
from readbouncer_tpu_torch.parallel.sharded import ShardedFilterStack, ShardedLiveClassifier
from readbouncer_tpu_torch.stream.scheduler import LiveClassifier, LiveConfig

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
MESHES = ["data:8", "data:2,bins:4", "data:4,bins:2", "bins:8"]


def _rand_seq(rng, n):
    return "".join("ACGT"[b] for b in rng.integers(0, 4, int(n)))


@pytest.fixture(scope="module")
def world():
    """Three 4-bin filters built from random 4 kb genomes (k=13, h=3),
    their bits padded with zero words to 3, 2 and 3 words, for both
    packages; and the genomes."""
    rng = np.random.default_rng(5)
    genomes = [_rand_seq(rng, 4000) for _ in range(3)]
    port, jax_ = [], []
    for i, (g, w) in enumerate(zip(genomes, (3, 2, 3))):
        ibf, _ = build_ibf_records([(f"g{i}", g)], IBFParams(kmer_size=13, fragment_length=1000),
                                   name=f"f{i}", device="cpu")
        bits = np.pad(ibf.bits, ((0, 0), (0, w - ibf.words)))
        kw = dict(kmer_size=13, hash_functions=ibf.hash_functions, num_bins=ibf.num_bins, name=f"f{i}")
        port.append(IBFData(bits=bits.copy(), **kw))
        jax_.append(JaxIBF(bits=bits.copy(), **kw))
    return port, jax_, genomes


def _reads(rng, genomes, n, lo, hi):
    """n reads of lengths in [lo, hi): a quarter from each genome and a
    quarter random."""
    out = []
    for i in range(n):
        m = int(rng.integers(lo, hi))
        if i % 4 == 3:
            out.append(_rand_seq(rng, m))
        else:
            g = genomes[i % 4]
            s = int(rng.integers(0, len(g) - m))
            out.append(g[s : s + m])
    return out


def test_parse_mesh_shape_and_make_mesh():
    assert parse_mesh_shape("data:4,bins:2") == {"data": 4, "bins": 2}
    assert parse_mesh_shape("") == {}
    with pytest.raises(ValueError):
        parse_mesh_shape("data")
    mesh = make_mesh(None, CPU8)
    assert mesh.shape == {DATA_AXIS: 8, BINS_AXIS: 1} and mesh.size == 8
    mesh = make_mesh("data:4,bins:2", CPU8)
    assert mesh.shape == {DATA_AXIS: 4, BINS_AXIS: 2}
    assert mesh.device_at(data=3, bins=1) == torch.device("cpu")
    with pytest.raises(ValueError, match=r"needs 15 devices, have 8"):
        make_mesh({DATA_AXIS: 3, BINS_AXIS: 5}, CPU8)
    with pytest.raises(ValueError, match=r"needs 15 devices, have 8"):
        jax_make_mesh({DATA_AXIS: 3, BINS_AXIS: 5})
    if not torch.cuda.is_available():  # the default device list is the cards
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh("bins:1")


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_stack_matches_jax(world, shape):
    """Bit-equal maxima at both thresholds: the port's sharded stack, the
    JAX package's sharded stack and the port's unsharded stack."""
    rng = np.random.default_rng(3)
    port_f, jax_f, genomes = world
    stack = FilterStack(port_f, "cpu")
    sharded = ShardedFilterStack(stack, make_mesh(shape, CPU8))
    if BINS_AXIS in shape:  # some block holds part of a filter only
        assert any(len(cols) and sharded.shards[j][2][0][1] < stack.seg_spec[cols[0]][1]
                   for j, (_, _, _, cols) in enumerate(sharded.shards))
    R, L, k = 16, 150, stack.kmer_size
    reads, lengths = encode_batch(_reads(rng, genomes, R, 60, L + 1), L)
    thr_b = ci_and_threshold_batch(lengths, k, 0.1, 0.95)
    thr_r = ci_and_threshold_batch(lengths, k, 0.08, 0.95)
    mb, mr = sharded.max_counts_dual(reads, lengths, thr_b, thr_r)

    jax_sh = JaxSharded(JaxStack(jax_f), jax_make_mesh(parse_mesh_shape(shape)))
    jb, jr = jax_sh.max_counts_dual(reads, lengths, jax_thresholds(lengths, k, 0.1, 0.95),
                                    jax_thresholds(lengths, k, 0.08, 0.95))
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(mr.numpy(), np.asarray(jr))

    tab_b = torch.from_numpy(ci_and_threshold_batch(np.arange(L + 1), k, 0.1, 0.95).astype(np.int32))
    tab_r = torch.from_numpy(ci_and_threshold_batch(np.arange(L + 1), k, 0.08, 0.95).astype(np.int32))
    ub, ur = stack_dual_max(stack, torch.from_numpy(reads), torch.from_numpy(lengths), tab_b, tab_r)
    np.testing.assert_array_equal(mb.numpy(), ub.numpy())
    np.testing.assert_array_equal(mr.numpy(), ur.numpy())
    assert (mb.numpy().max(axis=0) > 0).all()  # every filter matched some read


def test_divisibility_errors_match_jax(world):
    """Words that do not divide over the bins axis, a batch that does not
    divide over the data axis, and the mirrored ADVICE r5 fault: both
    packages raise ValueError with the same message."""
    port_f, jax_f = [f[:2] for f in world[:2]]
    port_f = [IBFData(bits=f.bits[:, :1].copy(), kmer_size=13, hash_functions=f.hash_functions,
                      num_bins=32, name=f.name) for f in port_f]  # W = 2 over 4 bins shards
    jax_f = [JaxIBF(bits=f.bits.copy(), kmer_size=13, hash_functions=f.hash_functions, num_bins=32,
                    name=f.name) for f in port_f]
    msgs = []
    for make in (
        lambda: ShardedFilterStack(FilterStack(port_f, "cpu"), make_mesh("data:2,bins:4", CPU8)),
        lambda: JaxSharded(JaxStack(jax_f), jax_make_mesh({DATA_AXIS: 2, BINS_AXIS: 4})),
    ):
        with pytest.raises(ValueError, match="divide") as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    sharded = ShardedFilterStack(FilterStack(port_f, "cpu"), make_mesh("data:8", CPU8))
    z = np.zeros(12, np.int32)
    with pytest.raises(ValueError, match=r"batch 12 must divide over 'data' axis \(8\)"):
        sharded.max_counts_dual(np.zeros((12, 40), np.uint8), z, z, z)
    # LiveConfig(batch_size=512, mid_len=768): widths 512 / 768 / 2048,
    # derived batches 512 / 341 / 128, and 341 does not divide over 8
    msgs = []
    for make in (
        lambda: ShardedLiveClassifier(port_f[:1], port_f[1:], LiveConfig(batch_size=512, mid_len=768),
                                      make_mesh("data:8", CPU8)),
        lambda: JaxShardedLive(jax_f[:1], jax_f[1:], JaxLiveConfig(batch_size=512, mid_len=768),
                               jax_make_mesh({DATA_AXIS: 8})),
    ):
        with pytest.raises(ValueError, match=r"bucket batch 341 \(width 768\)") as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_sharded_live_classifier_matches_jax_and_fused(world):
    """Decisions over two buckets (and an empty sequence) on the two live
    meshes of the JAX tests: equal to JAX's ShardedLiveClassifier and to
    the port's unsharded LiveClassifier."""
    rng = np.random.default_rng(9)
    port_f, jax_f, genomes = world
    seqs = _reads(rng, genomes, 40, 30, 900) + [""]
    cfg, jcfg = LiveConfig(batch_size=16, max_seq_len=1024), JaxLiveConfig(batch_size=16, max_seq_len=1024)
    fused = LiveClassifier(port_f[:1], port_f[1:], cfg, device="cpu").decide(seqs)
    assert set(fused.tolist()) == {0, 1, 2}
    for shape in ("data:4,bins:2", "data:8"):
        sharded = ShardedLiveClassifier(port_f[:1], port_f[1:], cfg, make_mesh(shape, CPU8))
        jax_sh = JaxShardedLive(jax_f[:1], jax_f[1:], jcfg, jax_make_mesh(parse_mesh_shape(shape)))
        assert sharded.bucket_lens == jax_sh.bucket_lens
        got = sharded.decide(seqs)
        np.testing.assert_array_equal(got, jax_sh.decide(seqs))
        np.testing.assert_array_equal(got, fused)


def test_sharded_live_classifier_single_kind(world):
    """Targets only, then depletes only (no merged stack), on data:8."""
    rng = np.random.default_rng(10)
    port_f, jax_f, genomes = world
    seqs = _reads(rng, genomes, 9, 200, 201)
    cfg, jcfg = LiveConfig(batch_size=8, max_seq_len=512), JaxLiveConfig(batch_size=8, max_seq_len=512)
    for sel in (slice(0, 1), slice(1, 3)):
        tf, df = (port_f[sel], []) if sel.start == 0 else ([], port_f[sel])
        jtf, jdf = (jax_f[sel], []) if sel.start == 0 else ([], jax_f[sel])
        got = ShardedLiveClassifier(tf, df, cfg, make_mesh("data:8", CPU8)).decide(seqs)
        want = JaxShardedLive(jtf, jdf, jcfg, jax_make_mesh({DATA_AXIS: 8})).decide(seqs)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, LiveClassifier(tf, df, cfg, device="cpu").decide(seqs))
