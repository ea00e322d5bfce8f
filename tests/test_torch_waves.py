"""The port's chunk-wave oracle (``ClassifyEngine.classify_sequences_waves``
and ``classify_fragments``) and its numpy ``live_decisions`` against the
JAX package's, on tests/test_fused.py's fixture: two 8 kb target genomes
and one depletion genome (k=13, fragments of 2 kb, filters built by the
JAX package), 64 reads of 520 bp with 8 % substitutions, a quarter
random, two of them cut to 251 and 260 bp."""

import numpy as np
import pytest
import torch

from readbouncer_tpu.classify.engine import ClassifyEngine as JaxEngine
from readbouncer_tpu.classify.policy import classify_decisions as jax_classify_decisions
from readbouncer_tpu.classify.policy import live_decisions as jax_live_decisions
from readbouncer_tpu.ibf.build import build_ibf as jax_build_ibf
from readbouncer_tpu.ibf.params import IBFParams as JaxParams
from readbouncer_tpu_torch.classify import fused
from readbouncer_tpu_torch.classify.engine import ClassifyEngine
from readbouncer_tpu_torch.classify.policy import classify_decisions, live_decisions
from readbouncer_tpu_torch.ibf.storage import IBFData

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_fused.py's filters, draw for draw, for both packages."""
    rng = np.random.default_rng(17)
    td = tmp_path_factory.mktemp("waves")
    bases = np.array(list("ACGT"))
    params = JaxParams(kmer_size=13, fragment_length=2000)
    genomes, jax_f, port_f = {}, {}, {}
    for name in ("t0", "t1", "d"):
        g = "".join(bases[rng.integers(0, 4, size=8000)])
        genomes[name] = g
        (td / f"{name}.fasta").write_text(f">{name}\n{g}\n")
        ibf = jax_build_ibf([td / f"{name}.fasta"], params, name=name)[0]
        ibf.save(td / f"{name}.ribf")
        jax_f[name] = ibf
        port_f[name] = IBFData.load(td / f"{name}.ribf", name=name)
    return genomes, jax_f, port_f


def _mixed_reads(genomes, rng, n=64, length=520):
    """tests/test_fused.py's reads, draw for draw."""
    bases = np.array(list("ACGT"))
    seqs = []
    keys = list(genomes)
    for i in range(n):
        if i % 4 == 3:
            seqs.append("".join(bases[rng.integers(0, 4, size=length)]))
        else:
            g = genomes[keys[i % len(keys)]]
            s = rng.integers(0, len(g) - length)
            arr = np.frombuffer(g[s : s + length].encode(), np.uint8).copy()
            mut = rng.random(length) < 0.08
            arr[mut] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=int(mut.sum()))]
            seqs.append(bytes(arr).decode())
    seqs[0] = seqs[0][:251]
    seqs[1] = seqs[1][:260]
    return seqs


MODES = {"both": (("t0", "t1"), ("d",)), "targets_only": (("t0", "t1"), ()), "depletes_only": ((), ("d",))}


@pytest.mark.parametrize("mode", list(MODES))
def test_waves_match_fused_and_jax(world, mode):
    """Decisions, best targets and attempts bit-equal: the port's waves,
    the port's two-phase path and the JAX package's waves."""
    genomes, jax_f, port_f = world
    seqs = _mixed_reads(genomes, np.random.default_rng(5))
    t, d = MODES[mode]
    kw = dict(error_rate=0.1, chunk_length=250, max_chunks=2, batch_size=32)
    engine = ClassifyEngine([port_f[n] for n in t], [port_f[n] for n in d], device="cpu", **kw)
    jax_engine = JaxEngine([jax_f[n] for n in t], [jax_f[n] for n in d], **kw)
    waves = engine.classify_sequences_waves(seqs)
    assert 0 < waves[0].sum() < len(seqs) and set(waves[2].tolist()) == {1, 2}
    for other in (engine.classify_sequences(seqs), jax_engine.classify_sequences_waves(seqs)):
        for got, want in zip(waves, other):
            np.testing.assert_array_equal(got, want)


def test_numpy_policies_match_jax_and_device_port():
    """The numpy live and classify policies against JAX's, and against the
    port's torch policies (classify/fused.py), on random maxima."""
    rng = np.random.default_rng(0)
    args = [rng.integers(0, 3, size=(64, 3)) for _ in range(4)]
    tensors = [torch.from_numpy(a) for a in args]
    want = jax_live_decisions(*args)
    np.testing.assert_array_equal(live_decisions(*args), want)
    np.testing.assert_array_equal(fused.live_decisions(*tensors).numpy(), want)
    for kept in ((0, 2), (1, 3)):  # one kind only
        sel = [a if i in kept else None for i, a in enumerate(args)]
        np.testing.assert_array_equal(live_decisions(*sel), jax_live_decisions(*sel))
    c, b = classify_decisions(*args)
    jc, jb = jax_classify_decisions(*args)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(b, jb)
    with pytest.raises(ValueError, match="no filters"):
        live_decisions(None, None, None, None)
