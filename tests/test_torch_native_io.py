"""The port's native host library (``readbouncer_tpu_torch/native``): its
encode and its FASTA/FASTQ reader against the JAX package's Python paths.

The JAX package's own extension (``readbouncer_tpu._native``) is a build
product a checkout may lack, so these tests never import it: where the
JAX package would use it, ``_rbt_native`` is set to None for the test and
the JAX package's Python fallback is the reference.  The reader's rules
that only the native reader has (ids cut at a tab, gzip by content,
FASTQ by first byte) are written out from ``rbt_native.cpp``.  The
loader reuses its library and raises, with nothing falling back, when
the compiler is missing.
"""

import gzip
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from readbouncer_tpu.classify import engine as jax_engine
from readbouncer_tpu.fastio import fasta as jax_fasta
from readbouncer_tpu.ibf.hashing import encode_bases as jax_encode_bases
from readbouncer_tpu_torch.classify.engine import encode_batch, encode_batch_np
from readbouncer_tpu_torch.fastio.fasta import read_records, read_records_py
from readbouncer_tpu_torch.native import CALLS, load_native

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _jax_python_paths(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jax_fasta, "_rbt_native", None)
    monkeypatch.setattr(jax_engine, "_rbt_native", None)


def _jax_records(path, first_word_id=False):
    return [(r.id, r.seq) for r in jax_fasta.read_records(path, first_word_id=first_word_id)]


def _port_records(path, first_word_id=False, reader=read_records):
    return [(r.id, r.seq) for r in reader(path, first_word_id=first_word_id)]


def test_encode_and_encode_batch_match_jax_and_plain():
    lib = load_native().module
    rng = np.random.default_rng(3)
    letters = list("ACGTacgtNnRYKMSWBDHVryk-.X0")
    seqs = ["", "ACGTNacgtnXYZ-0", "N" * 12, "acgtACGTxx"]
    seqs += ["".join(rng.choice(letters, size=int(n))) for n in rng.integers(0, 40, 12)]
    for s in seqs:
        want = jax_encode_bases(s)
        for arg in (s, s.encode("ascii")):
            np.testing.assert_array_equal(np.frombuffer(lib.encode(arg), dtype=np.uint8), want)
    calls = CALLS["encode_batch"]
    for length, batch in ((16, None), (16, len(seqs) + 5), (1, None), (64, len(seqs))):
        want = jax_engine.encode_batch(seqs, length, batch=batch)
        plain = encode_batch_np(seqs, length, batch=batch)
        for arg in (seqs, [s.encode("ascii") for s in seqs]):
            got = encode_batch(arg, length, batch=batch)
            for g, w, p in zip(got, want, plain):
                assert g.dtype == w.dtype == p.dtype and g.shape == w.shape == p.shape
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, p)
        if batch is not None and batch > len(seqs):
            assert not got[0][len(seqs):].any() and not got[1][len(seqs):].any()
    assert CALLS["encode_batch"] == calls + 8
    empty = encode_batch([], 8, batch=3)
    assert empty[0].shape == (3, 8) and not empty[0].any() and not empty[1].any()
    with pytest.raises(TypeError):
        encode_batch(("ACGT",), 4)  # the library takes a list, as the JAX package's does


def test_records_match_the_jax_python_parser(tmp_path):
    cases = {
        "multi.fasta": ">id1 some description\nACGT\nTTGG\n\n>id2\nNNNA\n>id3 x\nC\n",
        "crlf.fasta": ">a b\r\nAC\r\nGT\r\n\r\n>c\r\nGG\r\n",
        "noeol.fa": ">a\nACGT\n>b desc\nTT",
        "blank_lead.fasta": "\n\n>a\nAC\n\nGT\n",
        "reads.fastq": "@r1 d\nACGT\n+\nIIII\n\n@r2\nTT\n+r2\nII\n",
        "crlf.fq": "@r1 x y\r\nACGT\r\n+\r\nIIII\r\n@r2\r\nGG\r\n+\r\nII\r\n",
        "sniffed.txt": "@q1 z\nAC\n+\nII\n",
    }
    for name, text in cases.items():
        p = tmp_path / name
        p.write_text(text)
        for fw in (False, True):
            want = _jax_records(p, fw)
            assert want, name
            assert _port_records(p, fw) == want, (name, fw)
            assert _port_records(p, fw, reader=read_records_py) == want, (name, fw)
    gz = tmp_path / "multi.fasta.gz"
    with gzip.open(gz, "wt") as f:
        f.write(cases["multi.fasta"])
    assert _port_records(gz, True) == _jax_records(gz, True) == [("id1", "ACGTTTGG"), ("id2", "NNNA"),
                                                                 ("id3", "C")]


def test_native_only_rules(tmp_path):
    """rbt_native.cpp:191-195 (ids cut at a space or a tab), :311 (gzip by
    content: zlib reads any file), :327 (FASTQ when the first byte is '@')."""
    tab = tmp_path / "tab.fasta"
    tab.write_text(">id1\tdesc\nACGT\n>id2 x\ty\nGG\n")
    assert _port_records(tab, True) == [("id1", "ACGT"), ("id2", "GG")]
    assert _port_records(tab, False) == [("id1\tdesc", "ACGT"), ("id2 x\ty", "GG")]
    assert _port_records(tab, True, reader=read_records_py) == [("id1\tdesc", "ACGT"), ("id2", "GG")]

    hidden = tmp_path / "reads.fasta"  # gzip content, no .gz suffix
    hidden.write_bytes(gzip.compress(b">a desc\nACGT\nGG\n>b\nTTTT\n"))
    assert _port_records(hidden, True) == [("a", "ACGTGG"), ("b", "TTTT")]

    fq = tmp_path / "named.fasta"  # FASTQ content under a FASTA name
    fq.write_text("@r1 d\nACGT\n+\nIIII\n@r2\nTT\n+\nII\n")
    assert _port_records(fq, True) == [("r1", "ACGT"), ("r2", "TT")]
    fa = tmp_path / "named.fastq"  # FASTA content under a FASTQ name
    fa.write_text(">a\nAC\nGT\n")
    assert _port_records(fa) == [("a", "ACGT")]
    with pytest.raises(ValueError):
        list(read_records_py(fa))  # the Python parser goes by the suffix


def test_long_lines_streaming_and_malformed_fastq(tmp_path):
    """Lines over several of the reader's chunks (its line search resumes
    where the last one ended), a record streamed before a malformed one,
    malformed FASTQ and a missing file."""
    seq = "ACGT" * 300_000  # 1.2 MB on one line, over five of the reader's 256 KB chunks
    hdr = "id_" + "x" * 300_000 + " tail"
    for eol in ("\n", "\r\n"):
        p = tmp_path / "long.fasta"
        p.write_bytes(f">{hdr}{eol}{seq}{eol}>b{eol}TT{eol}".encode())
        assert _port_records(p) == _jax_records(p) == [(hdr, seq), ("b", "TT")]
    q = tmp_path / "long.fastq"
    q.write_text(f"@{hdr}\n{seq}\n+\n{'I' * len(seq)}\n")
    assert _port_records(q, True) == _jax_records(q, True) == [("id_" + "x" * 300_000, seq)]

    s = tmp_path / "s.fastq"  # streamed: the first record comes before the fault is read
    s.write_text("@r1\nACGT\n+\nIIII\n@r2\nACGT\nIIII\n")
    it = read_records(s)
    assert iter(it) is it
    assert next(it).seq == "ACGT"
    with pytest.raises(ValueError, match=r"missing '\+' line"):
        next(it)
    for text in ("@r1\nACGT\n", "@r1\nAC\n+\nII\nxx\n"):  # cut mid-record; a header without '@'
        bad = tmp_path / "bad.fastq"
        bad.write_text(text)
        with pytest.raises(ValueError):
            list(read_records(bad))
        with pytest.raises(ValueError):
            list(jax_fasta.read_records(bad))
    with pytest.raises(OSError):
        list(read_records(tmp_path / "missing.fasta"))


def test_fuzz_equivalence(tmp_path):
    """Seeded FASTA/FASTQ corpora (multi-line bodies, CRLF, descriptions,
    a trailing newline or none): the native reader equals the JAX Python
    parser; a seeded batch of reads encodes bit-equal both ways."""
    rng = np.random.default_rng(12345)
    bases = np.array(list("ACGTNacgtn"))

    def rand_seq(n):
        return "".join(bases[rng.integers(0, 10, size=n)])

    for trial in range(10):
        fastq = trial % 2 == 1
        lines = []
        for r in range(int(rng.integers(1, 12))):
            rid = f"read{trial}_{r}" + (" desc words" if rng.random() < 0.5 else "")
            n = int(rng.integers(1, 120_000) if rng.random() < 0.2 else rng.integers(1, 400))
            seq = rand_seq(n)
            if fastq:
                lines += [f"@{rid}", seq, "+", "I" * n]
            else:
                lines.append(f">{rid}")
                wrap = int(rng.integers(1, max(n, 2)))
                lines += [seq[i : i + wrap] for i in range(0, n, wrap)]
        eol = "\r\n" if rng.random() < 0.3 else "\n"
        text = eol.join(lines) + (eol if rng.random() < 0.5 else "")
        p = tmp_path / f"fuzz{trial}.{'fastq' if fastq else 'fasta'}"
        p.write_bytes(text.encode())
        for fw in (False, True):
            assert _port_records(p, fw) == _jax_records(p, fw), (trial, fw)
    reads = [rand_seq(int(n)) for n in rng.integers(0, 1500, 300)]
    got = encode_batch(reads, 1250, batch=320)
    for g, w, p in zip(got, jax_engine.encode_batch(reads, 1250, batch=320), encode_batch_np(reads, 1250, batch=320)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


def _fresh_build(code: str, tmp_path, **env):
    """Run ``code`` in a new interpreter whose loader builds into an empty
    directory under ``tmp_path``."""
    prelude = textwrap.dedent(
        f"""
        from pathlib import Path
        import readbouncer_tpu_torch.native as native
        native.BUILD_DIR = Path({str(tmp_path / 'host_build')!r})
        """
    )
    full_env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **env)
    return subprocess.run([sys.executable, "-c", prelude + textwrap.dedent(code)], cwd=tmp_path,
                          env=full_env, capture_output=True, text=True, timeout=300)


def test_loader_builds_once_then_reuses(tmp_path):
    proc = _fresh_build(
        """
        first = native.load_native()
        native.load_native.cache_clear()
        second = native.load_native()
        assert first.built and first.seconds > 0 and first.compiler, first
        assert not second.built and second.seconds == 0 and second.path == first.path
        assert first.path.parent.parent == native.BUILD_DIR
        assert first.module.__name__ == "readbouncer_tpu_torch.native._rbt_host"
        import sys
        assert sys.modules["readbouncer_tpu_torch.native._rbt_host"] is second.module
        assert "readbouncer_tpu._native" not in sys.modules
        print("REUSED", sorted(p.name for p in first.path.parent.iterdir()))
        """,
        tmp_path,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REUSED ['_rbt_host" in proc.stdout and ".tmp" not in proc.stdout


def test_missing_compiler_raises_and_nothing_falls_back(tmp_path):
    """With ``$CXX`` naming a missing compiler and nothing built, every
    caller of the library raises the loader's error: the encode, the
    reader, the CPU build's insert and the classify engine."""
    (tmp_path / "g.fasta").write_text(">g\n" + "ACGT" * 300 + "\n")
    proc = _fresh_build(
        """
        import numpy as np
        from readbouncer_tpu_torch.classify.engine import ClassifyEngine, encode_batch
        from readbouncer_tpu_torch.fastio.fasta import read_records
        from readbouncer_tpu_torch.ibf.build import build_ibf, build_ibf_records
        from readbouncer_tpu_torch.ibf.params import IBFParams
        from readbouncer_tpu_torch.ibf.storage import IBFData

        def raised(fn):
            try:
                fn()
            except RuntimeError as e:
                return "host C++ compiler not found" in str(e)
            return False

        params = IBFParams(fragment_length=1000)
        torch_route, _ = build_ibf_records([("g", "ACGT" * 300)], params, device="cpu", use_native=False)
        engine = ClassifyEngine([torch_route], [], error_rate=0.1, batch_size=8, device="cpu")
        checks = {
            "load": raised(native.load_native),
            "encode_batch": raised(lambda: encode_batch(["ACGT"], 4)),
            "read_records": raised(lambda: list(read_records("g.fasta"))),
            "build_records": raised(lambda: build_ibf_records([("g", "ACGT" * 300)], params, device="cpu")),
            "classify": raised(lambda: engine.classify_sequences(["ACGT" * 100])),
        }
        print(checks)
        assert all(checks.values()), checks
        assert not native.BUILD_DIR.exists() or not any(native.BUILD_DIR.rglob("*.so"))
        print("RAISED")
        """,
        tmp_path,
        CXX=str(tmp_path / "no-such-compiler"),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "RAISED" in proc.stdout
