"""FASTA/FASTQ streaming reader and FASTA writer.

Mirrors the reference's seqan-based record I/O surface
(seqan::readRecords at src/IBF/IBFBuild.cpp:52, seqan::readRecord at
src/main/classify.hpp:237, seqan::writeRecord at
src/main/classify.hpp:301).  ``read_records`` streams records through
the native host library (``readbouncer_tpu_torch/native``, the port's
copy of the JAX package's C++ reader), as the JAX package does wherever
its extension is built.  The pure-Python parser (``_iter_fasta``,
``_iter_fastq``, ``read_records_py``) is a copy of the JAX package's
fallback and stays as the plain version the tests compare with.

The native reader's rules, which differ from the Python parser at the
edges (``native/rbt_native.cpp``):

* with ``first_word_id`` an id is cut at the first space **or tab**
  (the Python parser cuts at a space only; reference seqid handling:
  src/IBF/IBFBuild.cpp:77);
* gzip is recognised by the file's content, whatever its suffix (zlib
  reads plain files unchanged); the Python parser decompresses only a
  ``.gz`` file;
* the format is FASTQ when the first byte is ``@``, whatever the suffix;
  the Python parser also takes ``.fastq`` / ``.fq`` as FASTQ;
* blank lines inside a FASTA record are skipped by both; a malformed
  FASTQ record raises ``ValueError`` in both.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from readbouncer_tpu_torch.native import CALLS, load_native

__all__ = ["SeqRecord", "read_records", "read_records_py", "FastaWriter"]


@dataclass
class SeqRecord:
    id: str
    seq: str


def _open_text(path: Path):
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path, "r")


def _iter_fasta(f) -> Iterator[SeqRecord]:
    header = None
    chunks: list[str] = []
    for line in f:
        line = line.rstrip("\r\n")
        if not line:
            continue
        if line.startswith(">"):
            if header is not None:
                yield SeqRecord(header, "".join(chunks))
            header = line[1:]
            chunks = []
        else:
            chunks.append(line)
    if header is not None:
        yield SeqRecord(header, "".join(chunks))


def _iter_fastq(f) -> Iterator[SeqRecord]:
    while True:
        header = f.readline()
        if not header:
            return
        header = header.rstrip("\r\n")
        if not header:
            continue
        if not header.startswith("@"):
            raise ValueError(f"malformed FASTQ record header: {header[:60]!r}")
        seq = f.readline().rstrip("\r\n")
        plus = f.readline()
        if not plus.startswith("+"):
            raise ValueError("malformed FASTQ record: missing '+' line")
        f.readline()  # quality line, unused
        yield SeqRecord(header[1:], seq)


_FASTQ_SUFFIXES = {".fastq", ".fq"}


def read_records(path: str | Path, first_word_id: bool = False) -> Iterator[SeqRecord]:
    """Stream records from a FASTA/FASTQ file (plain or gzip), one at a
    time, through the native reader."""
    reader = load_native().module.read_records(str(path), first_word_id)
    CALLS["read_records"] += 1
    for rec_id, seq in reader:
        yield SeqRecord(rec_id, seq.decode("ascii"))


def read_records_py(path: str | Path, first_word_id: bool = False) -> Iterator[SeqRecord]:
    """``read_records``' plain version: the JAX package's Python parser
    (gzip supported by suffix)."""
    path = Path(path)
    suffixes = [s.lower() for s in path.suffixes]
    is_fastq = any(s in _FASTQ_SUFFIXES for s in suffixes)
    with _open_text(path) as f:
        if not is_fastq:
            # sniff: FASTQ files may be named .txt etc.
            pos_first = f.read(1)
            f.seek(0)
            is_fastq = pos_first == "@"
        it = _iter_fastq(f) if is_fastq else _iter_fasta(f)
        for rec in it:
            if first_word_id:
                rec.id = rec.id.split(" ", 1)[0]
            yield rec


class FastaWriter:
    """Sequential FASTA writer: one header line + one sequence line.

    Matches the reference's classified-read output shape
    (src/main/classify.hpp:289-290 writes id + full sequence on one line).
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._f = open(self.path, "w")

    def write(self, rec_id: str, seq: str) -> None:
        self._f.write(f">{rec_id}\n{seq}\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "FastaWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
