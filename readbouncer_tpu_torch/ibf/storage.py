"""Interleaved Bloom Filter container and on-disk format (.ribf).

A copy of readbouncer_tpu/ibf/storage.py (host-side numpy container and
the same file format, ``empty`` and ``resize_bins`` for the build and
update paths), plus ``ibf_from_numpy``, which carries a JAX package
filter's fields across into this package's ``IBFData``.

The filter is a uint32 bit matrix ``bits[rows, words]``:

* ``rows``  = bits per bin slice (hash rows), from the sizing formula
  (reference: src/IBF/IBFBuild.cpp:404-413),
* ``words`` = padded_bins / 32 where padded_bins = 64-padded bin count —
  the same bin-interleaved geometry as the reference layout
  (reference: src/IBF/IBFBuild.cpp:407), stored word-major so a whole
  hash row (all bins) is one contiguous vector: ideal for the TPU query
  kernel's row gather + AND + popcount-accumulate.

On-disk format is a plain ``.npz`` (uncompressed, mmap-friendly) with a
version/scheme stamp.  The reference's ``seqan::store``/``retrieve``
(src/IBF/IBFBuild.cpp:505,343) round-trip is mirrored by
``save``/``load``; ``sniff`` mirrors ``ConfigReader::filterException``'s
is-this-a-filter-file probe (src/config/configReader.cpp:210-224) without
the exception-driven control flow.
"""

from __future__ import annotations

import zipfile
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from readbouncer_tpu_torch.errors import FilterFileError, FilterSchemeError
from readbouncer_tpu_torch.ibf.hashing import HASH_SCHEME, SUPPORTED_SCHEMES
from readbouncer_tpu_torch.ibf.params import optimal_bins

__all__ = ["IBFData", "sniff", "ibf_from_numpy"]

_MAGIC = "RIBF1"


@dataclass
class IBFData:
    """An interleaved Bloom filter plus its query-relevant metadata."""

    kmer_size: int
    hash_functions: int
    num_bins: int  # declared bins (reference: stats.totalBinsBinId)
    bits: np.ndarray  # uint32 [rows, padded_bins // 32]
    fragment_length: int = 0
    max_fp: float = 0.01
    name: str = ""
    # hash scheme the bits were built with (ibf.hashing module doc);
    # queries must dispatch on this
    scheme: str = HASH_SCHEME
    # per-bin provenance: (seqid, fragment_start, fragment_end); optional
    bin_seqids: list[str] = field(default_factory=list)
    bin_ranges: np.ndarray | None = None  # uint64 [bins, 2]

    @property
    def rows(self) -> int:
        return int(self.bits.shape[0])

    @property
    def padded_bins(self) -> int:
        return int(self.bits.shape[1]) * 32

    @property
    def words(self) -> int:
        return int(self.bits.shape[1])

    @property
    def total_bits(self) -> int:
        return self.rows * self.padded_bins

    @classmethod
    def empty(
        cls,
        rows: int,
        num_bins: int,
        kmer_size: int,
        hash_functions: int,
        fragment_length: int = 0,
        max_fp: float = 0.01,
        name: str = "",
        scheme: str = HASH_SCHEME,
    ) -> "IBFData":
        words = optimal_bins(num_bins) // 32
        return cls(
            kmer_size=kmer_size,
            hash_functions=hash_functions,
            num_bins=num_bins,
            bits=np.zeros((rows, words), dtype=np.uint32),
            fragment_length=fragment_length,
            max_fp=max_fp,
            name=name,
            scheme=scheme,
        )

    def resize_bins(self, new_num_bins: int) -> "IBFData":
        """Grow the bin axis (64-padded), keeping existing bits.

        Mirrors seqan resizeBins used by the incremental update path
        (reference: src/IBF/IBFBuild.cpp:274).
        """
        new_words = optimal_bins(new_num_bins) // 32
        if new_words > self.words:
            pad = np.zeros((self.rows, new_words - self.words), dtype=np.uint32)
            self.bits = np.concatenate([self.bits, pad], axis=1)
        self.num_bins = new_num_bins
        return self

    def save(self, path: str | Path) -> None:
        path = Path(path)
        payload: dict[str, np.ndarray] = {
            "magic": np.array(_MAGIC),
            "scheme": np.array(self.scheme),
            "kmer_size": np.array(self.kmer_size, dtype=np.int64),
            "hash_functions": np.array(self.hash_functions, dtype=np.int64),
            "num_bins": np.array(self.num_bins, dtype=np.int64),
            "fragment_length": np.array(self.fragment_length, dtype=np.int64),
            "max_fp": np.array(self.max_fp, dtype=np.float64),
            "name": np.array(self.name),
            "bits": self.bits,
        }
        if self.bin_seqids:
            payload["bin_seqids"] = np.array(self.bin_seqids)
        if self.bin_ranges is not None:
            payload["bin_ranges"] = self.bin_ranges
        with open(path, "wb") as f:
            np.savez(f, **payload)

    @classmethod
    def load(cls, path: str | Path, name: str | None = None) -> "IBFData":
        if not sniff(path):
            raise FilterFileError(f"{path}: not a {_MAGIC} filter file")
        with np.load(path, allow_pickle=False) as z:
            if "magic" not in z or str(z["magic"]) != _MAGIC:
                raise FilterFileError(f"{path}: not a {_MAGIC} filter file")
            scheme = str(z["scheme"])
            if scheme not in SUPPORTED_SCHEMES:
                raise FilterSchemeError(
                    f"{path}: hash scheme {scheme!r} not in supported {SUPPORTED_SCHEMES}"
                )
            return cls(
                kmer_size=int(z["kmer_size"]),
                hash_functions=int(z["hash_functions"]),
                num_bins=int(z["num_bins"]),
                bits=np.ascontiguousarray(z["bits"]),
                fragment_length=int(z["fragment_length"]),
                max_fp=float(z["max_fp"]),
                name=name if name is not None else str(z["name"]),
                scheme=scheme,
                bin_seqids=[str(s) for s in z["bin_seqids"]] if "bin_seqids" in z else [],
                bin_ranges=np.array(z["bin_ranges"]) if "bin_ranges" in z else None,
            )


def sniff(path: str | Path) -> bool:
    """True if *path* is a .ribf filter file (FASTA input otherwise).

    Non-throwing equivalent of the reference's try-retrieve-catch sniffing
    (src/config/configReader.cpp:210-224).
    """
    try:
        with open(path, "rb") as f:
            head = f.read(4)
        if head[:2] != b"PK":  # npz is a zip archive
            return False
        with zipfile.ZipFile(path) as zf:
            return "magic.npy" in zf.namelist()
    except (OSError, zipfile.BadZipFile):
        return False


def ibf_from_numpy(fields: dict) -> IBFData:
    """Carry a filter across from the JAX package.

    ``fields`` holds the JAX ``IBFData``'s fields as plain values and
    numpy arrays (``vars(jax_ibf)`` will do): ``bits``, ``kmer_size``,
    ``hash_functions``, ``num_bins`` and optionally ``fragment_length``,
    ``max_fp``, ``name``, ``scheme``, ``bin_seqids``, ``bin_ranges``.
    The bits are copied, so the two filters share no memory.
    """
    scheme = str(fields.get("scheme", HASH_SCHEME))
    if scheme not in SUPPORTED_SCHEMES:
        raise FilterSchemeError(
            f"hash scheme {scheme!r} not in supported {SUPPORTED_SCHEMES}"
        )
    bits = np.array(fields["bits"], dtype=np.uint32, copy=True)
    if bits.ndim != 2:
        raise FilterFileError(f"bits must be 2-D [rows, words], got {bits.shape}")
    ranges = fields.get("bin_ranges")
    return IBFData(
        kmer_size=int(fields["kmer_size"]),
        hash_functions=int(fields["hash_functions"]),
        num_bins=int(fields["num_bins"]),
        bits=bits,
        fragment_length=int(fields.get("fragment_length", 0)),
        max_fp=float(fields.get("max_fp", 0.01)),
        name=str(fields.get("name", "")),
        scheme=scheme,
        bin_seqids=[str(x) for x in fields.get("bin_seqids", [])],
        bin_ranges=None if ranges is None else np.array(ranges, dtype=np.uint64),
    )
