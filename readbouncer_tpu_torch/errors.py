"""Typed errors raised by the port.

A copy of readbouncer_tpu/errors.py (the port imports nothing of the
JAX package).  Names, bases and meaning are the same, so callers catch
the same types from either package; every class also derives from
``ValueError`` as there.
"""

from __future__ import annotations

__all__ = [
    "ReadBouncerError",
    "IBFError",
    "BuildError",
    "ClassifyError",
    "ShortReadError",
    "CountError",
    "InvalidParamsError",
    "EmptyFilterError",
    "BinCapacityError",
    "FilterFileError",
    "FilterSchemeError",
    "FilterGeometryError",
    "ConfigError",
    "MissingInputError",
    "WeightsError",
    "BasecallerError",
]


class ReadBouncerError(Exception):
    """Root of the framework's error hierarchy."""


class IBFError(ReadBouncerError, ValueError):
    """Any filter build/load/query failure (IBFException analog)."""


class BuildError(IBFError):
    """Filter construction failed (IBFBuildException analog)."""


class ClassifyError(IBFError):
    """Read classification failed (IBFClassifyException analog)."""


class ShortReadError(ClassifyError):
    """Sequence shorter than the k-mer size where a classification was
    required (ShortReadException analog)."""


class CountError(ClassifyError):
    """k-mer counting failed (CountKmerException analog)."""


class InvalidParamsError(BuildError):
    """Invalid IBF parameters (InvalidConfigException analog)."""


class EmptyFilterError(IBFError):
    """Operation on an absent/empty filter (NullFilterException analog)."""


class BinCapacityError(BuildError):
    """Fragments exceed padded bin capacity (InsertSequenceException analog)."""


class FilterFileError(IBFError, OSError):
    """Missing, unreadable or corrupt .ribf file (Missing/Parse/Store
    IBFFileException analogs)."""


class FilterSchemeError(FilterFileError):
    """.ribf built with a hash scheme this build does not support."""


class FilterGeometryError(IBFError):
    """Filters with incompatible (k, h, rows, scheme) stacked together."""


class ConfigError(ReadBouncerError, ValueError):
    """TOML configuration problem (FileParserException analog)."""


class MissingInputError(ConfigError):
    """Required input files absent (MissingReferenceFilesException analog)."""


class WeightsError(ReadBouncerError, ValueError):
    """Basecaller weight file missing or malformed."""


class BasecallerError(ReadBouncerError, RuntimeError):
    """Basecaller failure (reference: BasecallerException,
    src/basecaller/Basecaller.hpp:30-55): remote server unreachable,
    connection dropped, or malformed response."""
