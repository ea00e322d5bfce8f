"""The port's native host library, built with the host C++ compiler.

``rbt_native.cpp`` beside this file is the port's copy of the JAX
package's host layer (``native/rbt_native.cpp``): ``encode_batch``,
``encode``, the streaming ``read_records`` and the IBF build's
``insert_fragments``, plus the port's own ``pack_codes``, the upload
path's 2-bit / base-243 packer (bit-equal to the JAX package's numpy
``pack4_np`` / ``pack5_np``).  It is a CPython extension module named
``readbouncer_tpu_torch.native._rbt_host`` (``PyInit__rbt_host``), never
``readbouncer_tpu._native``.

``load_native()`` compiles it on first use with the host C++ compiler
(``$CXX``, else ``c++``, else ``g++``) and the JAX build's flags
(``native/setup.py``: ``-O3 -std=c++20 -Wall``, zlib) into
``build/torch_host/<key>/`` at the repository root, keyed by a hash of
the source and the flags, and loads it with ``importlib``.  The library
is written under a temporary name and renamed into place, so concurrent
builds never load a half-written file.  A missing compiler or a failed
build raises with the compiler's output; no caller falls back to numpy.
Nothing is compiled or loaded on import.

Callers count their calls in ``CALLS`` (``encode_batch``,
``read_records``, ``insert_fragments``, ``pack_codes``), so a run can
show that a path went through the library.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

__all__ = ["CALLS", "CXX_FLAGS", "HostLibrary", "MODULE", "SOURCE", "find_cxx", "load_native"]

SOURCE = Path(__file__).resolve().parent / "rbt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_host"
MODULE = "readbouncer_tpu_torch.native._rbt_host"
CXX_FLAGS = ("-O3", "-std=c++20", "-Wall", "-shared", "-fPIC", "-pthread")
LIBS = ("-lz",)

CALLS: Counter = Counter()


@dataclass(frozen=True)
class HostLibrary:
    """The loaded extension module and how it was obtained."""

    module: ModuleType
    path: Path
    built: bool  # False when an earlier build with the same key was found
    seconds: float  # build time (0 when reused)
    compiler: str  # the compiler's path and the first line of its --version
    log: str  # the compiler's output


def find_cxx() -> str:
    """``$CXX`` when set (it must exist), else ``c++``, else ``g++`` on PATH."""
    named = os.environ.get("CXX")
    for cand in ([named] if named else ["c++", "g++"]):
        found = shutil.which(cand)
        if found:
            return found
    raise RuntimeError(
        f"host C++ compiler not found ({'$CXX=' + named if named else 'c++ or g++ on PATH'}); "
        f"the native host library {SOURCE.name} cannot be built"
    )


def _compiler_version(cxx: str) -> str:
    proc = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    return (proc.stdout or proc.stderr).splitlines()[0] if proc.returncode == 0 else "version not read"


def _import(path: Path) -> ModuleType:
    loader = importlib.machinery.ExtensionFileLoader(MODULE, str(path))
    spec = importlib.util.spec_from_file_location(MODULE, path, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    sys.modules[MODULE] = module
    return module


@functools.lru_cache(maxsize=None)
def load_native() -> HostLibrary:
    """Build (once per source hash) and load the host library."""
    include = sysconfig.get_paths()["include"]
    flags = (*CXX_FLAGS, f"-I{include}")
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags + LIBS).encode()).hexdigest()[:16]
    path = BUILD_DIR / key / f"_rbt_host{sysconfig.get_config_var('EXT_SUFFIX')}"
    built, seconds, log, compiler = False, 0.0, "", ""
    if not path.exists():
        cxx = find_cxx()
        compiler = f"{cxx} ({_compiler_version(cxx)})"
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [cxx, *flags, "-o", str(tmp), str(SOURCE), *LIBS]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.monotonic() - t0
        log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host C++ build failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, path)
        built = True
    return HostLibrary(_import(path), path, built, seconds, compiler, log)
