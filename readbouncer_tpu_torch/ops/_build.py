"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` (a plain C interface, no PyTorch headers, so a
build takes seconds) is its own library.  On first use
``load_library(name)`` compiles it into ``build/torch_kernels/`` at the
repository root, keyed by a hash of that source and the flags, binds its
entry points and loads it; ``load_all()`` builds every source at once,
one nvcc each.  A library is written under a temporary name and then
renamed into place, so concurrent builders never load a half-written
file.  Nothing is compiled or loaded on import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

__all__ = [
    "KernelLibrary",
    "NVCC_FLAGS",
    "SOURCES",
    "find_nvcc",
    "load_library",
    "load_all",
    "error_string",
]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {p.stem: p for p in sorted(CSRC.glob("*.cu"))}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


@dataclass(frozen=True)
class KernelLibrary:
    """A loaded kernel library and how it was obtained."""

    name: str
    lib: ctypes.CDLL
    path: Path
    built: bool  # False when an earlier build with the same key was found
    seconds: float  # build time (0 when reused)
    log: str  # nvcc's output: -Xptxas -v register / shared-memory lines


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or /usr/local/cuda/bin; "
        "the CUDA kernels cannot be built"
    )


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int

# entry point -> argtypes, per library; every entry point returns int
_SIGNATURES = {
    "ibf_count": {
        "rb_accumulate_planes": [_PTR, _PTR, _I32, _I32, _I32, _I32, _PTR],
        "rb_planes_dual_max": [
            _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _PTR, _PTR, _I32, _I32, _I32, _PTR,
        ],
        "rb_accumulate_counts": [_PTR, _PTR, _I32, _I32, _I32, _PTR],
    },
    "gather_probe": {
        "rb_xor_gather": [_PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _PTR],
    },
    "gru": {
        "rb_gru_layer": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _PTR],
        "rb_gru_config": [_I32, _I32, _PTR],
    },
}


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I32
    lib.rb_error_string.argtypes = [_I32]
    lib.rb_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> KernelLibrary:
    """Build (once per source hash) and load the library of csrc/<name>.cu."""
    if name not in SOURCES:
        raise ValueError(f"no kernel source {name}.cu in {CSRC}")
    source = SOURCES[name]
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"lib{name}_{key}.so"
    built, seconds, log = False, 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.monotonic() - t0
        log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, path)
        built = True
    return KernelLibrary(name, _bind(name, ctypes.CDLL(str(path))), path, built, seconds, log)


def load_all() -> list[KernelLibrary]:
    """Build and load every kernel library, one nvcc per source, in parallel."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return list(pool.map(load_library, SOURCES))


def error_string(err: int, name: str) -> str:
    return load_library(name).lib.rb_error_string(err).decode()
