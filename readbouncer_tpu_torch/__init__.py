"""readbouncer_tpu_torch — the PyTorch/CUDA port of readbouncer_tpu.

The JAX package ``readbouncer_tpu`` stays the reference; this package
is held bit-equal to it on every integer output (k-mer codes, hash rows,
bit planes, counts, per-filter maxima, thresholds, decisions, attempts,
output FASTAs, counters).  It imports ``torch`` and numpy and nothing of
the JAX package: host modules it needs are copied, not imported.

Layout mirrors the JAX package, so each counterpart has the same module
name.  The Pallas kernels on the ported paths are CUDA C++ kernels under
``ops/csrc/``: the IBF query's two (``ibf_count.cu``, for
``readbouncer_tpu/ops/ibf_count_pallas.py``) and the GRU recurrence
(``gru.cu``, for ``readbouncer_tpu/ops/gru_pallas.py``), each built with
``nvcc`` on first use and bound with ``ctypes`` (``ops/_build.py``).
The JAX package's compiled host layer (``native/rbt_native.cpp``: base
encoding, the FASTA/FASTQ reader, the build's insert) has its copy in
``native/``, built with the host C++ compiler on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``); without a card and without that explicit
request they raise.
"""

__version__ = "0.1.0"
