"""The gather probe on a CUDA card: kernel K5 against PyTorch's gathers.

Counterpart of scripts/dma_gather_probe.py, with the same experiments,
shapes and defaults.  The TPU probe asked whether explicit DMA
descriptors beat the XLA gather engine's per-index cost.  XOR cancels
pairs, so K5 (``ops/gather.py::xor_gather``) reads only the slices hit an
odd number of times: a parity bitmap of the indices, the list of its set
bits, and a gather of the listed slices (at most CH per block, NBUF
16-byte copies in flight per thread through a shared-memory ring).  Here
the question is whether K5 reads those odd-hit slices at the card's
memory rate, and how PyTorch's ``index_select``, which gathers every
index's slice, compares.  The cuda_* experiments print the odd-hit
slices, the bytes K5 needs (those slices and the indices) and their rate,
and the per-index rate, labelled effective since most indices' slices
are never read.

    python -m readbouncer_tpu_torch.tools.dma_gather_probe EXP [--m M] [--ch CH] [--nbuf NBUF]
    python -m readbouncer_tpu_torch.tools.dma_gather_probe --check

Experiments, one per invocation:

  cuda_block   K5 on [ROWS // 8, 8, 128] (the rbt2 geometry: one 8-row
               block per k-mer, W padded 72 -> 128 as on the TPU)
  cuda_row     K5 on [ROWS, 1, 128] (the rbt1 geometry: one row per index)
  torch_block  the same block workload through ``index_select`` on
               [ROWS // 8, 8, 72] (the library baseline, as xla_block was)
  torch_g3     three flat ``index_select`` row gathers + AND on [ROWS, 72]
               (the classify path's gather, as xla_g3 was)

``--check`` runs K5 at the reference probe's small shapes (1,024 x 8 x
128 table, 512 indices, CH=128, NBUF=4) against numpy.  Tables and
indices are drawn on the device from an explicit ``torch.Generator``
(seed 0).  ``--rows`` shrinks the table (default ROWS); ``--device cpu``
runs the plain versions, whose times are CPU times.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.ops.gather import xor_gather
from readbouncer_tpu_torch.tools._bench_util import device_name, sync, timeit

__all__ = ["ROWS", "W", "EXPERIMENTS", "random_words", "experiment_inputs", "main"]

ROWS = 1_236_269  # rbt1 rows of one 512-bin x 100 kb filter (bench geometry)
W = 72  # words per row of the 4-filter bench stack
EXPERIMENTS = ("cuda_block", "cuda_row", "torch_block", "torch_g3")


def random_words(shape, gen: torch.Generator) -> torch.Tensor:
    """Uniform 32-bit words as int32, drawn on the generator's device."""
    x = torch.randint(0, 2**32, shape, dtype=torch.int64, generator=gen, device=gen.device)
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def experiment_inputs(exp: str, m: int, rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(table, indices) of one experiment, from a generator seeded 0 on
    ``device``; torch_g3's indices are [3, m]."""
    gen = torch.Generator(device=device).manual_seed(0)
    if exp in ("cuda_block", "torch_block"):
        n = rows // 8
        tab = random_words((n, 8, 128 if exp == "cuda_block" else W), gen)
    elif exp == "cuda_row":
        n = rows
        tab = random_words((n, 1, 128), gen)
    elif exp == "torch_g3":
        tab = random_words((rows, W), gen)
        return tab, torch.randint(0, rows, (3, m), dtype=torch.int32, generator=gen, device=gen.device)
    else:
        raise SystemExit(f"unknown exp {exp}")
    return tab, torch.randint(0, n, (m,), dtype=torch.int32, generator=gen, device=gen.device)


def _check(dev: torch.device) -> None:
    n_blocks, m, ch, nbuf = 1024, 512, 128, 4
    gen = torch.Generator(device=dev).manual_seed(0)
    tab = random_words((n_blocks, 8, 128), gen)
    idx = torch.randint(0, n_blocks, (m,), dtype=torch.int32, generator=gen, device=dev)
    out = xor_gather(tab, idx, ch, nbuf).cpu().numpy()
    expect = np.bitwise_xor.reduce(tab.cpu().numpy()[idx.cpu().numpy()], axis=0)
    np.testing.assert_array_equal(out, expect)
    print(f"xor_gather check OK on {device_name(dev)}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp", nargs="?", choices=EXPERIMENTS)
    ap.add_argument("--m", type=int, default=2048 * 2 * 238)  # 974,848
    ap.add_argument("--ch", type=int, default=2048)
    ap.add_argument("--nbuf", type=int, default=8)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.check:
        _check(dev)
        return 0
    if args.exp is None:
        ap.error("an experiment or --check is required")

    M = -(-args.m // args.ch) * args.ch
    tab, idx = experiment_inputs(args.exp, M, args.rows, dev)
    sync(dev)
    where = f"on {device_name(dev)}"
    if args.exp in ("cuda_block", "cuda_row"):
        xor_gather(tab, idx, args.ch, args.nbuf)  # checks the indices, outside the timed loop
        dt = timeit(lambda: xor_gather(tab, idx, args.ch, args.nbuf, check=False), device=dev)
        shape = f"[{tab.shape[0]},{tab.shape[1]},{tab.shape[2]}]"
        unit = "blk" if args.exp == "cuda_block" else "row"
        odd = int((torch.bincount(idx.long(), minlength=tab.shape[0]) & 1).sum())
        nbytes = odd * tab[0].numel() * 4 + M * 4
        print(
            f"{args.exp} {shape} M={M} CH={args.ch} NBUF={args.nbuf}: {dt * 1e3:.3f} ms  "
            f"{odd} odd-hit slices, {nbytes / 1e6:.1f} MB read at {nbytes / dt / 1e9:.1f} GB/s  "
            f"effective {M / dt / 1e6:.1f} M{unit}/s ({dt / M * 1e9:.2f} ns/{unit}) {where}"
        )
    elif args.exp == "torch_block":
        dt = timeit(lambda: tab.index_select(0, idx), device=dev)
        print(f"torch_block [blocks,8,{W}] M={M}: {dt * 1e3:.3f} ms  {M / dt / 1e6:.1f} Mblk/s {where}")
    else:
        dt = timeit(
            lambda: tab.index_select(0, idx[0]) & tab.index_select(0, idx[1]) & tab.index_select(0, idx[2]),
            device=dev,
        )
        print(f"torch_g3 [rows,{W}] M={M}: {dt * 1e3:.3f} ms  {3 * M / dt / 1e6:.1f} Mrows/s {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
