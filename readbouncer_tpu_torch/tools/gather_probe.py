"""Gather mechanics of the IBF query on the card, one experiment per call.

Counterpart of scripts/gather_probe.py, with its 25 experiments under
the same names, shapes, table sizes and ``--m`` default.  The row
gathers are most of the card's time in a classify batch; each experiment
times one way of fetching filter rows (``index_select`` for the
reference's ``jnp.take``) and prints its ms and rate:

  g72 g128           one gather from [ROWS, 72|128]
  tile tile_and      8-row tiles [ROWS/8, 8, 72]; + a one-hot select of 3
                     rows per tile and their AND
  gpar2 gpar4 gpar8  one gather split into K independent gathers
  g128h1 g72h1       one gather from an h=1-sized table [8 ROWS, 128|72]
  gwide gwide_and    8-row blocks stored as one wide row [ROWS/8, 576];
                     + a mask of 3 rows and the AND over 8
  gwide1152 gwide2304  16-row (32-row) blocks as one row, 245,000 gathers
  gsuper             gwide1152 + a 2-offset select and the AND over 16
                     rows for 4 windows per gather
  g144               2-row granularity [ROWS/2, 144]
  g72h1p2 g128h1p2 g72h1p4  the h=1 table split into 2 or 4 gathers
  g2and              h=2 sizing [1.536 ROWS, 72]: 2 gathers + AND
  gsort gsorth1      the g72 (g72h1) gather with sorted indices
  gprod              the classify path's gathers: ``ibf/query.py::
                     anded_windows`` (k-mer codes, hash rows, three row
                     gathers, the AND, the length mask) on READS reads x
                     250 bp, k=13, h=3
  gprod_nobar        the JAX script's gprod without its
                     ``optimization_barrier``; eager PyTorch has no
                     barrier, so this is gprod's program: it runs it once,
                     untimed, and reports that its time is gprod's
  gprod_idx          gprod's gathers, AND and mask with the hash rows
                     computed beforehand (inputs)
  g3                 three gathers from [ROWS, 72] + AND

Tables and indices are drawn on the device from a ``torch.Generator``
seeded 0 (``dma_gather_probe.random_words`` for the tables).  JAX's
threefry draws cannot be matched, so the values differ from the
reference's; the shapes and the timed work do not.  ``--rows`` shrinks
the table (default ROWS, the script's); ``--device cpu`` runs on the
CPU, whose times are CPU times.  The last line is one JSON object:
``{"metric": "gather_probe_ms", "exp", "m", "ms", "rate", "unit",
"device"}`` (gprod_nobar: ``ms`` and ``rate`` null, ``same_as``
"gprod").

    python -m readbouncer_tpu_torch.tools.gather_probe EXP [--m M] [--rows N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.ibf.query import anded_windows, hash_rows_all, kmer_codes
from readbouncer_tpu_torch.tools._bench_util import card, sync, timeit
from readbouncer_tpu_torch.tools.dma_gather_probe import random_words

__all__ = ["ROWS", "M_DEFAULT", "READS", "EXPERIMENTS", "setup", "run_gather_probe", "main"]

ROWS = 1_236_269
M_DEFAULT = 2048 * 2 * 238
READS = 2048  # gprod's batch
EXPERIMENTS = (
    "g72", "g128", "tile", "tile_and", "gpar2", "gpar4", "gpar8", "g128h1", "g72h1",
    "gwide", "gwide_and", "gwide1152", "gwide2304", "gsuper", "g144",
    "g72h1p2", "g128h1p2", "g72h1p4", "g2and", "gsort", "gsorth1",
    "gprod", "gprod_nobar", "gprod_idx", "g3",
)
ALL_ONES = -1  # 0xFFFFFFFF as an int32 word


def _take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, i)


def _idx(gen: torch.Generator, n: int, shape) -> torch.Tensor:
    return torch.randint(0, n, shape, dtype=torch.int32, generator=gen, device=gen.device)


def setup(exp: str, m: int, rows: int, dev) -> tuple:
    """(fn, args, text, items, unit): the experiment's program, its inputs,
    the text its line starts with, and the items its rate counts."""
    gen = torch.Generator(device=dev).manual_seed(0)
    big_rows = rows * 8  # the h=1 sizing (~99.5 bits/key)
    if exp in ("g72", "g128"):
        w = 72 if exp == "g72" else 128
        tab, idx = random_words((rows, w), gen), _idx(gen, rows, (m,))
        return _take, (tab, idx), f"gather [rows,{w}] M={m}", m, "Mrows/s"
    if exp in ("tile", "tile_and"):
        n_tiles = rows // 8
        tab3, tidx = random_words((n_tiles, 8, 72), gen), _idx(gen, n_tiles, (m,))
        if exp == "tile":
            return _take, (tab3, tidx), f"tile gather [tiles,8,72] M={m}", m, "Mtiles/s"
        g = _idx(gen, 8, (m, 3)).long()

        def tile_and(t, i, g):
            tiles = _take(t, i)  # [M, 8, W]
            outs = []
            for j in range(3):
                s = torch.nn.functional.one_hot(g[:, j], 8).to(torch.int32)[:, :, None]
                outs.append((tiles * s).sum(dim=1, dtype=torch.int32))
            return outs[0] & outs[1] & outs[2]

        return tile_and, (tab3, tidx, g), f"tile gather+select+AND M={m}", m, "Mtiles/s"
    if exp in ("gpar2", "gpar4", "gpar8"):
        k = int(exp[4:])
        tab = random_words((rows, 72), gen)
        parts = [_idx(gen, rows, (m // k,)) for _ in range(k)]
        return (lambda t, *ix: [_take(t, i) for i in ix]), (tab, *parts), f"{k}-way split gather M={m}", m, "Mrows/s"
    if exp in ("g128h1", "g72h1"):
        w = 128 if exp == "g128h1" else 72
        tab, idx = random_words((big_rows, w), gen), _idx(gen, big_rows, (m,))
        return _take, (tab, idx), f"gather [8x rows,{w}] M={m}", m, "Mrows/s"
    if exp in ("gwide", "gwide_and"):
        n_blocks = rows // 8
        tabw, tidx = random_words((n_blocks, 8 * 72), gen), _idx(gen, n_blocks, (m,))
        if exp == "gwide":
            return _take, (tabw, tidx), f"wide gather [blocks,576] M={m}", m, "Mblk/s"
        g = _idx(gen, 8, (m, 3))
        s_idx = torch.arange(8, dtype=torch.int32, device=dev)

        def wide_and(t, i, g):
            tiles = _take(t, i).reshape(m, 8, 72)
            sel = torch.zeros((m, 8), dtype=torch.bool, device=dev)
            for j in range(3):
                sel = sel | (g[:, j : j + 1] == s_idx[None, :])
            masked = torch.where(sel[:, :, None], tiles, ALL_ONES)
            out = masked[:, 0, :]
            for s in range(1, 8):
                out = out & masked[:, s, :]
            return out

        return wide_and, (tabw, tidx, g), f"wide gather+mask+AND M={m}", m, "Mblk/s"
    if exp in ("gwide1152", "gwide2304", "gsuper"):
        lanes = 2304 if exp == "gwide2304" else 1152
        n_blocks = int(rows * 2.05) // 16  # h=2 s=4 sizing ~2.05x rbt1 rows
        mm = 245_000 if m == M_DEFAULT else m
        tabw, tidx = random_words((n_blocks, lanes), gen), _idx(gen, n_blocks, (mm,))
        if exp != "gsuper":
            return _take, (tabw, tidx), f"wide gather [blocks,{lanes}] M={mm}", mm, "Mblk/s"
        offs = _idx(gen, 16, (mm, 4, 2))
        s_idx = torch.arange(16, dtype=torch.int32, device=dev)

        def super_and(t, i, offs):
            g = _take(t, i).reshape(mm, 16, 72)
            outs = []
            for w in range(4):
                sel = (offs[:, w, 0:1] == s_idx) | (offs[:, w, 1:2] == s_idx)
                masked = torch.where(sel[:, :, None], g, ALL_ONES)
                out = masked[:, 0, :]
                for s in range(1, 16):
                    out = out & masked[:, s, :]
                outs.append(out)
            return torch.stack(outs, dim=1)  # [m, 4, 72]

        return super_and, (tabw, tidx, offs), f"rbt3 gather+select+AND M={mm}", 4 * mm, "Mwindows/s"
    if exp == "g144":
        tab, idx2 = random_words((rows // 2, 144), gen), _idx(gen, rows // 2, (m,))
        return _take, (tab, idx2), f"gather [rows/2,144] M={m}", m, "Mrows/s"
    if exp in ("g72h1p2", "g128h1p2", "g72h1p4"):
        w = 128 if "128" in exp else 72
        k = int(exp[-1])
        tab = random_words((big_rows, w), gen)
        parts = [_idx(gen, big_rows, (m // k,)) for _ in range(k)]
        return ((lambda t, *ix: [_take(t, i) for i in ix]), (tab, *parts),
                f"{k}-way h1 gather [8x rows,{w}] M={m}", m, "Mrows/s")
    if exp == "g2and":
        rows2 = int(rows * 1.536)  # h=2 sizing (18.98 bits/key)
        tab, idx2 = random_words((rows2, 72), gen), _idx(gen, rows2, (2, m))
        return ((lambda t, i: _take(t, i[0]) & _take(t, i[1])), (tab, idx2),
                f"2x gather+AND [1.5x rows,72] M={m}", 2 * m, "Mrows/s")
    if exp in ("gsort", "gsorth1"):
        n = rows if exp == "gsort" else big_rows
        tab = random_words((n, 72), gen)
        idxs = torch.sort(_idx(gen, n, (m,))).values
        return _take, (tab, idxs), f"sorted gather [{n},72] M={m}", m, "Mrows/s"
    if exp in ("gprod", "gprod_nobar", "gprod_idx"):
        reads, cl, k, h = READS, 250, 13, 3
        tab = random_words((rows, 72), gen)
        rd = torch.randint(0, 4, (reads, cl), dtype=torch.int32, generator=gen, device=dev).to(torch.uint8)
        lens = torch.full((reads,), cl, dtype=torch.int64, device=dev)
        n = cl - k + 1
        text, items = f"{exp} [{reads}x{cl} h={h}]", reads * 2 * n * h
        if exp != "gprod_idx":
            return ((lambda t, r, l: anded_windows(t, r, l, k=k, h=h, rows=rows, scheme="rbt1")),
                    (tab, rd, lens), text, items, "Mrows/s")
        win = torch.arange(n, device=dev)

        def masked_and(t, i0, i1, i2, l):
            anded = _take(t, i0.reshape(-1)) & _take(t, i1.reshape(-1)) & _take(t, i2.reshape(-1))
            valid = win[None, :] < (l - (k - 1))[:, None]
            return anded.reshape(reads, 2, n, 72).masked_fill_(~valid[:, None, :, None], 0)

        return masked_and, (tab, *hash_rows_all(kmer_codes(rd, k), h, rows, "rbt1"), lens), text, items, "Mrows/s"
    if exp == "g3":
        tab, idx3 = random_words((rows, 72), gen), _idx(gen, rows, (3, m))
        return ((lambda t, i: _take(t, i[0]) & _take(t, i[1]) & _take(t, i[2])), (tab, idx3),
                f"3x gather+AND [rows,72] M={m}", 3 * m, "Mrows/s")
    raise SystemExit(f"unknown exp {exp}")


def run_gather_probe(exp: str, dev, *, m: int = M_DEFAULT, rows: int = ROWS) -> dict:
    """One experiment: its ms, rate and JSON ``line``."""
    dev = resolve_device(dev)
    fn, args, text, items, unit = setup(exp, m, rows, dev)
    sync(dev)
    if exp == "gprod_nobar":
        fn(*args)
        sync(dev)
        print("gprod_nobar: eager PyTorch has no optimization_barrier; this is gprod's program, "
              "ran once, its time is gprod's", flush=True)
        line = {"metric": "gather_probe_ms", "exp": exp, "m": m, "ms": None, "rate": None, "unit": unit,
                "same_as": "gprod", "device": card(dev)}
        return {"ms": None, "rate": None, "unit": unit, "line": line}
    dt = timeit(fn, *args, device=dev)
    rate = items / dt / 1e6
    print(f"{text}: {dt * 1e3:.3f} ms  {rate:.1f} {unit}", flush=True)
    line = {"metric": "gather_probe_ms", "exp": exp, "m": m, "ms": dt * 1e3, "rate": rate, "unit": unit,
            "device": card(dev)}
    return {"ms": dt * 1e3, "rate": rate, "unit": unit, "line": line}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp", choices=EXPERIMENTS)
    ap.add_argument("--m", type=int, default=M_DEFAULT)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    res = run_gather_probe(args.exp, args.device, m=args.m, rows=args.rows)
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
