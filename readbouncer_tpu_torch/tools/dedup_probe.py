"""Per-batch k-mer dedup against the row gathers, on the card.

Counterpart of scripts/dedup_probe.py, with its experiments, constants
and draws (``default_rng(3)``, draw for draw).  The classify path pays
one row gather per window and hash, duplicate k-mers included.  A dedup
pass would gather the Bloom rows once per distinct code (3 gathers + AND
-> anded [U, W]) and expand them per window with an inverse-map gather
(one lookup per window):

    cost_baseline = 3*M lookups
    cost_dedup    = 3*U + M lookups (+ the host's unique pass)

so dedup wins when the duplicate fraction d = 1 - U/M is above 1/3 and
the inverse-map gather, whose indices are an input, runs at the gathers'
rate.  Experiments, one per invocation:

  invgather [--u U]   ``index_select(anded[U, 72], inv[M])``, indices an input
  counts --dup D      baseline against dedup on counts-shaped work at a
                      duplicate level D in [0, 1); the host's
                      ``np.unique`` time is printed apart (in a pipelined
                      engine it would overlap device work)

``counts`` holds the dedup sums equal to the baseline's (sums over the
windows do not depend on their order) and ends the tool with an error if
they differ.  The last line is one JSON object with the times and
``device``.

    python -m readbouncer_tpu_torch.tools.dedup_probe {invgather,counts} [--u U] [--dup D] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.ibf.query import hash_rows_all
from readbouncer_tpu_torch.tools._bench_util import card, sync, timeit

__all__ = ["ROWS", "W", "M", "H", "synth_codes", "bloom_and", "sum_u32", "run_dedup_probe", "main"]

ROWS = 1_236_269
W = 72
M = 2048 * 2 * 238  # windows x strands of a 2048-chunk batch
H = 3  # hashes: the script's SEEDS, the first three of ibf/hashing.py's


def bloom_and(tab: torch.Tensor, codes: torch.Tensor, rows: int) -> torch.Tensor:
    """3 row gathers (rows hashed from int64-held u32 ``codes`` [N]) + AND
    -> int32 [N, W]."""
    out = None
    for ridx in hash_rows_all(codes, H, rows, "rbt1"):
        g = tab.index_select(0, ridx)
        out = g if out is None else out.bitwise_and_(g)
    return out


def sum_u32(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 of int32 words read as u32, mod 2**32 (the JAX
    uint32 sum), as int64."""
    return (x.to(torch.int64) & 0xFFFFFFFF).sum(dim=0) & 0xFFFFFFFF


def synth_codes(rng: np.random.Generator, m: int, dup: float) -> np.ndarray:
    """m u32 codes with ~dup duplicate fraction (pool sampling)."""
    u = max(1, int(m * (1.0 - dup)))
    pool = rng.integers(0, 1 << 32, size=u, dtype=np.uint64).astype(np.uint32)
    return pool[rng.integers(0, u, size=m)]


def _words(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32)).to(dev)


def run_dedup_probe(exp: str, dev, *, u: int = 262_144, dup: float = 0.5) -> dict:
    """One experiment over M windows and a [ROWS, W] table; returns its
    JSON ``line`` (for ``counts`` with ``sums_equal``, the dedup sums held
    against the baseline's)."""
    dev = resolve_device(dev)
    m, rows = M, ROWS
    rng = np.random.default_rng(3)
    line = {"metric": "dedup_probe", "exp": exp, "m": m, "rows": rows}
    if exp == "invgather":
        anded = _words(rng.integers(0, 1 << 32, size=(u, W), dtype=np.uint64).astype(np.uint32), dev)
        inv = torch.from_numpy(rng.integers(0, u, size=m).astype(np.int32)).to(dev)
        dt = timeit(lambda t, i: t.index_select(0, i), anded, inv, device=dev)
        print(f"invgather [U={u},{W}] M={m} (input flat idx): {dt * 1e3:.2f} ms  {m / dt / 1e6:.1f} Mrows/s",
              flush=True)
        line.update(u=u, ms=dt * 1e3, mrows_per_s=m / dt / 1e6, device=card(dev))
        return {"line": line}
    if exp != "counts":
        raise SystemExit(f"unknown exp {exp}")

    codes_np = synth_codes(rng, m, dup)
    tab = _words(rng.integers(0, 1 << 32, size=(rows, W), dtype=np.uint64).astype(np.uint32), dev)
    codes = torch.from_numpy(codes_np.astype(np.int64)).to(dev)

    def base(t, c):
        return sum_u32(bloom_and(t, c, rows))

    dt_base = timeit(base, tab, codes, device=dev)
    print(f"baseline 3-gather+AND M={m}: {dt_base * 1e3:.2f} ms ({3 * m / dt_base / 1e6:.1f} Mrows/s agg)",
          flush=True)

    t0 = time.perf_counter()
    ucodes_np, inv_np = np.unique(codes_np, return_inverse=True)
    t_unique = time.perf_counter() - t0
    n_unique = ucodes_np.size
    u_pad = 1 << (n_unique - 1).bit_length()  # power-of-two bucket: shape independent of dup
    ucodes_pad = np.zeros(u_pad, dtype=np.uint32)
    ucodes_pad[:n_unique] = ucodes_np
    print(f"dup={dup:.2f}: unique {n_unique}/{m} ({1 - n_unique / m:.2%} dup), "
          f"np.unique {t_unique * 1e3:.1f} ms, U_pad={u_pad}", flush=True)

    def dedup(t, uc, iv):
        return sum_u32(bloom_and(t, uc, rows).index_select(0, iv))

    uc = torch.from_numpy(ucodes_pad.astype(np.int64)).to(dev)
    iv = torch.from_numpy(inv_np.reshape(-1).astype(np.int32)).to(dev)
    dt_dedup = timeit(dedup, tab, uc, iv, device=dev)
    print(f"dedup 3-gather[U_pad={u_pad}]+AND+invgather: {dt_dedup * 1e3:.2f} ms "
          f"(vs baseline {dt_base * 1e3:.2f} ms -> {dt_base / dt_dedup:.2f}x)", flush=True)
    a, b = base(tab, codes), dedup(tab, uc, iv)
    sync(dev)
    sums_equal = bool(torch.equal(a, b))
    if sums_equal:
        print("decision-exactness: expanded sums equal baseline sums", flush=True)
    line.update(dup=dup, unique=n_unique, u_pad=u_pad, unique_host_ms=t_unique * 1e3, baseline_ms=dt_base * 1e3,
                dedup_ms=dt_dedup * 1e3, speedup=dt_base / dt_dedup, sums_equal=sums_equal, device=card(dev))
    return {"line": line}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp", choices=["invgather", "counts"])
    ap.add_argument("--u", type=int, default=262_144)
    ap.add_argument("--dup", type=float, default=0.5)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    res = run_dedup_probe(args.exp, args.device, u=args.u, dup=args.dup)
    if res["line"].get("sums_equal") is False:
        raise SystemExit("decision-exactness: the expanded sums differ from the baseline sums")
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
