"""Count-layout prototypes of the IBF query, timed on the card.

Counterpart of scripts/proto_counts_layout.py: per-call device time of
the count variants at the phase-A bench shape (R=8192 reads, L=250, W=8
words, 1,236,269 rows, k=13, h=3), on the same inputs, drawn from
``default_rng(3)`` draw for draw:

  ripple  ``ibf/query.py::counts(accum="ripple")``: row gather, each
          window's [R, 2, W] words folded into the planes in turn
  tree    ``counts(accum="tree")``: a carry-save adder tree over each
          chunk of 128 windows, then one add
  flat    row gather, reshaped to [R, 2, wc*W], the ripple at full width,
          the wc slots merged by an adder tree at the end
  flatg   the same with an element gather over flat [R, 2, wc*W] int64
          indices into the flattened bits
  k1      ``counts`` as the engine calls it: the row gathers and AND for
          all windows at once, then kernel K1 (``accumulate_planes``)

Every variant must equal the first exactly; the tool exits 1 if one does
not.  Each prints its per-call time (CUDA events around ``--reps`` calls
after the first; on the CPU the host clock) and its first call's
seconds.  The last line is one JSON object:

    {"metric": "proto_counts_layout_ms", "shape", "variants": {name:
     {"ms", "first_s", "match"}}, "device"}

    python -m readbouncer_tpu_torch.tools.proto_counts_layout [--reps 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.ibf.query import chunked_codes, counts, hash_rows_all, tree_sum_planes
from readbouncer_tpu_torch.ops.ibf_count import expand_planes
from readbouncer_tpu_torch.tools._bench_util import card, sync

__all__ = ["R", "L", "W", "ROWS", "K", "H", "WC", "VARIANTS", "proto_inputs", "flat_core",
           "run_proto_counts_layout", "main"]

R, L, W, ROWS, K, H = 8192, 250, 8, 1_236_269, 13, 3
WC = 128
VARIANTS = ("ripple", "tree", "flat", "flatg", "k1")


def proto_inputs(r: int, l: int, w: int, rows: int):
    """(bits u32 [rows, w], reads u8 [r, l], lengths i32 [r]) as the JAX
    script draws them; the first r // 8 reads are 97 bp long."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 1 << 32, size=(rows, w), dtype=np.uint32)
    reads = rng.integers(0, 4, size=(r, l)).astype(np.uint8)
    lengths = np.full(r, l, dtype=np.int32)
    lengths[: r // 8] = 97  # some short reads exercise masking
    return bits, reads, lengths


def flat_core(bits, reads, lengths, *, k: int, h: int, rows: int, elem_gather: bool) -> torch.Tensor:
    """The flat and flatg layouts (the JAX script's ``_flat_core``): int32
    counts [R, 2, W*32] of rbt1 filters ``bits`` int32 [rows, W]."""
    Rr, Ll = reads.shape
    Ww = bits.shape[1]
    n_planes = max(int(Ll - k + 1).bit_length(), 1)
    dev = reads.device
    codes, n_valid, wc = chunked_codes(reads, lengths, k, WC)
    bits_flat = bits.reshape(-1)
    lane_off = torch.arange(Ww, device=dev).repeat(wc)  # [wc*W]
    win = torch.arange(wc, device=dev)
    planes = [torch.zeros((Rr, 2, wc * Ww), dtype=torch.int32, device=dev) for _ in range(n_planes)]
    for base in range(0, codes.shape[2], wc):
        anded = None
        for ridx in hash_rows_all(codes[:, :, base : base + wc], h, rows, "rbt1"):
            if elem_gather:
                idxf = ridx.repeat_interleave(Ww, dim=2) * Ww + lane_off  # [R, 2, wc*W]
                g = bits_flat.take(idxf)
            else:
                g = bits.index_select(0, ridx.reshape(-1)).reshape(Rr, 2, wc * Ww)
            anded = g if anded is None else anded.bitwise_and_(g)
        valid = (base + win)[None, :] < n_valid[:, None]  # [R, wc]
        anded.masked_fill_(~valid.repeat_interleave(Ww, dim=1)[:, None, :], 0)
        # full-width ripple: one 1-bit add into the planes
        carry = anded
        for j in range(n_planes):
            planes[j], carry = planes[j] ^ carry, planes[j] & carry
    # merge the wc slots: an adder tree in the plane domain
    tot = tree_sum_planes([p.reshape(Rr, 2, wc, Ww) for p in planes])
    return expand_planes(torch.stack(tot, dim=2).reshape(2 * Rr, len(tot), Ww)).reshape(Rr, 2, Ww * 32)


def _variant(name: str, k: int, h: int, rows: int):
    if name in ("flat", "flatg"):
        return lambda b, r, l: flat_core(b, r, l, k=k, h=h, rows=rows, elem_gather=name == "flatg")
    return lambda b, r, l: counts(b, r, l, k=k, h=h, rows=rows, accum=name)


def _per_call_ms(fn, dev: torch.device, reps: int) -> float:
    """Milliseconds per call over ``reps`` calls: CUDA events on the card,
    the host clock on the CPU."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run_proto_counts_layout(dev, r: int, l: int, w: int, rows: int, reps: int = 3, variants=VARIANTS) -> dict:
    """Every variant on the inputs drawn at [r, l] reads and [rows, w] bits:
    {"variants": {name: {"ms", "first_s", "match"}}, "matches": {name:
    bool}, "line": the JSON line}.  ``match`` is "ref" for the first
    variant, then "OK" or "MISMATCH"."""
    dev = resolve_device(dev)
    bits, reads, lengths = proto_inputs(r, l, w, rows)
    bits_d = torch.from_numpy(bits.view(np.int32)).to(dev)
    reads_d = torch.from_numpy(reads).to(dev)
    lens_d = torch.from_numpy(lengths).to(dev)
    sync(dev)
    out, matches, ref = {}, {}, None
    for name in variants:
        fn = _variant(name, K, H, rows)
        t0 = time.perf_counter()
        got = fn(bits_d, reads_d, lens_d)
        sync(dev)
        first = time.perf_counter() - t0
        ms = _per_call_ms(lambda: fn(bits_d, reads_d, lens_d), dev, reps)
        if ref is None:
            ref, match = got, "ref"
        else:
            matches[name] = bool(torch.equal(got, ref))
            match = "OK" if matches[name] else "MISMATCH"
        del got
        print(f"{name:7s}: {ms:8.3f} ms/call  (first call {first:.2f} s)  {match}", flush=True)
        out[name] = {"ms": ms, "first_s": first, "match": match}
    line = {"metric": "proto_counts_layout_ms", "shape": {"R": r, "L": l, "W": w, "rows": rows, "k": K, "h": H},
            "variants": out, "device": card(dev)}
    return {"variants": out, "matches": matches, "line": line}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    res = run_proto_counts_layout(args.device, R, L, W, ROWS, reps=args.reps)
    print(json.dumps(res["line"]), flush=True)
    return 0 if all(res["matches"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
