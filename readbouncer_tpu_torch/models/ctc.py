"""CTC decoding for the GRU basecaller.

A copy of readbouncer_tpu/models/ctc.py (the port imports nothing of the JAX
package).

Symbol set: index 0 = blank, 1..4 = A C G T (DeepNano's "NACGT"
convention).  The reference calls the Rust decoder with beam_size=5,
beam_cut_threshold=0.01 (src/basecaller/DeepNano/DeepNanoBasecaller.cpp:28).

* ``greedy_decode`` — argmax / collapse / strip-blank; vectorized numpy
  over a batch (argmax itself comes from the device logits).
* ``beam_search_decode`` — CTC prefix beam search on the host (sequential
  and data-dependent, so deliberately not on-device; it overlaps with the
  next batch's device work in the live pipeline).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ALPHABET", "greedy_decode", "greedy_decode_ids", "beam_search_decode"]

ALPHABET = "NACGT"
_BASES = np.array(list("NACGT"))


def greedy_decode_ids(ids: np.ndarray, length: int | None = None) -> str:
    """Collapse repeats, strip blanks from an argmax id sequence [T]."""
    if length is not None:
        ids = ids[:length]
    if ids.size == 0:
        return ""
    keep = np.ones(ids.shape[0], dtype=bool)
    keep[1:] = ids[1:] != ids[:-1]
    ids = ids[keep]
    ids = ids[ids != 0]
    return "".join(_BASES[ids])


def greedy_decode(logits: np.ndarray, lengths: np.ndarray | None = None) -> list[str]:
    """Batched greedy CTC decode. logits: [B, T, 5] (numpy, from device)."""
    ids = np.argmax(logits, axis=-1)
    out = []
    for b in range(ids.shape[0]):
        n = int(lengths[b]) if lengths is not None else None
        out.append(greedy_decode_ids(ids[b], n))
    return out


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return (x - m) - np.log(e.sum(axis=-1, keepdims=True))


def beam_search_decode(
    logits: np.ndarray,
    beam_size: int = 5,
    beam_cut_threshold: float = 0.01,
    length: int | None = None,
) -> str:
    """CTC prefix beam search for one read. logits: [T, 5].

    Standard prefix beam search (Hannun et al.): beams keyed by the
    emitted prefix, tracking (log p ending in blank, log p ending in
    non-blank); symbols below ``beam_cut_threshold`` probability at a
    step are pruned, matching the Rust decoder's parameters.
    """
    if length is not None:
        logits = logits[:length]
    T = logits.shape[0]
    if T == 0:
        return ""
    logp = _log_softmax(logits.astype(np.float64))
    cut = np.log(beam_cut_threshold) if beam_cut_threshold > 0 else -np.inf

    NEG = -np.inf
    # beams: prefix tuple -> (p_blank, p_nonblank)
    beams: dict[tuple, tuple[float, float]] = {(): (0.0, NEG)}

    def logsumexp2(a: float, b: float) -> float:
        if a == NEG:
            return b
        if b == NEG:
            return a
        m = max(a, b)
        return m + np.log(np.exp(a - m) + np.exp(b - m))

    for t in range(T):
        step = logp[t]
        allowed = [s for s in range(5) if step[s] >= cut]
        new: dict[tuple, tuple[float, float]] = {}

        def add(prefix, pb, pnb):
            opb, opnb = new.get(prefix, (NEG, NEG))
            new[prefix] = (logsumexp2(opb, pb), logsumexp2(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = logsumexp2(pb, pnb)
            for s in allowed:
                p = step[s]
                if s == 0:
                    add(prefix, total + p, NEG)
                    continue
                last = prefix[-1] if prefix else None
                if s == last:
                    # repeat symbol: extend only from blank-ending paths;
                    # staying on the same prefix only from non-blank paths
                    add(prefix, NEG, pnb + p)
                    add(prefix + (s,), NEG, pb + p)
                else:
                    add(prefix + (s,), NEG, total + p)
        # prune to beam_size by total probability
        scored = sorted(
            new.items(), key=lambda kv: logsumexp2(*kv[1]), reverse=True
        )
        beams = dict(scored[:beam_size])

    best = max(beams.items(), key=lambda kv: logsumexp2(*kv[1]))[0]
    return "".join(ALPHABET[s] for s in best)
