"""DeepNano-blitz weight-file parser.

A copy of readbouncer_tpu/models/weights.py (the port imports nothing of the JAX
package).

The reference ships five GRU nets as text files
(reference: src/weights/rnn{48,56,64,80,96}.txt, consumed through the
prebuilt Rust deepnano2 library's C ABI —
src/basecaller/DeepNano/DeepNano2.h:8-36).  Each file is 52
(dims-line, values-line) pairs:

    [66 x H] [H]                      input projection W, b
    4 x {                             4 stacked GRU layers
        [H x H] [H x H] [H] [H]       z-gate:  Wz, Rz, biz, bhz
        [H x H] [H x H] [H x H] [H x H]   r/n-gates: Wr, Rr, Wn, Rn
        [H] [H] [H] [H]               bir, bhr, bin, bhn
    }
    [H x 5] [5]                       CTC head (blank + ACGT)

The gate grouping (one gate with 2 matrices + 2 biases, then two gates
with 4 matrices + 4 biases) matches the CuDNN/reset_after GRU form; the
z/r/n assignment is our documented interpretation of the (source-less)
prebuilt library — see docs/BASECALLER.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from readbouncer_tpu_torch.errors import WeightsError

__all__ = [
    "GRUWeights",
    "GRULayerWeights",
    "load_deepnano_weights",
    "default_weights_path",
    "save_params_npz",
    "load_params_npz",
    "synth_weights_path",
]


@dataclass
class GRULayerWeights:
    wz: np.ndarray  # [H, H]
    rz: np.ndarray  # [H, H]
    biz: np.ndarray  # [H]
    bhz: np.ndarray  # [H]
    wr: np.ndarray  # [H, H]
    rr: np.ndarray  # [H, H]
    wn: np.ndarray  # [H, H]
    rn: np.ndarray  # [H, H]
    bir: np.ndarray  # [H]
    bhr: np.ndarray  # [H]
    bin_: np.ndarray  # [H]
    bhn: np.ndarray  # [H]


@dataclass
class GRUWeights:
    w_in: np.ndarray  # [66, H]
    b_in: np.ndarray  # [H]
    layers: list[GRULayerWeights]
    w_out: np.ndarray  # [H, 5]
    b_out: np.ndarray  # [5]

    @property
    def hidden(self) -> int:
        return int(self.w_in.shape[1])

    @property
    def input_features(self) -> int:
        return int(self.w_in.shape[0])


def _read_tensors(path: Path) -> list[np.ndarray]:
    tensors = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        dims = [int(x) for x in lines[i].split()]
        vals = np.fromiter(lines[i + 1].split(), dtype=np.float64)
        want = int(np.prod(dims))
        if vals.size != want:
            raise WeightsError(
                f"{path}: tensor {len(tensors)}: expected {want} values for dims {dims}, got {vals.size}"
            )
        tensors.append(vals.reshape(dims).astype(np.float32))
        i += 2
    return tensors


def load_deepnano_weights(path: str | Path, gate_order: str = "zrn") -> GRUWeights:
    """Parse an rnn*.txt net.

    Each layer's 12 tensors come as one standalone gate group
    {W, R, bi, bh} followed by a two-gate group {W, R, W, R, bi, bh, bi,
    bh}.  ``gate_order`` names which GRU gates those groups hold — the
    documented ambiguity of the source-less prebuilt library
    (docs/BASECALLER.md):

    * ``"zrn"`` (default): standalone = update gate z, pair = (r, n),
    * ``"rzn"``: standalone = reset gate r, pair = (z, n).

    Switchable from ``[Basecaller] gate_order`` so a real-signal run can
    disambiguate without a code change.
    """
    if gate_order not in ("zrn", "rzn"):
        raise WeightsError(f"gate_order must be 'zrn' or 'rzn', got {gate_order!r}")
    path = Path(path)
    t = _read_tensors(path)
    if len(t) != 52:
        raise WeightsError(f"{path}: expected 52 tensors, got {len(t)}")
    w_in, b_in = t[0], t[1]
    H = w_in.shape[1]
    layers = []
    idx = 2
    for _ in range(4):
        wa, ra, bia, bha = t[idx : idx + 4]  # standalone gate group
        wb, rb, wn, rn = t[idx + 4 : idx + 8]  # paired group (+ n gate)
        bib, bhb, bin_, bhn = t[idx + 8 : idx + 12]
        for m in (wa, ra, wb, rb, wn, rn):
            assert m.shape == (H, H), m.shape
        if gate_order == "zrn":
            wz, rz, biz, bhz, wr, rr, bir, bhr = wa, ra, bia, bha, wb, rb, bib, bhb
        else:  # "rzn": standalone group is the reset gate
            wr, rr, bir, bhr, wz, rz, biz, bhz = wa, ra, bia, bha, wb, rb, bib, bhb
        layers.append(
            GRULayerWeights(wz, rz, biz, bhz, wr, rr, wn, rn, bir, bhr, bin_, bhn)
        )
        idx += 12
    w_out, b_out = t[idx], t[idx + 1]
    assert w_out.shape == (H, 5), w_out.shape
    return GRUWeights(w_in, b_in, layers, w_out, b_out)


def save_params_npz(params: dict, path: str | Path) -> None:
    """Persist a trained GRU param pytree (models/train.py layout) as npz.

    The layout is the fused-gate form GRUBasecallerModel builds from
    rnn*.txt files (w_in/b_in, per-layer w_zrn/b_zrn/r_zr/b_hzr/rn/bhn,
    w_out/b_out) — the trainer and the file-parsed nets share one forward.
    """
    flat: dict[str, np.ndarray] = {"format": np.array("rbt-gru-params-1")}
    for k in ("w_in", "b_in", "w_out", "b_out"):
        flat[k] = np.asarray(params[k])
    flat["num_layers"] = np.array(len(params["layers"]), dtype=np.int64)
    for i, layer in enumerate(params["layers"]):
        for k, v in layer.items():
            flat[f"layer{i}/{k}"] = np.asarray(v)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_params_npz(path: str | Path) -> dict:
    """Load a save_params_npz file back into the forward's param pytree."""
    with np.load(path, allow_pickle=False) as z:
        fmt = str(z["format"]) if "format" in z else ""
        if fmt != "rbt-gru-params-1":
            raise WeightsError(f"{path}: not a rbt-gru-params-1 file (format={fmt!r})")
        n = int(z["num_layers"])
        return {
            "w_in": np.array(z["w_in"]),
            "b_in": np.array(z["b_in"]),
            "w_out": np.array(z["w_out"]),
            "b_out": np.array(z["b_out"]),
            "layers": [
                {
                    k: np.array(z[f"layer{i}/{k}"])
                    for k in ("w_zrn", "b_zrn", "r_zr", "b_hzr", "rn", "bhn")
                }
                for i in range(n)
            ],
        }


def synth_weights_path(network: str = "synth48", weights_dir: str | Path = "") -> Path:
    """Locate a trained-params npz (scripts/train_basecaller.py output)."""
    candidates = []
    if weights_dir:
        candidates.append(Path(weights_dir) / f"gru_{network}.npz")
    here = Path(__file__).resolve().parent.parent.parent
    candidates.append(here / "data" / f"gru_{network}.npz")
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"gru_{network}.npz not found in any of: {[str(c) for c in candidates]}"
    )


def default_weights_path(network: str = "48", weights_dir: str | Path = "") -> Path:
    """Locate rnn<network>.txt: the explicit dir, then the repo's data/.

    Mirrors the reference's <root>/data/rnn48.txt lookup
    (src/main/adaptive_sampling.hpp:561-572).
    """
    candidates = []
    if weights_dir:
        candidates.append(Path(weights_dir) / f"rnn{network}.txt")
    here = Path(__file__).resolve().parent.parent.parent
    candidates.append(here / "data" / f"rnn{network}.txt")
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"rnn{network}.txt not found in any of: {[str(c) for c in candidates]}"
    )
