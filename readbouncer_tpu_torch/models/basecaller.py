"""Batched basecaller service over the GRU model — the torch counterpart
of readbouncer_tpu/models/basecaller.py.

Keeps the reference's ``Basecaller`` interface shape (abstract
basecall_live_reads, src/basecaller/Basecaller.hpp:21-28).  Signals are
normalised on the host, batched to power-of-two [B, S] f16 buckets, framed
and run through the GRU on the device, and CTC-decoded on the host.

The reference's "short result" handling (basecalled chunks under 250 bp
are parked and concatenated with the read's next chunk,
src/basecaller/DeepNano/DeepNanoBasecaller.cpp:52-97) lives in the live
scheduler (stream/), not here — this class is a pure
signal-batch -> sequences function.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from readbouncer_tpu_torch.device import resolve_device, upload
from readbouncer_tpu_torch.models.ctc import beam_search_decode, greedy_decode_ids
from readbouncer_tpu_torch.models.gru import (
    GRUBasecallerModel,
    frame_signal,
    med_mad_normalize,
    params_from_weights,
)
from readbouncer_tpu_torch.models.weights import (
    default_weights_path,
    load_deepnano_weights,
    load_params_npz,
    synth_weights_path,
)

__all__ = ["Basecaller", "GRUBasecaller"]


class Basecaller:
    """Abstract surface (reference: src/basecaller/Basecaller.hpp:21-28)."""

    def basecall(self, signals: list[np.ndarray]) -> list[str]:
        raise NotImplementedError


@dataclass
class GRUBasecaller(Basecaller):
    network: str = "48"
    weights_dir: str = ""
    frame_stride: int = 5
    max_frames: int = 2048  # T of one batch: frames past it are dropped
    decoder: str = "greedy"  # or "beam"
    beam_size: int = 5
    beam_cut_threshold: float = 0.01
    # rnn*.txt gate-group assignment: "zrn" | "rzn" (weights.py)
    gate_order: str = "zrn"
    device: object = None  # None = the CUDA card (resolve_device)
    # full-channel live ticks (~512 chunks): at >= this many signals the
    # batch goes as two halves, so half 2's host prep rides behind half
    # 1's device forward and half 1's decode behind half 2's
    split_threshold: int = 256

    def __post_init__(self):
        """Resolve the network name to weights.

        ``network`` is either a DeepNano-blitz net id ("48".."96" — the
        rnn<net>.txt files), a trained-params id ("synth48" etc. —
        data/gru_<net>.npz), or an explicit .npz path.
        """
        self.device = resolve_device(self.device)
        if self.network.endswith(".npz"):
            tree = load_params_npz(self.network)
        elif self.network.startswith("synth"):
            tree = load_params_npz(synth_weights_path(self.network, self.weights_dir))
        else:
            tree = params_from_weights(
                load_deepnano_weights(
                    default_weights_path(self.network, self.weights_dir),
                    gate_order=self.gate_order,
                )
            )
        self.model = GRUBasecallerModel(tree, frame_stride=self.frame_stride, device=self.device)

    def frames_for(self, signal: np.ndarray) -> np.ndarray:
        return frame_signal(
            med_mad_normalize(signal),
            window=self.model.window,
            stride=self.frame_stride,
            max_frames=self.max_frames,
        )

    def _warn_truncation(self, signals) -> None:
        w, st = self.model.window, self.frame_stride
        T = self.max_frames
        truncated = sum(1 for s in signals if (max(len(s), w) - w) // st + 1 > T)
        if truncated and not getattr(self, "_warned_truncation", False):
            self._warned_truncation = True
            warnings.warn(
                f"GRUBasecaller: {truncated} signal(s) exceed max_frames="
                f"{T} and lose their tail; raise max_frames for offline "
                "use on full-length reads",
                stacklevel=2,
            )

    def basecall_submit(self, signals: list[np.ndarray]):
        """Start the device forward; returns a handle for basecall_collect.

        Greedy path: uploads the NORMALIZED SIGNAL [B, S] as f16 (not
        frames, 13.2x larger) and leaves uint8 argmax tokens [B, T] on the
        device.  Beam path uploads host frames and leaves the logits.
        The device work runs asynchronously until the handle is collected,
        so the live scheduler can overlap it with other work.
        """
        if not signals:
            return None
        w, st, T = self.model.window, self.frame_stride, self.max_frames
        self._warn_truncation(signals)
        # a power-of-two batch bucket (floor 32): the shapes a live run
        # meets stay few, as in the reference's compiled programs
        B = max(32, 1 << (len(signals) - 1).bit_length())
        dev = self.model.device
        if self.decoder == "beam":
            framed = [self.frames_for(s) for s in signals]
            batch = np.zeros((B, T, w), dtype=np.float32)
            lens = np.zeros(B, dtype=np.int32)
            for i, f in enumerate(framed):
                n = min(f.shape[0], T)
                batch[i, :n] = f[:n]
                lens[i] = n
            return ("beam", self.model.logits(upload(batch, dev)), lens, len(signals))
        batch, lens = self.signal_batch(signals, B)
        tokens = self.model.tokens_from_signal(upload(batch, dev))
        return ("greedy", tokens, lens, len(signals))

    def signal_batch(self, signals: list[np.ndarray], B: int) -> tuple[np.ndarray, np.ndarray]:
        """The greedy path's upload: normalized signals as f16 [B, S] rows,
        S = (max_frames - 1) * stride + window (zero-padded, cut past S),
        and each row's frame count [B] i32."""
        w, st, T = self.model.window, self.frame_stride, self.max_frames
        S = (T - 1) * st + w
        batch = np.zeros((B, S), dtype=np.float16)
        lens = np.zeros(B, dtype=np.int32)
        sizes = {len(s) for s in signals}
        if len(sizes) == 1 and next(iter(sizes)) >= w:
            # uniform-length chunks (the steady live tick): vectorized
            # median/MAD over the whole batch
            sig = np.stack([np.asarray(s, dtype=np.float32) for s in signals])
            med = np.median(sig, axis=1, keepdims=True)
            mad = np.median(np.abs(sig - med), axis=1, keepdims=True) + 1e-6
            L = min(sig.shape[1], S)
            batch[: len(signals), :L] = ((sig[:, :L] - med) / mad).astype(np.float16)
            lens[: len(signals)] = min((L - w) // st + 1, T)
        else:
            for i, s in enumerate(signals):
                norm = med_mad_normalize(s)[:S]
                batch[i, : norm.shape[0]] = norm.astype(np.float16)
                lens[i] = min((max(norm.shape[0], w) - w) // st + 1, T)
        return batch, lens

    def basecall_collect(self, handle) -> list[str]:
        """Fetch (one device-to-host copy) and decode a basecall_submit handle."""
        if handle is None:
            return []
        kind, dev_out, lens, n = handle
        host = dev_out[:n].cpu().numpy()
        if kind == "beam":
            return [
                beam_search_decode(host[i], self.beam_size, self.beam_cut_threshold, int(lens[i]))
                for i in range(n)
            ]
        return [greedy_decode_ids(host[i], int(lens[i])) for i in range(n)]

    def basecall(self, signals: list[np.ndarray]) -> list[str]:
        """Raw current signals -> basecalled sequences (batched)."""
        if len(signals) >= max(2, self.split_threshold):
            mid = len(signals) // 2
            h1 = self.basecall_submit(signals[:mid])
            h2 = self.basecall_submit(signals[mid:])
            return self.basecall_collect(h1) + self.basecall_collect(h2)
        return self.basecall_collect(self.basecall_submit(signals))
