"""Sharded IBF classification: bins tensor-parallel, reads data-parallel —
the torch counterpart of readbouncer_tpu/parallel/sharded.py.

Where the JAX package annotates one program and lets GSPMD insert the
collectives, this module drives each cell of the mesh itself:

* the bit matrix ``bits[rows, W]`` is cut on its word axis into ``bins``
  contiguous column blocks (the row gather stays local to a block: hash
  rows index axis 0); each process copies to its devices only the blocks
  of the cells it owns;
* a read batch is cut into ``data`` slices; every process passes the
  whole global batch, as every JAX process does;
* each owned (data, bins) cell runs K1 (``counts_planes``) and K2
  (``planes_dual_max``) over its block's words, mask words and its own
  segment table (each filter's segment of the global word split, clipped
  to the block; filters with no word there left out);
* the cells' per-filter maxima merge with a max on the process's first
  device, zeros standing for the cells of other processes (the
  counterpart of GSPMD's reduce over the bins axis); on a mesh that spans
  processes one max all-reduce of the stacked [2, R, F] maxima then
  merges the processes (``distributed.allreduce_max``).

The merge is exact: a filter's maximum over its bins is the max of its
maxima over the blocks, maxima are >= 0, and a block or a process
holding none of its words gives 0.
"""

from __future__ import annotations

import numpy as np
import torch

from readbouncer_tpu_torch.classify.engine import encode_batch
from readbouncer_tpu_torch.classify.fused import live_decisions, plan_stacks
from readbouncer_tpu_torch.classify.math import ci_and_threshold_batch
from readbouncer_tpu_torch.ibf.query import FilterStack, counts_planes
from readbouncer_tpu_torch.ops.ibf_count import planes_dual_max
from readbouncer_tpu_torch.parallel.distributed import allreduce_max
from readbouncer_tpu_torch.parallel.mesh import BINS_AXIS, DATA_AXIS, Mesh
from readbouncer_tpu_torch.stream.scheduler import live_bucket_batches, live_bucket_widths

__all__ = ["ShardedFilterStack", "ShardedLiveClassifier"]


def _tensor(x, dtype: torch.dtype, np_dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(np_dtype)))


class ShardedFilterStack:
    """A FilterStack laid out over a device mesh.

    Requires the stack's word count to divide over the ``bins`` axis and
    the read batch to divide over the ``data`` axis, as the reference
    does.  A mesh may carry only one of the two axes; a missing axis
    means replicated.  On a mesh that spans processes every process must
    build it and make the same calls with the same global batch: each
    call makes one collective.
    """

    def __init__(self, stack: FilterStack, mesh: Mesh):
        self.mesh = mesh
        self.stack = stack
        n_bins_shards = mesh.shape.get(BINS_AXIS, 1)
        if stack.words % max(n_bins_shards, 1) != 0:
            raise ValueError(
                f"stack words ({stack.words}) must divide over the "
                f"'{BINS_AXIS}' axis ({n_bins_shards}); pad filters to "
                f"{32 * n_bins_shards}-bin multiples"
            )
        self.bins_shards = n_bins_shards
        wpb = stack.words // n_bins_shards
        # per bins index: (first word, last word + 1, segment table, the
        # stack's filter index of each segment)
        self.shards = []
        for j in range(n_bins_shards):
            w0, w1 = j * wpb, (j + 1) * wpb
            segs, cols = [], []
            for f, (off, padded) in enumerate(stack.seg_spec):
                a, b = max(off // 32, w0), min((off + padded) // 32, w1)
                if a < b:
                    segs.append(((a - w0) * 32, (b - a) * 32))
                    cols.append(f)
            self.shards.append((w0, w1, tuple(segs), cols))
        # the cells this process owns, each one's block on its device;
        # owned cells on one device share a copy
        self.cells = [
            (i, j) for i in range(self.data_shards) for j in range(n_bins_shards)
            if mesh.owns(**{DATA_AXIS: i, BINS_AXIS: j})
        ]
        self.home = self.device(*self.cells[0])
        self._blocks: dict[tuple[str, int], tuple[torch.Tensor, torch.Tensor]] = {}
        for i, j in self.cells:
            w0, w1 = self.shards[j][:2]
            dev = self.device(i, j)
            if (str(dev), j) not in self._blocks:
                self._blocks[(str(dev), j)] = (
                    stack.bits[:, w0:w1].contiguous().to(dev),
                    stack.mask_words[w0:w1].contiguous().to(dev),
                )

    @property
    def data_shards(self) -> int:
        return self.mesh.shape.get(DATA_AXIS, 1)

    def device(self, i: int, j: int) -> torch.device:
        """The device of data slice ``i`` and word block ``j``."""
        return self.mesh.device_at(**{DATA_AXIS: i, BINS_AXIS: j})

    @property
    def bits_bytes(self) -> int:
        """Bytes of filter bits this process holds on its devices."""
        return sum(bits.numel() * bits.element_size() for bits, _ in self._blocks.values())

    def max_counts_dual(
        self,
        reads,  # u8 [R, L] codes
        lengths,  # [R]
        thr_base,  # [R] thresholds, values in [0, 65535]
        thr_retry,  # [R]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-filter max matched counts at both thresholds, int32 [R, F]
        x2, on this process's first device of the mesh.  R must be a
        multiple of the data axis size.  Every process gets all R rows,
        where JAX gives each process its addressable rows: all of them on
        a bins-only mesh."""
        R = reads.shape[0]
        if R % self.data_shards != 0:
            raise ValueError(
                f"batch {R} must divide over '{DATA_AXIS}' axis ({self.data_shards})"
            )
        reads = _tensor(reads, torch.uint8, np.uint8)
        lengths = _tensor(lengths, torch.int64, np.int64)
        thr_base = _tensor(thr_base, torch.int32, np.int32)
        thr_retry = _tensor(thr_retry, torch.int32, np.int32)
        st = self.stack
        S = R // self.data_shards
        out = torch.zeros((2, R, st.num_filters), dtype=torch.int32, device=self.home)
        for i, j in self.cells:
            sl = slice(i * S, (i + 1) * S)
            _, _, segs, cols = self.shards[j]
            dev = self.device(i, j)
            bits, mask = self._blocks[(str(dev), j)]
            planes = counts_planes(
                bits, reads[sl].to(dev), lengths[sl].to(dev),
                k=st.kmer_size, h=st.hash_functions, rows=st.rows, scheme=st.scheme,
            )
            mb, mr = planes_dual_max(
                planes, thr_base[sl].to(dev).contiguous(), thr_retry[sl].to(dev).contiguous(),
                mask, segs,
            )
            cell = torch.stack([mb, mr]).to(self.home)
            out[:, sl, cols] = torch.maximum(out[:, sl, cols], cell)
        if self.mesh.spans_processes:
            out = allreduce_max(out)
        return out[0], out[1]


class ShardedLiveClassifier:
    """Live check_unblock over a bins-TP x data-DP device mesh.

    Drop-in for ``stream.scheduler.LiveClassifier``: the same ``decide``
    surface, the same length buckets and batches, the same decisions.
    The counts and both thresholds run through :class:`ShardedFilterStack`;
    the decisions are taken on this process's first device of the mesh
    and fetched in one copy per call.  Over a mesh that spans processes
    every process decides the same sequences.  Selected by ``[TPU] mesh_shape`` in target mode
    (main.run_target).
    """

    def __init__(self, target_filters, deplete_filters, cfg, mesh: Mesh):
        if not target_filters and not deplete_filters:
            raise ValueError("live classification needs at least one filter")
        self.cfg = cfg
        # host stacks: each block is copied from here to its device
        t_stack = FilterStack(target_filters, "cpu") if target_filters else None
        d_stack = FilterStack(deplete_filters, "cpu") if deplete_filters else None
        combined, n_targets = plan_stacks(t_stack, d_stack)
        self.n_targets = n_targets
        if combined is not None:
            self._stacks = [("td", ShardedFilterStack(combined, mesh), combined)]
        else:
            self._stacks = [
                (kind, ShardedFilterStack(s, mesh), s)
                for kind, s in (("t", t_stack), ("d", d_stack))
                if s is not None
            ]
        widths = live_bucket_widths(cfg)
        self.short_len = widths[0]
        self.bucket_lens = widths
        self._batch = live_bucket_batches(cfg, widths)
        # the reference raises here for a derived batch that does not
        # divide over the data axis (ADVICE r5); mirrored for parity
        shards = self._stacks[0][1].data_shards
        for w, b in self._batch.items():
            if b % shards:
                raise ValueError(
                    f"bucket batch {b} (width {w}) must divide over the "
                    f"data axis ({shards})"
                )

    def _decisions(self, enc, lens) -> torch.Tensor:
        """int32 decisions of one encoded batch, on the mesh's first device."""
        t_b = t_r = d_b = d_r = None
        for kind, sharded, stack in self._stacks:
            thr_b = ci_and_threshold_batch(
                lens, stack.kmer_size, self.cfg.error_rate, self.cfg.significance
            )
            thr_r = ci_and_threshold_batch(
                lens, stack.kmer_size, self.cfg.error_rate - 0.02, self.cfg.significance
            )
            mb, mr = sharded.max_counts_dual(enc, lens, thr_b, thr_r)
            if kind == "td":
                nt = self.n_targets
                t_b, d_b = mb[:, :nt], mb[:, nt:]
                t_r, d_r = mr[:, :nt], mr[:, nt:]
            elif kind == "t":
                t_b, t_r = mb, mr
            else:
                d_b, d_r = mb, mr
        return live_decisions(d_b, t_b, d_r, t_r)

    def decide(self, seqs: list[str]) -> np.ndarray:
        """Batched decisions: 0 continue / 1 unblock / 2 stop_receiving."""
        if not seqs:
            return np.zeros(0, dtype=np.int64)
        out = np.zeros(len(seqs), dtype=np.int64)
        lens_all = np.array([len(s) for s in seqs])
        parts = []
        lo = -1  # first bucket includes empty sequences
        for w in self.bucket_lens:
            hi = w if w != self.bucket_lens[-1] else np.inf
            idx = np.nonzero((lens_all > lo) & (lens_all <= hi))[0]
            lo = w
            B = self._batch[w]
            for start in range(0, len(idx), B):
                part_idx = idx[start : start + B]
                enc, lens = encode_batch([seqs[j][:w] for j in part_idx], w, batch=B)
                parts.append((part_idx, self._decisions(enc, lens)[: len(part_idx)]))
        fetched = torch.cat([d for _, d in parts]).cpu().numpy()
        out[np.concatenate([i for i, _ in parts])] = fetched
        return out
