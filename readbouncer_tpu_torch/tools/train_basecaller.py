"""Train the GRU basecaller on the synthetic pore model.

Counterpart of scripts/train_basecaller.py, with the same flags, data,
schedule and evaluation: rnn48-shaped params (66 -> 48, 4 GRU layers,
CTC head) trained on synthetic (signal, sequence) pairs with the exact
featurization of ``models.basecaller.GRUBasecaller`` (median/MAD
normalize, window 66, stride 5); every 200 steps (and at the last) the
read identity is measured on fresh reads of the clean and the jittered
pore model, and the params are saved to ``--out`` whenever it improves.

    python -m readbouncer_tpu_torch.tools.train_basecaller --out params.npz [--steps N] [--device cpu]

The optimizer is the reference's ``optax.chain(clip_by_global_norm(1.0),
adam(cosine_decay_schedule(lr, steps, alpha=0.05)))``:
``clip_grad_norm_`` + ``torch.optim.Adam`` + a ``LambdaLR`` giving
optax's cosine decay.  ``--out`` is required: the tracked
``data/gru_synth48.npz`` is never written by default.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from readbouncer_tpu_torch.device import resolve_device
from readbouncer_tpu_torch.models.ctc import greedy_decode
from readbouncer_tpu_torch.models.eval import batch_identity
from readbouncer_tpu_torch.models.gru import frame_signal, gru_logits, med_mad_normalize
from readbouncer_tpu_torch.models.train import (
    cosine_decay,
    host_params,
    init_gru_params,
    make_train_step,
    param_tree,
)
from readbouncer_tpu_torch.models.weights import load_params_npz, save_params_npz
from readbouncer_tpu_torch.stream.replay import sequence_to_signal
from readbouncer_tpu_torch.tools._bench_util import device_name, sync

__all__ = ["make_batch", "evaluate", "main"]

WINDOW = 66
STRIDE = 5
SAMPLES_PER_BASE = 9
NOISE = 2.0
EVAL_EVERY = 200


def make_batch(
    rng: np.random.Generator,
    batch: int,
    bases: int,
    jitter: int = 0,
    drift: float = 0.0,
    noise: float = NOISE,
):
    """(frames, frame_lens, labels, label_lens, seqs) at fixed shapes;
    t_max fits the longest possible jittered read, so frames never
    truncate."""
    t_max = (bases * (SAMPLES_PER_BASE + jitter) - WINDOW) // STRIDE + 1
    frames = np.zeros((batch, t_max, WINDOW), dtype=np.float32)
    frame_lens = np.zeros(batch, dtype=np.int32)
    labels = np.zeros((batch, bases), dtype=np.int32)
    label_lens = np.zeros(batch, dtype=np.int32)
    seqs = []
    for i in range(batch):
        n = int(rng.integers(bases // 2, bases + 1))
        ids = rng.integers(0, 4, n)
        seq = "".join("ACGT"[j] for j in ids)
        sig = sequence_to_signal(seq, SAMPLES_PER_BASE, noise, rng, dwell_jitter=jitter, drift=drift)
        f = frame_signal(med_mad_normalize(sig), WINDOW, STRIDE, max_frames=t_max)
        frames[i, : f.shape[0]] = f
        frame_lens[i] = f.shape[0]
        labels[i, :n] = ids + 1  # CTC ids: blank=0, ACGT=1..4
        label_lens[i] = n
        seqs.append(seq)
    return frames, frame_lens, labels, label_lens, seqs


@torch.no_grad()
def evaluate(params, rng, batch=32, bases=360, jitter=0, drift=0.0, noise=NOISE):
    """(identity, first call's first 60 bases, its truth's) on a fresh
    batch; the forward serves through K3 on the card."""
    frames, frame_lens, _, _, seqs = make_batch(rng, batch, bases, jitter=jitter, drift=drift, noise=noise)
    dev = params["w_in"].device
    logits = gru_logits(params, torch.from_numpy(frames).to(dev), kernel=True).cpu().numpy()
    calls = greedy_decode(logits, frame_lens)
    return batch_identity(seqs, calls), calls[0][:60], seqs[0][:60]


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--bases", type=int, default=160)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--target", type=float, default=0.97)
    ap.add_argument("--jitter", type=int, default=0, help="dwell-time jitter +-samples/base during training")
    ap.add_argument("--drift", type=float, default=0.0, help="baseline random-walk sigma (pA/sample)")
    ap.add_argument("--noise", type=float, default=NOISE)
    ap.add_argument("--init", default="", help="warm-start from an existing params .npz (fine-tune)")
    ap.add_argument("--out", required=True, help="where to save the best params (.npz)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs there)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(1234)
    if args.init:
        params = param_tree(load_params_npz(args.init), dev)
        print(f"fine-tuning from {args.init}", flush=True)
    else:
        params = param_tree(host_params(init_gru_params(torch.Generator().manual_seed(0))), dev)
    step_fn = make_train_step(lambda leaves: torch.optim.Adam(leaves, lr=args.lr), max_grad_norm=1.0)
    opt = step_fn.init(params)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(args.steps, alpha=0.05))
    print(f"training: steps={args.steps} batch={args.batch} bases={args.bases} device={device_name(dev)}",
          flush=True)
    t0 = time.time()
    best = 0.0
    step_s = []
    for step in range(1, args.steps + 1):
        batch = make_batch(rng, args.batch, args.bases, jitter=args.jitter, drift=args.drift,
                           noise=args.noise)[:4]
        t1 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, batch)
        sched.step()
        loss = float(loss)
        sync(dev)
        step_s.append(time.perf_counter() - t1)
        if step % EVAL_EVERY == 0 or step == args.steps:
            # score on both the clean and the hardened pore model: the
            # saved net must stay >= target on each
            ident_c, call0, true0 = evaluate(params, np.random.default_rng(999))
            ident_j, _, _ = evaluate(params, np.random.default_rng(998), jitter=max(args.jitter, 2),
                                     drift=max(args.drift, 0.05), noise=args.noise)
            ident = min(ident_c, ident_j) if args.jitter else ident_c
            print(f"step {step}: loss={loss:.4f} eval_identity=clean {ident_c:.4f} / jittered "
                  f"{ident_j:.4f} ({time.time() - t0:.0f}s; {1e3 * float(np.median(step_s)):.1f} ms "
                  f"per step on {device_name(dev)})", flush=True)
            print(f"  true: {true0}\n  call: {call0}", flush=True)
            if ident > best:
                best = ident
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                save_params_npz(host_params(params), args.out)
            if ident >= args.target:
                print(f"target {args.target} reached; saved {args.out}", flush=True)
                break
    print(f"done: best identity {best:.4f} -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
