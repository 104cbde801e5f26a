"""End-to-end training entry point.

Counterpart of ``repro.launch.train``.  It composes the port's substrate:
the streaming data pipeline (Emitter → SPSC ring), the train step (the
flash-attention and SSD kernels forward and backward on the card), async
checkpointing (the Collector thread) and deterministic replay after a
restart.  It runs on the card unless ``device="cpu"`` is given.  The
reference's ``mesh`` and ``dp_axes`` arguments come with the port's
multi-GPU slice.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --steps 10 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --steps 50 --batch 8 --seq 128 --device cpu --ckpt-dir ckpt
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Optional

import torch

from ..configs import ARCHS
from ..data import make_batch_stream
from ..kernels.ops import resolve_device
from ..models import init_params
from ..optim import adamw_init
from ..runtime.checkpoint import AsyncCheckpointer, latest_step, restore
from .steps import make_train_step

__all__ = ["train", "main"]


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: Optional[str],
          ckpt_every: int = 50, seed: int = 0, log_every: int = 10,
          peak_lr: float = 3e-4, inject_failure_at: Optional[int] = None,
          device: Any = None, wrap_step: Optional[Callable] = None):
    """Returns (final_state, losses).  Deterministic given (cfg, seed).
    ``state`` is {"params", "opt"}; with ``ckpt_dir`` it resumes from the
    latest checkpoint there and saves every ``ckpt_every`` steps and at
    the end.  ``inject_failure_at``: raise RuntimeError before that step
    (after publishing the checkpoints in flight).  ``wrap_step``: a
    function of the train step that returns the step to call in its place,
    e.g. one that times or profiles each step."""
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, peak_lr=peak_lr, total_steps=max(steps, 2))
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)
    params = init_params(cfg, seed, device=dev)
    state = {"params": params,
             "opt": adamw_init(params, getattr(torch, cfg.optimizer_dtype))}
    start = 0
    ckpt = None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir)
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore(state, ckpt_dir, last)
            start = last
            print(f"[train] restored step {start} from {ckpt_dir}")
    losses = []
    pipe = make_batch_stream(cfg, batch, seq, seed=seed, start_step=start,
                             n_steps=steps - start)
    t0 = time.time()
    try:
        for step, np_batch in pipe:
            if inject_failure_at is not None and step == inject_failure_at:
                inject_failure_at = None
                raise RuntimeError("injected failure (test)")
            dev_batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
            params, opt, metrics = step_fn(state["params"], state["opt"], dev_batch)
            state = {"params": params, "opt": opt}
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % log_every == 0:
                dt = time.time() - t0
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(state, step + 1)
    finally:
        pipe.close()
        if ckpt:
            ckpt.wait()   # publish in-flight checkpoints even on failure
    if ckpt:
        ckpt.save(state, steps)
        ckpt.wait()
        ckpt.close()
    return state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = cfg.smoke()
    _, losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir, seed=args.seed, peak_lr=args.lr,
                      device=args.device)
    print(f"[train] done: first loss {losses[0]:.4f} → last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
