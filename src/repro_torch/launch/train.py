"""End-to-end training entry point.

Counterpart of ``repro.launch.train``.  It composes the port's substrate:
the streaming data pipeline (Emitter → SPSC ring), the train step (the
flash-attention and SSD kernels forward and backward on the card), async
checkpointing (the Collector thread) and deterministic replay after a
restart.  It runs on the card unless ``device="cpu"`` is given.  With
``mesh=`` (``launch.mesh.make_test_mesh``) it runs the same loop in a
``RankPool`` of ``mesh.size`` rank processes (``transport=`` as the
pool's), each holding its shards of the parameters and the optimizer
state and its rows of every batch (``parallel.context``), and returns the
state gathered to one tree on the caller's device.  Its checkpoints are
the one-device format: rank 0 writes the gathered tree, and a restore
slices it onto every rank, so a checkpoint moves between a mesh run and a
one-device run either way.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --steps 10 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --steps 50 --batch 8 --seq 128 --device cpu --ckpt-dir ckpt
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Any, Callable, Optional

import torch

from ..configs import ARCHS
from ..core import ranks
from ..data import make_batch_stream
from ..kernels.ops import resolve_device
from ..models import init_params
from ..models.model import init_params_spec
from ..optim import AdamWState, adamw_init
from ..parallel import rules
from ..parallel.context import mesh_context, sharded_ctx
from ..runtime.checkpoint import AsyncCheckpointer, latest_step, restore
from ..tree import tree_map
from .steps import make_train_step

__all__ = ["train", "main"]


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: Optional[str],
          ckpt_every: int = 50, seed: int = 0, mesh=None,
          dp_axes=("data",), transport: Optional[str] = None,
          log_every: int = 10, peak_lr: float = 3e-4,
          inject_failure_at: Optional[int] = None, device: Any = None,
          wrap_step: Optional[Callable] = None):
    """Returns (final_state, losses).  Deterministic given (cfg, seed).
    ``state`` is {"params", "opt"}; with ``ckpt_dir`` it resumes from the
    latest checkpoint there and saves every ``ckpt_every`` steps and at
    the end.  ``inject_failure_at``: raise RuntimeError before that step
    (after publishing the checkpoints in flight).  ``wrap_step``: a
    function of the train step that returns the step to call in its place,
    e.g. one that times or profiles each step.

    ``mesh``: a ``launch.mesh`` mesh, ``dp_axes`` its data axes.  A mesh of
    more than one device runs on ``ranks.pool(mesh.size, device=device,
    transport=transport)`` (``wrap_step`` must then pickle); the state
    comes back gathered on the caller's device with rank 0's losses."""
    kw = dict(steps=steps, batch=batch, seq=seq, ckpt_dir=ckpt_dir,
              ckpt_every=ckpt_every, seed=seed, log_every=log_every,
              peak_lr=peak_lr, inject_failure_at=inject_failure_at,
              wrap_step=wrap_step)
    dev = resolve_device(device)
    if mesh is not None and mesh.size > 1:
        pool = ranks.pool(mesh.size, device=device, transport=transport)
        state, losses = pool.run(_rank_train, cfg, mesh, tuple(dp_axes), kw)[0]
        return tree_map(lambda t: t.to(dev), state), losses
    scope = mesh_context(mesh, dp_axes) if mesh is not None \
        else contextlib.nullcontext()
    with scope:
        return _train_loop(cfg, device=dev, **kw)


def _rank_train(rctx, cfg, mesh, dp_axes, kw):
    """``train``'s loop in one rank of the mesh; rank 0 returns the
    gathered state (on the host) and every rank its losses."""
    with mesh_context(mesh, dp_axes):
        state, losses = _train_loop(cfg, device=rctx.device, **kw)
    return (state if rctx.rank == 0 else None), losses


def _state_plan(ctx, cfg):
    """The train state's :class:`~repro_torch.parallel.rules.Sharding`
    tree: the moments sharded as their parameters, the step replicated."""
    pp = rules.param_shardings(ctx, cfg)
    return {"params": pp, "opt": AdamWState(rules.Sharding((), ()), pp, pp)}


def _meta_state(cfg):
    """The full train state's tree on the ``meta`` device: a restore's
    template."""
    params = tree_map(lambda s: torch.empty(s[0], dtype=s[1], device="meta"),
                      init_params_spec(cfg))
    return {"params": params,
            "opt": adamw_init(params, getattr(torch, cfg.optimizer_dtype))}


def _train_loop(cfg, *, steps, batch, seq, ckpt_dir, ckpt_every, seed,
                log_every, peak_lr, inject_failure_at, device, wrap_step):
    dev = device
    ctx = sharded_ctx()
    lead = ctx is None or (ctx.data.rank == 0 and ctx.model.rank == 0)
    step_fn = make_train_step(cfg, peak_lr=peak_lr, total_steps=max(steps, 2))
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)
    params = init_params(cfg, seed, device=dev)
    state = {"params": params,
             "opt": adamw_init(params, getattr(torch, cfg.optimizer_dtype))}
    plan = bplan = None
    if ctx is not None:
        plan = _state_plan(ctx, cfg)
        bplan = rules.batch_shardings(ctx, cfg, batch)
        state = rules.shard_tree(state, plan)
        del params
    start = 0
    ckpt = None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir) if lead else None
        last = latest_step(ckpt_dir)
        if last is not None:
            if ctx is None:
                state = restore(state, ckpt_dir, last)
            else:
                full = restore(_meta_state(cfg), ckpt_dir, last, device="cpu")
                state = tree_map(lambda t: t.to(dev),
                                 rules.shard_tree(full, plan))
            start = last
            if lead:
                print(f"[train] restored step {start} from {ckpt_dir}")

    def save(step_no):
        snap = state if ctx is None else rules.gather_tree(state, plan)
        if ckpt:
            ckpt.save(snap, step_no)

    losses = []
    pipe = make_batch_stream(cfg, batch, seq, seed=seed, start_step=start,
                             n_steps=steps - start)
    t0 = time.time()
    try:
        for step, np_batch in pipe:
            if inject_failure_at is not None and step == inject_failure_at:
                inject_failure_at = None
                raise RuntimeError("injected failure (test)")
            dev_batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
            if ctx is not None:     # this rank's rows
                dev_batch = rules.shard_tree(dev_batch, bplan)
            dev_batch = {k: v.to(dev) for k, v in dev_batch.items()}
            params, opt, metrics = step_fn(state["params"], state["opt"], dev_batch)
            state = {"params": params, "opt": opt}
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % log_every == 0 and lead:
                dt = time.time() - t0
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                save(step + 1)
    finally:
        pipe.close()
        if ckpt:
            ckpt.wait()   # publish in-flight checkpoints even on failure
    if ckpt_dir:
        save(steps)
    if ckpt:
        ckpt.wait()
        ckpt.close()
    if ctx is not None:
        state = tree_map(lambda t: t.cpu(), rules.gather_tree(state, plan))
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
