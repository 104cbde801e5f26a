"""Step builders: train, prefill and decode.

Counterpart of ``repro.launch.steps``'s ``make_train_step``,
``make_prefill_step`` and ``make_decode_step``.  The train step updates
the parameters and the optimizer state in place (the reference donates
them).  The reference's spec functions (``train_state_specs``,
``input_specs``, ``serve_cfg``, ``step_fn_for``) describe a device mesh and
come with the port's multi-GPU and dry-run slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.profiler import record_function

from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw_update, cosine_schedule
from ..tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "loss_and_grads"]


def loss_and_grads(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
           cfg: ModelConfig):
    """(loss, metrics, grads): the gradients of ``loss_fn`` with respect to
    every leaf, zeros for a leaf the loss does not use (audio's token
    embedding), each in its leaf's dtype.  The leaves are differentiated
    through aliases that share their storage, so ``params`` keeps its
    ``requires_grad`` flags."""
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(alias)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(alias, batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000):
    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, batch, cfg)
        lr = cosine_schedule(opt_state.step, peak_lr=peak_lr,
                             warmup_steps=warmup, total_steps=total_steps)
        with torch.no_grad(), record_function("train.adamw"):
            params, opt_state, om = adamw_update(params, grads, opt_state, lr=lr)
        out_metrics = {"loss": loss, "lr": lr, **metrics, **om}
        return params, opt_state, out_metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            return M.prefill(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, batch, cache, cache_len):
        with torch.no_grad():
            return M.decode_step(params, batch, cache, cache_len, cfg)
    return serve_step
