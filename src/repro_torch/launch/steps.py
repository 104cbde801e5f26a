"""Step builders: train, prefill and decode.

Counterpart of ``repro.launch.steps``'s ``make_train_step``,
``make_prefill_step`` and ``make_decode_step``.  The train step updates
the parameters and the optimizer state in place (the reference donates
them).  Inside a sharded mesh context (``repro_torch.parallel.context``)
the parameters and the optimizer state are this rank's shards and
``loss_and_grads`` returns each leaf's complete local gradient: a leaf
with a ``"dp"`` token comes summed over the data group from the gather's
backward, and every other leaf is summed over the data group here.  The
reference's spec functions (``train_state_specs``, ``input_specs``,
``serve_cfg``, ``step_fn_for``) belong to the dry-run slice (ROADMAP §1
item 12).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.profiler import record_function

from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw_update, cosine_schedule
from ..parallel.context import DP, psum_compat, sharded_ctx
from ..tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "loss_and_grads", "reduce_data_replicated"]


def reduce_data_replicated(grads: Dict[str, Any], specs: Dict[str, Any],
                           group) -> Dict[str, Any]:
    """Each gradient whose leaf has no ``"dp"`` token (replicated over the
    data group, so each rank holds its own rows' part) summed over the
    data ``group``; the others as they are."""
    return tree_map(lambda g, toks: g if toks is not None and DP in toks
                    else psum_compat(g, group), grads, specs)


def loss_and_grads(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
           cfg: ModelConfig):
    """(loss, metrics, grads): the gradients of ``loss_fn`` with respect to
    every leaf, zeros for a leaf the loss does not use (audio's token
    embedding), each in its leaf's dtype; under a sharded mesh context
    each local shard's complete gradient (see the module's docstring).  The leaves are differentiated
    through aliases that share their storage, so ``params`` keeps its
    ``requires_grad`` flags."""
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(alias)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(alias, batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    grads = tree_map(lambda _: next(grads), params)
    ctx = sharded_ctx()
    if ctx is not None:
        with torch.no_grad():
            grads = reduce_data_replicated(
                grads, M.params_pspecs(cfg, ctx.mp_size), ctx.data)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000):
    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, batch, cfg)
        lr = cosine_schedule(opt_state.step, peak_lr=peak_lr,
                             warmup_steps=warmup, total_steps=total_steps)
        ctx = sharded_ctx()
        specs = None if ctx is None else M.params_pspecs(cfg, ctx.mp_size)
        with torch.no_grad(), record_function("train.adamw"):
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 lr=lr, specs=specs)
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
