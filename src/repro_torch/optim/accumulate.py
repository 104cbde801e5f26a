"""Gradient accumulation with a single deferred reduction.

Counterpart of ``repro.optim.accumulate``: the microbatches stream through
a loop (the reference's ``lax.scan``), each one's gradients are added in
f32, and the mean is taken once at the end.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ..tree import tree_map

__all__ = ["accumulate_grads"]


def accumulate_grads(loss_grad_fn: Callable, params: Any,
                     micro_batches: Any) -> Tuple[torch.Tensor, Any, Any]:
    """loss_grad_fn(params, batch) -> ((loss, metrics), grads).

    micro_batches: a dict of tensors with a leading n_micro axis on every
    leaf.  Returns (mean loss, metrics of the last microbatch, mean grads
    in f32)."""
    n = next(iter(micro_batches.values())).shape[0]
    loss_sum, g_sum, metrics = None, None, None
    for i in range(n):
        mb = {k: v[i] for k, v in micro_batches.items()}
        (loss, metrics), grads = loss_grad_fn(params, mb)
        if g_sum is None:
            loss_sum = torch.zeros((), dtype=torch.float32, device=loss.device)
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        loss_sum = loss_sum + loss
        g_sum = tree_map(lambda a, g: a.add_(g.float()), g_sum, grads)
    inv = 1.0 / n
    return loss_sum * inv, metrics, tree_map(lambda g: g * inv, g_sum)
