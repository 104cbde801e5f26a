"""AdamW on raw parameter trees (nested dicts of tensors).

Counterpart of ``repro.optim.adamw``, with its arithmetic: moments in
their own dtype (``adamw_init(moment_dtype=)``), the update in f32 and cast
back to each parameter's dtype, decoupled weight decay on leaves of more
than one dimension only, and global-norm clipping before the step.

Where the reference donates its buffers (``donate_argnums``), the port
updates in place: ``adamw_update`` writes the parameters, the moments and
the step counter it is given, and ``clip_by_global_norm`` scales the
gradients it is given.  Both walk a stacked leaf (three or more
dimensions, at least ``SLICE_MIN`` elements an index) one index of its
leading axis at a time, so the f32 temporaries of a step are one layer's,
not the whole stack's: at Phi-3-mini's width one f32 copy of
``blocks/mlp/w_gate`` would be 3.2 GB.  A smaller leaf goes whole: its
temporaries are small, and walking it would cost launches, not memory
(Zamba2's shared attention block is not a stack: its (2560, 32, 80)
projections, walked by their first axis, took 7680 slices and ~4.6 s of
host time a step).  The arithmetic is elementwise, so the walk does not
change it.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple, Tuple, Union

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm"]

Tree = Union[Dict[str, Any], torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Any
    nu: Any


SLICE_MIN = 1 << 20    # elements an index of a leaf walked by layer holds


def _slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``t`` one leading index at a time for a stacked leaf (three
    or more dimensions, at least SLICE_MIN elements an index), else ``t``
    itself."""
    if t.dim() >= 3 and t.numel() // t.shape[0] >= SLICE_MIN:
        yield from t.unbind(0)
    else:
        yield t


def adamw_init(params: Tree, moment_dtype: torch.dtype = torch.float32) -> AdamWState:
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _global_norm(grads: Tree) -> torch.Tensor:
    total = None
    for g in tree_leaves(grads):
        for sl in _slices(g):
            part = torch.sum(torch.square(sl.float()))
            total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm`` (each leaf in f32, cast back to its dtype).  Returns
    (grads, the norm before clipping) as f32 on the leaves' device."""
    gn = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        for sl in _slices(g):
            sl.copy_(sl.float() * scale)
    return grads, gn


def adamw_update(params: Tree, grads: Tree, state: AdamWState, *,
                 lr: Any, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0) -> Tuple[Tree, AdamWState, dict]:
    """One AdamW step, in place on ``params``, ``state`` and ``grads``
    (clipped first).  Returns (params, state, {"grad_norm"}) with the
    same objects, as the reference returns its new ones."""
    grads, gn = clip_by_global_norm(grads, max_grad_norm)
    state.step.add_(1)
    step = state.step.float()
    c1 = 1.0 - torch.pow(b1, step)
    c2 = 1.0 - torch.pow(b2, step)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(state.mu), tree_leaves(state.nu))
    for p, g, mu, nu in leaves:
        # decoupled weight decay: skip 1-D leaves (norm scales, biases)
        wd = weight_decay if p.dim() > 1 else 0.0
        for ps, gs, ms, ns in zip(_slices(p), _slices(g), _slices(mu), _slices(nu)):
            g32 = gs.float()
            mu32 = ms.float() * b1 + g32 * (1 - b1)
            nu32 = ns.float() * b2 + torch.square(g32) * (1 - b2)
            d = (mu32 / c1) / (torch.sqrt(nu32 / c2) + eps)
            p32 = ps.float()
            ps.copy_(p32 - lr * (d + wd * p32))
            ms.copy_(mu32)
            ns.copy_(nu32)
    return params, state, {"grad_norm": gn}
