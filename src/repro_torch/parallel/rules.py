"""Sharding rule sets: the model's, cache's and batch's spec-token trees
as per-leaf plans for a mesh context.

Counterpart of ``repro.parallel.rules``.  The token trees come from
``models/model.py`` (kept beside init, so the structures cannot drift).
Where the reference translates a token tree into ``NamedSharding``s for
GSPMD, the port's "sharding" of a leaf is a :class:`Sharding`: which dim
is split over which :class:`~repro_torch.core.ranks.Group`, so this
rank's slice of a full tensor (:meth:`Sharding.shard`) and the full
tensor of the local slices (:meth:`Sharding.gather`, a collective).
:func:`shard_tree` and :func:`gather_tree` apply a plan to a tree: with
``convert.params_from_numpy`` they carry the reference's parameters onto
the ranks and the local gradients back.

A decode cache is laid out by the model, not by its token tree
(``models.model``'s docstring): :func:`gather_cache` puts the ranks' local
caches together.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ..core import dchannel
from ..tree import tree_map
from .context import MeshCtx

__all__ = ["Sharding", "to_shardings", "param_shardings", "cache_shardings",
           "batch_shardings", "shard_tree", "gather_tree", "gather_cache"]


@dataclass(frozen=True)
class Sharding:
    """One leaf's plan: its tokens and, per dim, the Group the dim is split
    over (None: whole on every rank)."""
    tokens: Tuple[Any, ...]
    groups: Tuple[Any, ...]

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full ``t``, as a tensor of its own."""
        for dim, g in enumerate(self.groups):
            if g is None or g.size == 1:
                continue
            n = t.shape[dim]
            if n % g.size:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} "
                                 f"({self.tokens}) does not divide over "
                                 f"{g.size} ranks")
            t = t.narrow(dim, g.rank * (n // g.size), n // g.size)
        return t.clone(memory_format=torch.contiguous_format)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of every rank's slice ``t`` (all ranks call it)."""
        with torch.no_grad():
            for dim, g in enumerate(self.groups):
                if g is not None and g.size > 1:
                    t = dchannel.all_gather(t.contiguous(), g, dim)
        return t


def to_shardings(ctx: MeshCtx, token_tree: Any):
    return tree_map(lambda toks: Sharding(toks or (), ctx.resolve(*(toks or ()))),
                    token_tree)


def param_shardings(ctx: MeshCtx, cfg):
    from ..models import model as _model
    return to_shardings(ctx, _model.params_pspecs(cfg, ctx.mp_size))


def cache_shardings(ctx: MeshCtx, cfg, batch: int):
    from ..models import model as _model
    dp_div = batch % ctx.dp_size == 0
    return to_shardings(ctx, _model.cache_pspecs(cfg, batch, dp_div))


def batch_shardings(ctx: MeshCtx, cfg, batch: int):
    from ..models import model as _model
    return to_shardings(ctx, _model.batch_pspecs(cfg, batch, ctx.dp_size))


def shard_tree(full: Any, plan: Any) -> Any:
    """Each leaf of ``full`` cut to this rank's slice by ``plan`` (a tree
    of :class:`Sharding` over the same keys)."""
    return tree_map(lambda t, s: s.shard(t), full, plan)


def gather_tree(local: Any, plan: Any) -> Any:
    """The full tree of every rank's ``local`` (a collective: every rank of
    the mesh calls it, in the same order)."""
    return tree_map(lambda t, s: s.gather(t), local, plan)


#: dims of one layer's cache leaf, after its leading stack dims: k/v
#: (B, T, kv, hd), h (B, H, P, N), conv (B, K, C)
_CACHE_DIMS = {"k": 4, "v": 4, "h": 4, "conv": 3}


def _cache_axes(key: str, t: torch.Tensor):
    """(batch dim, kv-head dim or None) of a cache leaf."""
    lead = t.dim() - _CACHE_DIMS[key]
    return lead, (lead + 2 if key in ("k", "v") else None)


def gather_cache(cfg, cache: Any, ctx: MeshCtx, batch: int) -> Any:
    """The full cache of every rank's local ``cache`` (a collective): rows
    gathered over the data group, kv heads over the model group, one copy
    of a kv head that several model ranks hold."""
    from ..models import model as _model
    out = {}
    with torch.no_grad():
        for key, t in cache.items():
            bd, kd = _cache_axes(key, t)
            if batch % ctx.dp_size == 0 and ctx.dp_size > 1:
                t = dchannel.all_gather(t.contiguous(), ctx.data, bd)
            if kd is not None and ctx.mp_size > 1:
                n_loc = t.shape[kd]
                parts = dchannel.all_gather(t.contiguous(), ctx.model, kd)
                keep, seen = [], set()
                for m in range(ctx.mp_size):
                    first = _model._local_heads(cfg, ctx.mp_size, m)[1].start
                    if first not in seen:
                        seen.add(first)
                        keep.extend(range(m * n_loc, (m + 1) * n_loc))
                t = parts.index_select(kd, torch.tensor(keep, device=t.device))
            out[key] = t
    return out
