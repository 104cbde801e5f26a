"""Mesh context: how model code learns about the distribution environment.

Counterpart of ``repro.parallel.context``.  The reference writes the model
once and lets GSPMD partition it from ``shard(...)`` constraints, with a
few ``manual_model`` regions (a ``shard_map``) holding hand-placed
collectives.  Torch has no GSPMD, so the port is SPMD by hand, with
explicit local shards:

* A mesh is a :class:`Mesh` descriptor (axis names and sizes) that a rank
  job (:mod:`repro_torch.core.ranks`) enters with :func:`mesh_context`.
  Its ranks form a (dp, mp) grid from ``RankContext.grid(dp, mp)``: rank
  ``d * mp + m`` is data index d and model index m; the model
  :class:`~repro_torch.core.ranks.Group` is the grid's row and the data
  Group its column.  A ``pod`` axis folds into the data group.
* Every rank holds the local shard of each parameter that
  ``models.model.params_pspecs`` names: a ``"mp"`` dim is split over the
  model group, a ``"dp"`` dim over the data group (ZeRO-3 storage), and
  ``None`` is replicated.  ``parallel.rules.shard_tree`` cuts them and
  ``gather_tree`` puts them back together.
* Activations between blocks are (B_loc, S, d): the rank's data rows,
  replicated over the model group.
* :func:`fsdp_gather` all-gathers a block's ``"dp"`` dims over the data
  group where the block runs; its backward is the reduce (a sum over the
  data group, then this rank's slice), the reference's transpose.
* Each model-parallel region (attention heads, the MLP's d_ff, the
  experts, the vocab) opens with :func:`enter_model`, the identity forward
  and a sum over the model group backward, on every replicated tensor
  whose use there is partial: the normed activations, the routing gates,
  and the weights replicated over the model group that a rank uses in
  part (``wk``/``wv``, whose kv heads a rank picks).  It closes with
  :func:`psum_compat`, a sum forward whose backward is the identity.
  Without the opening operator a rank's gradient of the residual stream
  would miss the other ranks' heads.
* :func:`shard` returns ``x``: the port's tensors already are the local
  shard its tokens name.  :func:`manual_model` returns ``fn``: every region
  is manual in the port.  Both keep the reference's names.
* With no context every function is the one-device path of the model.
  So is a 1×1 mesh, which needs no rank process: :func:`sharded_ctx` is
  None there, and the model takes the one-device path bit for bit.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import dchannel, ranks
from ..core.skeleton import LoweringError
from ..tree import tree_map

__all__ = ["Mesh", "MeshCtx", "mesh_context", "current_ctx", "sharded_ctx",
           "shard", "manual_model", "fsdp_gather", "is_spec_leaf",
           "psum_compat", "enter_model", "pmax", "DP", "MP"]

# spec tokens: "dp" -> the data group, "mp" -> the model group, None -> replicated
DP, MP = "dp", "mp"


def is_spec_leaf(v) -> bool:
    """Leaf predicate for sharding-token trees: None or a PLAIN tuple of
    tokens (NamedTuples, e.g. optimizer states, are containers)."""
    return v is None or (type(v) is tuple)


@dataclass(frozen=True)
class Mesh:
    """A device mesh as the port knows it: axis names and sizes, laid over
    the ranks of a pool in row-major order (the last axis varies
    fastest)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


class _Solo:
    """The group of one rank: what each axis of a 1×1 mesh names in a
    process that is no rank.  Every collective over it is the identity."""
    size, rank, ranks, pg, ctx = 1, 0, (0,), None, None

    def __repr__(self) -> str:
        return "Group(solo)"


@dataclass(frozen=True)
class MeshCtx:
    mesh: Mesh
    dp_axes: Tuple[str, ...]
    model_axis: str
    data: Any           # the data Group (a column of the rank grid)
    model: Any          # the model Group (a row of the rank grid)

    @property
    def dp_size(self) -> int:
        return self.data.size

    @property
    def mp_size(self) -> int:
        return self.model.size

    @property
    def size(self) -> int:
        return self.dp_size * self.mp_size

    def resolve(self, *tokens) -> Tuple[Any, ...]:
        """Translate ("dp", None, "mp") tokens into the Group each dim is
        split over (None: replicated)."""
        out = []
        for t in tokens:
            if t == DP:
                out.append(self.data)
            elif t == MP:
                out.append(self.model)
            elif t is None:
                out.append(None)
            else:
                raise ValueError(f"unknown sharding token {t!r}")
        return tuple(out)


# The active context is process-wide, not per thread: the autograd engine
# runs a CUDA backward (and so the recompute of a checkpointed block, with
# its gathers) on a device thread of its own.
_ACTIVE: list = [None]


def _groups(mesh: Mesh, dp: int, mp: int):
    """(data group, model group) of this process for a (dp, mp) mesh."""
    if mesh.size == 1:
        return _Solo(), _Solo()
    rctx = ranks.current()
    if rctx is None:
        raise LoweringError(
            f"a mesh of {mesh.size} devices {mesh.shape} runs in rank "
            f"processes: enter mesh_context inside a job of a RankPool "
            f"(repro_torch.core.ranks) of {mesh.size} ranks")
    if rctx.world != mesh.size:
        raise LoweringError(f"a mesh of {mesh.size} devices in a pool of "
                            f"{rctx.world} ranks")
    return rctx.grid(dp, mp)


@contextmanager
def mesh_context(mesh: Mesh, dp_axes: Sequence[str] = ("data",),
                 model_axis: str = "model"):
    dp_axes = tuple(dp_axes)
    shape = mesh.shape
    if set(shape) != set(dp_axes) | {model_axis} \
            or mesh.axis_names[-1] != model_axis:
        raise LoweringError(
            f"mesh axes {mesh.axis_names} must be the data axes {dp_axes} "
            f"followed by the model axis {model_axis!r}")
    dp = 1
    for a in dp_axes:
        dp *= shape[a]
    data, model = _groups(mesh, dp, shape[model_axis])
    prev = _ACTIVE[0]
    _ACTIVE[0] = MeshCtx(mesh, dp_axes, model_axis, data, model)
    try:
        yield _ACTIVE[0]
    finally:
        _ACTIVE[0] = prev


def current_ctx() -> Optional[MeshCtx]:
    return _ACTIVE[0]


def sharded_ctx() -> Optional[MeshCtx]:
    """The active context when it spans more than one rank, else None:
    the model's test for its sharded path."""
    ctx = current_ctx()
    return ctx if ctx is not None and ctx.size > 1 else None


def shard(x: Any, *tokens) -> Any:
    """The reference's GSPMD constraint.  The port's tensors already are
    the local shards the tokens name, so it returns ``x``."""
    return x


def manual_model(fn: Callable, in_specs, out_specs) -> Callable:
    """The reference's full-manual ``shard_map`` region.  Every region of
    the port is manual (its collectives are written out), so it returns
    ``fn``."""
    return fn


def _wire_dtype(x: torch.Tensor, group) -> Optional[torch.dtype]:
    """f32 for a 16-bit float reduced over gloo (the reference's CPU
    ``psum_compat`` reduces bf16 in f32 too), else None."""
    if x.dtype in (torch.bfloat16, torch.float16) and group.ctx is not None \
            and group.ctx.transport == "gloo":
        return torch.float32
    return None


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` with no gradient, 16-bit floats reduced in
    f32 over gloo."""
    if group.size == 1:
        return x
    wire = _wire_dtype(x, group)
    if wire is None:
        return dchannel.all_reduce(x, group)
    return dchannel.all_reduce(x.to(wire), group).to(x.dtype)


def psum_compat(x: torch.Tensor, group) -> torch.Tensor:
    """``dchannel.psum`` (a sum forward, the identity backward) over
    ``group``; over gloo a bf16 or f16 tensor is reduced in f32."""
    if group.size == 1:
        return x
    wire = _wire_dtype(x, group)
    if wire is None:
        return dchannel.psum(x, group)
    return dchannel.psum(x.to(wire), group).to(x.dtype)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The max over ``group`` of a value that carries no gradient (a
    stabiliser)."""
    return dchannel.all_reduce(x.detach(), group, dist.ReduceOp.MAX)


class _EnterFn(torch.autograd.Function):
    """The opening operator of a model-parallel region: the identity
    forward, the sum over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


def enter_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as a model-parallel region consumes it: the same values, and a
    gradient summed over ``group`` (each rank's part covers only its own
    heads, experts or vocab rows)."""
    if group.size == 1:
        return x
    return _EnterFn.apply(x, group)


class _GatherFn(torch.autograd.Function):
    """All-gather of one dim over the data group; backward: the sum over
    the group, then this rank's slice (the reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return dchannel.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        full = _sum(grad.contiguous(), ctx.group)
        mine = full.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n)
        return mine.contiguous(), None, None


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    if group.size == 1:
        return x
    return _GatherFn.apply(x, group, dim)


def fsdp_gather(tree: Any, spec_tree: Any) -> Any:
    """Every ``"dp"``-split dim of the parameters in ``tree`` gathered over
    the data group (the explicit ZeRO-3 gather; its backward sums the
    gradient over the group and keeps this rank's slice).  ``tree`` as
    without a context when no sharded context is active."""
    ctx = sharded_ctx()
    if ctx is None:
        return tree

    def leaf(x, toks):
        if toks is None:
            return x
        for dim, t in enumerate(toks):
            if t == DP:
                x = _gather_dim(x, ctx.data, dim)
        return x

    return tree_map(leaf, tree, spec_tree)
