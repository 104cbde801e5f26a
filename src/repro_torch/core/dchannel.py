"""Device-level SPSC channels — the paper's queues, re-materialised
between rank processes.

On a cache-coherent multi-core the fence-free SPSC queue works because
producer and consumer each own one index.  Between devices the analogous
asymmetric primitive is a point-to-point send: every ``(src, dst)`` edge
has exactly one producer and one consumer, and it is *not* a barrier over
the group the way an all-reduce or all-gather is.  The FastFlow
translation table:

    memory fence / atomic op   →  collective over the group (all-*)
    SPSC ring slot             →  a block sent point to point, double-buffered
    queue capacity             →  number of blocks in flight

The port's copy of ``repro.core.dchannel``.  The reference calls these
inside ``shard_map`` with an ``axis_name``; here they run inside a rank
job (:mod:`.ranks`) and take the :class:`~repro_torch.core.ranks.Group`
that the axis names.  Each works on a tensor or on a tree of tensors
(dicts, NamedTuples, tuples and lists).  Every hop is posted as one ``dist.batch_isend_irecv`` — the
sends and receives of a hop together, since blocking sends around a ring
deadlock — and each leaf of a tree travels under its own tag.  Over gloo
on a CUDA device each block goes through the host (counted in the
group's ``ctx.staged``).

:func:`ring_send` and :func:`chain_send` carry a gradient: their backward
sends the cotangent the other way round, as the transpose of the
reference's ``ppermute`` does.  :func:`double_buffered_ring` posts hop
k+1's send before hop k's body and carries none.  :func:`psum` is the
reference's ``lax.psum``, and ``_pipeline`` the tensor body of
:func:`repro_torch.core.dpipeline.pipeline_apply`.  :func:`all_reduce`
(``lax.psum``/``pmax`` with no gradient) and :func:`all_gather`
(``lax.all_gather(tiled=True)``) are the plain collectives the sharded
model and the optimizer build on.

:func:`tally` counts the collectives a block of code issues, by the
reference's five kinds (:data:`COLLECTIVES`), whichever module issued
them: a dispatch mode over torch's ``c10d`` operators.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from .ranks import Group

__all__ = ["ring_send", "ring_post", "chain_send", "reverse_chain_send",
           "RingChannel", "double_buffered_ring", "psum", "all_reduce",
           "all_gather", "COLLECTIVES", "Tally", "tally"]

PyTree = Any


def _leaves(x: PyTree) -> List[torch.Tensor]:
    """The tensors of a tree (dicts, NamedTuples, tuples, lists), in order."""
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _rebuild(x: PyTree, leaves) -> PyTree:
    """``x`` with its leaves taken in order from the iterator ``leaves``."""
    if isinstance(x, dict):
        return {k: _rebuild(v, leaves) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(_rebuild(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, leaves) for v in x)
    return next(leaves)


class _Hop:
    """One posted hop: the sends and receives of every leaf, in flight."""

    def __init__(self, leaves: List[torch.Tensor], group: Group,
                 dst: Optional[int], src: Optional[int]):
        ctx = group.ctx
        self.leaves = leaves
        self.ctx = ctx
        self.wire = [ctx.to_wire(t) for t in leaves] if dst is not None \
            else []
        self.recv = [ctx.recv_buffer(t) for t in leaves] if src is not None \
            else []
        ops = [dist.P2POp(dist.isend, w, group.ranks[dst], group.pg, tag=i)
               for i, w in enumerate(self.wire)]
        ops += [dist.P2POp(dist.irecv, r, group.ranks[src], group.pg, tag=i)
                for i, r in enumerate(self.recv)]
        if leaves and leaves[0].device.type == "meta":
            # a simulated rank (``ranks.simulated``): its process group
            # has no coalescing backend for meta tensors, so the ops go
            # one by one
            self.reqs = [op.op(op.tensor, op.peer, op.group, op.tag)
                         for op in ops]
        else:
            self.reqs = dist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> List[torch.Tensor]:
        """The received leaves on their devices; zeros where no edge
        arrives."""
        for req in self.reqs:
            req.wait()
        if not self.recv:
            return [torch.zeros_like(t) for t in self.leaves]
        return [self.ctx.from_wire(r, t.device)
                for r, t in zip(self.recv, self.leaves)]


def _edges(group: Group, displacement: int, wrap: bool
           ) -> Tuple[Optional[int], Optional[int]]:
    """This rank's (destination, source) for a permutation i -> i + d."""
    n, i = group.size, group.rank
    if wrap:
        return (i + displacement) % n, (i - displacement) % n
    dst, src = i + displacement, i - displacement
    return (dst if 0 <= dst < n else None), (src if 0 <= src < n else None)


def _post(x: PyTree, group: Group, displacement: int, wrap: bool) -> _Hop:
    dst, src = _edges(group, displacement, wrap)
    return _Hop(_leaves(x), group, dst, src)


def _permute(leaves: List[torch.Tensor], group: Group, displacement: int,
             wrap: bool) -> List[torch.Tensor]:
    if wrap and displacement % group.size == 0:
        return list(leaves)           # every edge is a self-edge
    dst, src = _edges(group, displacement, wrap)
    return _Hop(leaves, group, dst, src).wait()


def ring_post(x: PyTree, group: Group,
              displacement: int = 1) -> Callable[[], PyTree]:
    """Post :func:`ring_send` of ``x`` without waiting for it: returns the
    function that waits and gives the tree that arrived.  The step of
    :func:`double_buffered_ring`, for a loop that carries more than the
    circulating block (ring attention's backward sends its gradient
    accumulators after each hop's body).  No gradient."""
    if displacement % group.size == 0:
        return lambda: x              # every edge is a self-edge
    hop = _post(x, group, displacement, True)
    return lambda: _rebuild(x, iter(hop.wait()))


class _SendFn(torch.autograd.Function):
    """One hop of one tensor; the backward sends the cotangent back."""

    @staticmethod
    def forward(ctx, t, group, displacement, wrap):
        ctx.group, ctx.displacement, ctx.wrap = group, displacement, wrap
        return _permute([t], group, displacement, wrap)[0]

    @staticmethod
    def backward(ctx, grad):
        back = _permute([grad], ctx.group, -ctx.displacement, ctx.wrap)[0]
        return back, None, None, None


def _send(x: PyTree, group: Group, displacement: int, wrap: bool) -> PyTree:
    leaves = _leaves(x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        moved = [_SendFn.apply(t, group, displacement, wrap) for t in leaves]
    else:
        moved = _permute(leaves, group, displacement, wrap)
    return _rebuild(x, iter(moved))


def ring_send(x: PyTree, group: Group, displacement: int = 1) -> PyTree:
    """SPSC send around a ring: rank i -> rank (i + displacement) mod n.

    Single producer / single consumer per edge; no barrier semantics."""
    return _send(x, group, displacement, True)


def chain_send(x: PyTree, group: Group, displacement: int = 1) -> PyTree:
    """Non-wrapping SPSC send (pipeline edge): i -> i + displacement.

    Ranks with no inbound edge receive zeros (an empty slot)."""
    return _send(x, group, displacement, False)


def reverse_chain_send(x: PyTree, group: Group) -> PyTree:
    """Backward pipeline edge: i -> i-1 (for gradients / feedback)."""
    return chain_send(x, group, displacement=-1)


class RingChannel:
    """A cyclic SPSC channel of given capacity over a group.

    ``capacity`` slots circulate; ``step`` rotates all of them by one hop
    and hands the arriving slot to the caller.  With capacity 2 a hop can
    hide behind one compute step (double buffering); larger capacities
    trade memory for more overlap slack — the queue-capacity trade-off of
    the paper, in functional clothing."""

    def __init__(self, group: Group, capacity: int = 2, displacement: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be at least 1, got {capacity}")
        self.group = group
        self.capacity = capacity
        self.displacement = displacement

    def init(self, slot: PyTree) -> Tuple[PyTree, ...]:
        """Fill all slots with this rank's initial block."""
        return tuple(slot for _ in range(self.capacity))

    def step(self, slots: Tuple[PyTree, ...], outgoing: PyTree
             ) -> Tuple[PyTree, Tuple[PyTree, ...]]:
        """Send ``outgoing``; return (arrived, new_slots).

        ``arrived`` is the block produced ``capacity`` hops ago by the
        neighbour — a pop from the SPSC ring."""
        arrived = slots[0]
        moved = ring_send(outgoing, self.group, self.displacement)
        return arrived, slots[1:] + (moved,)


def double_buffered_ring(
    body: Callable[[int, PyTree, PyTree], Tuple[PyTree, Any]],
    x0: PyTree,
    carry0: PyTree,
    group: Group,
    *,
    hops: Optional[int] = None,
) -> PyTree:
    """Run ``hops`` steps of compute-overlapped ring circulation.

    Each step ``carry, _ = body(hop, carry, block)`` runs on the resident
    block while the *next* block is already in flight: hop k+1's send is
    posted before hop k's body and waited for after it (the last hop
    posts none).  This is the schedule of ring attention.  No gradient
    flows through the posted hops: the inputs must not require one."""
    n = group.size
    hops = n if hops is None else hops
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in _leaves(x0)):
        raise NotImplementedError(
            "double_buffered_ring carries no gradient; run it under "
            "torch.no_grad() or detach the circulating blocks")
    carry, block = carry0, x0
    for hop in range(hops):
        pending = None
        if hop + 1 < hops and n > 1:
            pending = _post(block, group, 1, True)
        carry, _ = body(hop, carry, block)
        if pending is not None:
            block = _rebuild(block, iter(pending.wait()))
    return carry


class _PsumFn(torch.autograd.Function):
    """A sum over the group whose result every rank holds.  Its backward
    passes the cotangent through: the result is one replicated value, so
    its cotangent is that of the one loss built on it (the transpose of
    the reference's ``psum`` into an unmapped ``shard_map`` output)."""

    @staticmethod
    def forward(ctx, t, group):
        gctx = group.ctx
        wire = gctx.to_wire(t)
        if wire is t:
            wire = t.clone()
        dist.all_reduce(wire, group=group.pg)
        return gctx.from_wire(wire, t.device)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over the group (``lax.psum``), on every rank."""
    if group.size == 1:
        return t
    return _PsumFn.apply(t, group)


def all_reduce(t: torch.Tensor, group: Group,
               op: Any = dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced by ``op`` over the group, as a new tensor on ``t``'s
    device (staged through the host where the transport needs it).  No
    gradient: the sharded model's operators wrap it."""
    if group.size == 1:
        return t
    gctx = group.ctx
    wire = gctx.to_wire(t)
    if wire is t:
        wire = t.clone()
    dist.all_reduce(wire, op=op, group=group.pg)
    return gctx.from_wire(wire, t.device)


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The members' ``t`` concatenated along ``dim`` in group order (the
    reference's tiled ``all_gather``).  No gradient."""
    if group.size == 1:
        return t
    gctx = group.ctx
    wire = gctx.to_wire(t)
    parts = [gctx.recv_buffer(wire) for _ in range(group.size)]
    dist.all_gather(parts, wire, group=group.pg)
    return gctx.from_wire(torch.cat(parts, dim=dim), t.device)


def _pipeline(stage_fn: Callable, stage_params: Any,
              microbatches: torch.Tensor, group: Group,
              collect: str) -> torch.Tensor:
    """The tick loop of ``pipeline_apply``: at tick t, stage s processes
    microbatch t - s and pushes it down its outbound edge."""
    n, stage = group.size, group.rank
    m = microbatches.shape[0]
    keep_graph = torch.is_grad_enabled()
    first = torch.tensor(stage == 0, device=microbatches.device)
    inbound = torch.zeros_like(microbatches[0])
    emitted = []
    for t in range(m + n - 1):
        # stage 0's "queue" is the input stream itself; a where, not a
        # branch, so every stage's inbound edge stays in the graph and
        # every edge's backward runs on both of its ranks
        x = torch.where(first, microbatches[min(t, m - 1)], inbound)
        active = stage <= t < stage + m
        if keep_graph:
            # computed and masked on every tick, as the reference does, so
            # that each edge's send is in the graph on both of its ranks
            y = stage_fn(stage_params, x)
            y = torch.where(torch.tensor(active, device=y.device), y,
                            torch.zeros_like(y))
        else:
            y = stage_fn(stage_params, x) if active else torch.zeros_like(x)
        inbound = chain_send(y, group)   # the last stage's send is dropped
        # the last stage emits; a where keeps every stage's output in the
        # graph, so a backward from the result reaches every stage's edges
        emit = active and stage == n - 1
        emitted.append(torch.where(torch.tensor(emit, device=y.device), y,
                                   torch.zeros_like(y)) if keep_graph
                       else (y if emit else torch.zeros_like(y)))
    # emitted[t] holds microbatch t - (S - 1); realign to microbatch order
    out = torch.stack(emitted[n - 1:n - 1 + m])
    return psum(out, group) if collect == "psum" else out


# ---------------------------------------------------------------------------
# the collective tally
# ---------------------------------------------------------------------------
#: the reference's kinds of collective (``launch/dryrun.py``'s, from HLO)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: torch's c10d operators by the kind the reference's HLO names them.  A
#: point-to-point hop counts once, at its receiver (``recv_``): the
#: reference's ``collective-permute`` is one op whose result is the block
#: that arrives.  The port's operations map so: ``all_reduce``, ``psum``
#: and ``psum_compat`` → all-reduce; ``all_gather`` and ``fsdp_gather``'s
#: forward → all-gather; ``fsdp_gather``'s backward → all-reduce (a sum
#: over the data group, then the rank's slice: the reference's
#: transpose is a reduce-scatter); the MoE ``a2a`` dispatch → all-to-all;
#: ``ring_send``/``chain_send`` hops and the MoE ``ring`` dispatch →
#: collective-permute.
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class Tally:
    """The collectives of a block, in issue order: ``records`` holds one
    (c10d operator, bytes of its result) pair per op.  :meth:`kinds` sums
    them by the reference's kind, as its dry run sums its collectives'
    result shapes."""

    def __init__(self):
        self.records: List[Tuple[str, int]] = []

    def kinds(self) -> Dict[str, Dict[str, int]]:
        """``{kind: {"count", "bytes"}}`` for each of :data:`COLLECTIVES`."""
        out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        for name, nbytes in self.records:
            kind = _C10D_KINDS.get(name)
            if kind is not None:
                out[kind]["count"] += 1
                out[kind]["bytes"] += nbytes
        return out


class _TallyMode(TorchDispatchMode):
    """Appends each c10d collective that passes through dispatch to a
    :class:`Tally`."""

    def __init__(self, t: Tally):
        super().__init__()
        self.t = t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            if name in _C10D_KINDS:
                self.t.records.append((name, _nbytes(args[0])))
        return out


@contextmanager
def tally():
    """Record every collective issued inside the block (in this thread and
    in the autograd threads it starts) into a :class:`Tally`, over any
    backend (NCCL, gloo, the dry run's fake group)."""
    t = Tally()
    with _TallyMode(t):
        yield t
