"""Device farm skeleton — Emitter/Workers/Collector over a worker axis.

The farm's three entities map onto tensor pieces:

  * the **Emitter** is the dispatch step: for each resident item, the
    destination worker and a slot inside that worker's inbound buffer
    (round-robin is the identity sharding; the general data-dependent case
    is bucket-by-destination with a capacity and overflow dropping);
  * the **Workers** are the ranks of the worker axis, each processing the
    buffer it received;
  * the **Collector** is the combine step, which routes results back to
    their origin and restores item order (the tagged-token,
    order-preserving farm of paper Fig. 1: ``(dest, pos)`` *is* the tag).

The port's copy of ``repro.core.dfarm``, in torch.  The skeleton mesh
lowering (:class:`~repro_torch.core.skeleton.MeshProgram`) uses
``farm_map`` as its farm stage, ``roundrobin_dest`` as its emitter policy
and ``farm_until`` as its wrap-around loop.  The reference's worker axis
is an ``axis_name`` inside ``shard_map``; here ``workers`` is either the
:class:`~repro_torch.core.ranks.Group` of the worker ranks, inside a rank
job, or the int 1: one worker, over which either exchange is the
identity.  The exchange is pluggable:

  * ``"a2a"``  — one ``dist.all_to_all_single`` over the group (the
                 symmetric, "fence-like" baseline);
  * ``"ring"`` — the FastFlow-style schedule: n-1 SPSC ring hops
                 (:func:`~repro_torch.core.dchannel.ring_send`), each
                 keeping the bucket addressed to this rank.  Same payload
                 bytes, no exchange over the whole group on the data path.

Both exchanges carry a gradient (the all-to-all is its own transpose; a
ring hop sends its cotangent back), so the MoE dispatch over them trains.

This module also holds the tensor half of the mesh programs — the
host-side packing of a call's items (:func:`pack`, :func:`pad`,
:func:`unpack`), the one-device programs (:func:`chain_program`,
:func:`keyed_program`) and their forms over a pool of rank processes
(:func:`rank_chain_program`, :func:`rank_keyed_program`) — so that the
skeleton, the keyed shuffle and the autotuner stay plain Python and
import this module, and torch, only when a mesh program is built.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.ops import resolve_device
from .ranks import Group
from .skeleton import LoweringError

__all__ = ["dispatch", "combine", "farm_map", "farm_until",
           "roundrobin_dest", "farm_utilisation", "resolve_device",
           "device_count", "pack", "pad", "unpack", "chain_program",
           "keyed_program", "rank_chain_program", "rank_keyed_program",
           "DispatchInfo"]

_BACKENDS = ("a2a", "ring")
Workers = Union[int, Group]


def device_count() -> int:
    """The CUDA cards this process sees (0 without one)."""
    return torch.cuda.device_count()


def farm_utilisation(n_items: int, n_workers: int) -> float:
    """Worker-axis occupancy for ``n_items`` over ``n_workers``: the last
    dispatch round is ragged, so utilisation is ``n / (W * ceil(n/W))``."""
    if n_items <= 0 or n_workers <= 0:
        return 0.0
    rounds = -(-n_items // n_workers)
    return n_items / (n_workers * rounds)


class DispatchInfo(tuple):
    """(dest, pos, valid) routing tag triple."""


def _axis(workers: Workers) -> Tuple[int, int, Optional[Group]]:
    """(size, this rank's index, group) of the worker axis."""
    if isinstance(workers, Group):
        return workers.size, workers.rank, workers
    if workers != 1:
        raise ValueError(
            f"an exchange over {workers} workers runs between rank "
            f"processes: pass the worker Group (repro_torch.core.ranks), "
            f"inside a rank job; an int names one worker only")
    return 1, 0, None


def _exchange(send: torch.Tensor, workers: Workers,
              backend: str) -> torch.Tensor:
    """``send`` (n, capacity, d), row i addressed to worker i, exchanged:
    row s of the result came from worker s.  The identity over one."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown dispatch backend {backend!r}")
    n, _, group = _axis(workers)
    if group is None or n == 1:
        return send
    if backend == "ring":
        return _ring_exchange(send, group)
    if torch.is_grad_enabled() and send.requires_grad:
        return _A2AFn.apply(send, group)
    return _all_to_all(send, group)


def _all_to_all(send: torch.Tensor, group: Group) -> torch.Tensor:
    ctx = group.ctx
    wire, recv = ctx.to_wire(send), ctx.recv_buffer(send)
    dist.all_to_all_single(recv, wire, group=group.pg)
    return ctx.from_wire(recv, send.device)


class _A2AFn(torch.autograd.Function):
    """The all-to-all with a gradient: row s of the cotangent goes back to
    worker s, which is the same exchange again (its own transpose)."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        return _all_to_all(send, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad.contiguous(), ctx.group), None


def _ring_exchange(send: torch.Tensor, group: Group) -> torch.Tensor:
    """All-to-all decomposed into n-1 SPSC ring hops.

    At hop h the block in flight left its producer h hops ago; this rank
    (index i) keeps the bucket addressed to it — row ``i`` of the block
    that originated at rank ``i - h`` — and forwards the whole block."""
    from .dchannel import ring_send
    n, me = group.size, group.rank
    rows = [None] * n
    block = send
    for h in range(n):
        rows[(me - h) % n] = block[me]
        if h + 1 < n:
            block = ring_send(block, group)
    return torch.stack(rows)


def _bucket_positions(dest: torch.Tensor, n_buckets: int, capacity: int):
    """Slot index of each item within its destination bucket (+validity)."""
    onehot = torch.nn.functional.one_hot(dest.long(), n_buckets)   # (L, n)
    pos = torch.cumsum(onehot, dim=0) - onehot                     # rank in bucket
    pos = (pos * onehot).sum(dim=1)                                # (L,)
    return pos, pos < capacity


def dispatch(items: torch.Tensor, dest: torch.Tensor, workers: Workers,
             capacity: int, *, backend: str = "a2a", wire_dtype=None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Route ``(L, d)`` items to the workers, ``capacity`` slots a bucket.

    Returns ``(recv, (dest, pos, valid))`` where ``recv`` has shape
    ``(W, capacity, d)``: ``recv[s]`` are the items source ``s`` sent to
    this worker.  Items past a bucket's capacity are dropped (``valid``
    False).  ``wire_dtype`` casts the payload on the wire only (e.g. bf16
    dispatch for f32 compute)."""
    n, _, _ = _axis(workers)
    L, d = items.shape
    pos, valid = _bucket_positions(dest, n, capacity)
    send = items.new_zeros((n, capacity, d))
    send[dest[valid].long(), pos[valid]] = items[valid]
    if wire_dtype is not None and wire_dtype != items.dtype:
        recv = _exchange(send.to(wire_dtype), workers, backend).to(items.dtype)
    else:
        recv = _exchange(send, workers, backend)
    return recv, DispatchInfo((dest, pos, valid))


def combine(processed: torch.Tensor, info: Tuple[torch.Tensor, ...],
            workers: Workers, *, backend: str = "a2a",
            wire_dtype=None) -> torch.Tensor:
    """Inverse of :func:`dispatch`: results return to their emitters in
    item order (the order-preserving collector).  Invalid (dropped) items
    combine to zeros."""
    dest, pos, valid = info
    out_dtype = processed.dtype
    if wire_dtype is not None and wire_dtype != processed.dtype:
        processed = processed.to(wire_dtype)
    back = _exchange(processed, workers, backend).to(out_dtype)
    gathered = back[dest.long(), pos.clamp(max=back.shape[1] - 1)]
    return torch.where(valid[:, None], gathered,
                       torch.zeros((), dtype=back.dtype, device=back.device))


def farm_map(worker_fn: Callable[[torch.Tensor], torch.Tensor],
             items: torch.Tensor, dest: torch.Tensor, workers: Workers,
             capacity: int, *, backend: str = "a2a") -> torch.Tensor:
    """Full farm round-trip: dispatch → worker → collect, order-preserving."""
    recv, info = dispatch(items, dest, workers, capacity, backend=backend)
    flat = recv.reshape(-1, recv.shape[-1])
    out = worker_fn(flat).reshape(recv.shape[0], capacity, -1)
    return combine(out, info, workers, backend=backend)


def roundrobin_dest(n_local: int, workers: Workers,
                    device: Any = None) -> torch.Tensor:
    """The Emitter's round-robin policy: the destination worker of each
    local item is its *global* stream index mod the axis size, ``(me *
    n_local + i) % W``, mirroring the thread dispatch arbiter's ``"rr"``
    mode.  ``workers`` is the worker Group or a worker count (this rank
    is then index 0)."""
    if isinstance(workers, Group):
        w, me = workers.size, workers.rank
    else:
        w, me = workers, 0
    return (me * n_local + torch.arange(n_local, dtype=torch.int32,
                                        device=device)) % w


def farm_until(worker_fn: Callable[[torch.Tensor], torch.Tensor],
               loop_while: Callable[[torch.Tensor], Any],
               items: torch.Tensor, dest: torch.Tensor, workers: Workers,
               capacity: int, *, valid: Optional[torch.Tensor] = None,
               max_trips: Optional[int] = None,
               backend: str = "a2a") -> torch.Tensor:
    """Feedback farm: dispatch → re-apply ``worker_fn`` while
    ``loop_while`` holds → ordered combine.

    The device flavour of the thread farm's wrap-around edge.  The
    reference runs it as one compiled ``while_loop`` per device; here each
    rank loops its own buffer in a host loop over device tensors that
    reads the continue flag once a trip, then the ordered combine.  Semantics match the thread backend's ``Feedback`` (do-while):
    every item is serviced at least once and emits the first result for
    which ``loop_while`` is false.  A validity flag travels as an extra
    column, so receivers tell real items from padding: ``valid`` (shape
    ``(L,)`` or ``(L, 1)``, nonzero = real, default all-valid) marks the
    caller's own padding rows, and unfilled capacity slots arrive as
    zeros, so neither ever keeps the loop going.  ``loop_while`` is
    applied to the ``(rows, d)`` buffer and reduced conjunctively over
    feature dims; ``max_trips`` (if given) bounds the trip count."""
    L, d = items.shape
    if valid is None:
        flag = items.new_ones((L, 1))
    else:
        flag = (valid.reshape(L, 1) != 0).to(items.dtype)
    aug = torch.cat([items, flag], dim=1)
    recv, info = dispatch(aug, dest, workers, capacity, backend=backend)
    flat = recv.reshape(-1, d + 1)
    real = flat[:, d] != 0

    def live(x, trips):
        m = torch.as_tensor(loop_while(x)).reshape(x.shape[0], -1).all(dim=1)
        m = m & real
        if max_trips is not None and trips >= max_trips:
            m = torch.zeros_like(m)
        return m

    x = worker_fn(flat[:, :d])           # do-while: first trip unconditional
    trips = 1
    while True:
        m = live(x, trips)
        if not bool(m.any()):            # the one host read of a trip
            break
        x = torch.where(m[:, None], worker_fn(x), x)
        trips += 1
    dt = torch.promote_types(x.dtype, flat.dtype)
    out = torch.cat([x.to(dt), flat[:, d:].to(dt)], dim=1)
    out = out.reshape(recv.shape[0], capacity, -1)
    return combine(out, info, workers, backend=backend)[:, :d]


# ---------------------------------------------------------------------------
# the mesh programs' tensor half: packing and the device programs
# ---------------------------------------------------------------------------
def pack(xs: Sequence[Any], refusal: str) -> np.ndarray:
    """A mesh call's items as one array: floats as float32, ints as int32
    (refusing any value int32 cannot hold: ``refusal`` says what the host
    backends compute instead), anything else refused."""
    arr = np.asarray(xs)
    if arr.dtype.kind == "f":
        return arr.astype(np.float32)
    if arr.dtype.kind in "iub":
        cast = arr.astype(np.int32)
        if not np.array_equal(cast, arr):
            raise LoweringError(
                f"integer payloads exceed int32 (the mesh compute dtype); "
                f"{refusal} — refusing to silently diverge")
        return cast
    raise LoweringError(f"mesh payloads must be numeric, got dtype {arr.dtype}")


def pad(arr: np.ndarray, total_rows: int) -> np.ndarray:
    """``(n, d)`` items into ``(total_rows, d + 1)``: the last column is
    the validity flag, 1 on the items and 0 on the bucket padding, so
    padding rows can never gate a feedback loop (:func:`farm_until`) or
    reduce into a key (:func:`keyed_program`)."""
    n, d = arr.shape
    padded = np.zeros((total_rows, d + 1), arr.dtype)
    padded[:n, :d] = arr
    padded[:n, d] = 1
    return padded


def unpack(out: torch.Tensor, n: int, d: int, squeeze: bool) -> List[Any]:
    """The first ``n`` rows of a program's host output, in order, as the
    reference's Python values: scalars (``squeeze``) or lists."""
    out = out[:n, :d]
    return out[:, 0].tolist() if squeeze else out.tolist()


def _with_flag(y: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(y.dtype, flag.dtype)
    return torch.cat([y.to(dt), flag.to(dt)], dim=1)


def _apply_stage(st: Any, xf: torch.Tensor, workers: Workers,
                 capacity: Optional[int]) -> torch.Tensor:
    """One stage of the mesh plan on a ``(k, d + 1)`` array whose last
    column is the validity flag: each farm is :func:`farm_map` over
    round-robin destinations, each wrap-around loop :func:`farm_until`;
    the flag rides along untouched (the ordered combine returns rows to
    their origin)."""
    x, flag = xf[:, :-1], xf[:, -1:]
    k = x.shape[0]
    if st.kind == "map":
        return _with_flag(st.fn(x), flag)
    w, _, _ = _axis(workers)
    dest = roundrobin_dest(k, workers, device=x.device)
    need = -(-k // w)   # max bucket fill under round-robin dest
    cap = capacity or need + 1
    if cap < need:
        raise LoweringError(
            f"capacity={cap} would drop items: round-robin dispatch of "
            f"{k} rows over {w} workers needs ≥ {need} slots per "
            f"(source, worker) pair")
    if st.kind == "farm":
        y = farm_map(st.fn, x, dest, workers, cap)
    else:
        y = farm_until(st.fn, st.loop_while, x, dest, workers, cap,
                       valid=flag, max_trips=st.max_trips)
    return _with_flag(y, flag)


def chain_program(stages: Sequence[Any], workers: int,
                  capacity: Optional[int], device: Any) -> Callable:
    """The skeleton mesh program on one device: ``stages`` (the mesh
    plan: ``map``, ``farm`` and ``feedback`` kinds) applied in order to a
    padded ``(rows, d + 1)`` array on ``device``; returns the host
    tensor."""
    def program(padded: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(padded).to(device)
        for st in stages:
            x = _apply_stage(st, x, workers, capacity)
        return x.cpu()

    return program


def _mesh_job(ctx: Any, stages: Sequence[Any], n_stage: int, n_worker: int,
              capacity: Optional[int], grain: Optional[int], rows: int,
              shard: np.ndarray) -> np.ndarray:
    """A rank's part of :func:`rank_chain_program`: its worker column's
    ``(rows, d + 1)`` shard through the plan.  With one stage row the
    stages run in order, each farm over the row's workers; with one row
    per stage, this rank's row runs its own stage and microbatches of
    ``grain`` rows stream down the column through ``pipeline_apply``."""
    from .dpipeline import pipeline_apply
    stage_g, worker_g = ctx.grid(n_stage, n_worker)
    x = torch.from_numpy(shard).to(ctx.device)
    with torch.no_grad():
        if n_stage == 1:
            for st in stages:
                x = _apply_stage(st, x, worker_g, capacity)
        else:
            st = stages[stage_g.rank]
            mb = grain or rows
            x = pipeline_apply(
                lambda _, v: _apply_stage(st, v, worker_g, capacity), None,
                x.reshape(rows // mb, mb, -1), group=stage_g, collect="local")
            x = x.reshape(rows, -1)
    return x.cpu().numpy()


def rank_chain_program(stages: Sequence[Any], n_stage: int, n_worker: int,
                       capacity: Optional[int], grain: Optional[int],
                       rows: int, pool: Any) -> Callable:
    """The skeleton mesh program over ``pool``'s ``n_stage * n_worker``
    rank processes: a padded ``(n_worker * rows, d + 1)`` array, worker
    column w taking rows ``[w * rows, (w + 1) * rows)`` (the reference's
    ``in_specs=P(WORKER_AXIS)``, the same shard on every stage row), and
    the output gathered from the last stage row (which emits it; with one
    stage row, that row); returns the host tensor."""
    def program(padded: np.ndarray) -> torch.Tensor:
        shards = [padded[w * rows:(w + 1) * rows] for w in range(n_worker)]
        outs = pool.run(_mesh_job, stages, n_stage, n_worker, capacity,
                        grain, rows,
                        per_rank=[shards[r % n_worker]
                                  for r in range(pool.world)])
        return torch.from_numpy(np.concatenate(outs[-n_worker:]))

    return program


def _key_range(keys: torch.Tensor, n: int,
               workers: Workers) -> Tuple[int, int]:
    """The least and greatest key of the first ``n`` rows, over every
    worker of the axis (one all-reduce over a group), so that every rank
    refuses alike."""
    if n:
        lo_hi = torch.stack([-keys[:n].min(), keys[:n].max()])
    else:
        lo_hi = torch.full((2,), -(1 << 62), dtype=torch.int64,
                           device=keys.device)
    _, _, group = _axis(workers)
    if group is not None and group.size > 1:
        wire = group.ctx.to_wire(lo_hi)
        dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=group.pg)
        lo_hi = wire
    neg_lo, hi = lo_hi.tolist()
    return -neg_lo, hi


def _keyed_fold(pre: Sequence[Callable], by: Callable, kind: str, nkeys: int,
                xf: torch.Tensor, n: int, workers: Workers
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keyed shuffle on a padded ``(rows, 2)`` array whose first ``n``
    rows are real: the pre-maps, every row to its key's owner (``key %
    W``), a segment reduction over the static key space.  Returns (fold
    per key, count per key); on a worker only its own keys hold values."""
    rows = xf.shape[0]
    x, flag = xf[:, :1], xf[:, 1]
    for f in pre:
        x = f(x)                    # elementwise maps, (rows, 1)
    keys = torch.as_tensor(by(x[:, 0])).to(torch.int64)
    # key-range precondition over the real rows: an out-of-range key
    # would otherwise clip into the boundary segment and silently
    # diverge from the threads/procs fold
    lo, hi = _key_range(keys, n, workers)
    if lo < 0 or hi >= nkeys:
        raise LoweringError(
            f"mesh keyed reduction saw keys in [{lo}, {hi}] but "
            f"nkeys={nkeys}: keys must lie in [0, nkeys) — refusing to "
            f"silently merge out-of-range keys into the boundary segment")
    aug = torch.cat([x, flag[:, None].to(x.dtype)], dim=1)
    # every row travels to its key's owner; padding rows carry an
    # arbitrary (valid) destination, their flag keeps them inert.
    # capacity = rows: even "every local row to one worker" fits, so
    # the exchange can never drop (unlike capacity-factor MoE)
    w, _, _ = _axis(workers)
    dest = keys.clamp(0, nkeys - 1) % w
    recv, _ = dispatch(aug, dest, workers, rows)
    flat = recv.reshape(-1, 2)      # (W*rows, payload+flag)
    vals = flat[:, 0]
    valid = flat[:, 1] != 0
    k2 = torch.as_tensor(by(vals)).to(torch.int64)
    # invalid rows (padding, unfilled capacity slots) reduce into
    # segment nkeys, which is sliced away
    k2 = torch.where(valid, k2.clamp(0, nkeys - 1), nkeys)
    cnt = torch.zeros(nkeys + 1, dtype=torch.int32, device=xf.device)
    cnt = cnt.index_add_(0, k2, valid.to(torch.int32))[:nkeys]
    if kind == "count":
        return cnt, cnt
    seg = vals.new_zeros(nkeys + 1)
    if kind == "sum":
        seg.index_add_(0, k2, vals)
    else:
        seg.scatter_reduce_(0, k2, vals, "amin" if kind == "min" else "amax",
                            include_self=False)
    return seg[:nkeys], cnt


def keyed_program(pre: Sequence[Callable], by: Callable, kind: str,
                  nkeys: int, workers: int, rows: int,
                  device: Any) -> Callable:
    """The keyed-shuffle mesh program on one device: a padded ``(rows,
    2)`` array (payload, validity flag) through the elementwise ``pre``
    maps, each row to its key's owner (:func:`dispatch`), and a segment
    reduction over the static key space — ``index_add_`` for ``sum`` and
    ``count``, ``scatter_reduce`` for ``min`` and ``max``.  Returns
    ``(fold per key, count per key)`` as host lists.  Keys of the ``n``
    real rows outside ``[0, nkeys)`` are refused (one read)."""
    def program(padded: np.ndarray, n: int) -> Tuple[List[Any], List[int]]:
        xf = torch.from_numpy(padded).to(device)
        acc, cnt = _keyed_fold(pre, by, kind, nkeys, xf, n, workers)
        return acc.tolist(), cnt.tolist()

    return program


def _keyed_job(ctx: Any, pre: Sequence[Callable], by: Callable, kind: str,
               nkeys: int, shard_n: Tuple[np.ndarray, int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """A rank's part of :func:`rank_keyed_program`."""
    shard, n = shard_n
    _, worker_g = ctx.grid(1, ctx.world)
    with torch.no_grad():
        acc, cnt = _keyed_fold(pre, by, kind, nkeys,
                               torch.from_numpy(shard).to(ctx.device), n,
                               worker_g)
    return acc.cpu().numpy(), cnt.cpu().numpy()


def rank_keyed_program(pre: Sequence[Callable], by: Callable, kind: str,
                       nkeys: int, rows: int, pool: Any) -> Callable:
    """The keyed-shuffle mesh program over ``pool``'s W rank processes:
    rank w takes rows ``[w * rows, (w + 1) * rows)`` of the padded array,
    rows travel to rank ``key % W`` by ``all_to_all_single`` and are
    segment-reduced there, and the segments are gathered in key order
    (key k from rank ``k % W``).  Returns host lists as
    :func:`keyed_program` does."""
    def program(padded: np.ndarray, n: int) -> Tuple[List[Any], List[int]]:
        w = pool.world
        per = [(padded[r * rows:(r + 1) * rows],
                max(0, min(rows, n - r * rows))) for r in range(w)]
        outs = pool.run(_keyed_job, pre, by, kind, nkeys, per_rank=per)
        owner, key = np.arange(nkeys) % w, np.arange(nkeys)
        acc = np.stack([o[0] for o in outs])[owner, key]
        cnt = np.stack([o[1] for o in outs])[owner, key]
        return acc.tolist(), cnt.tolist()

    return program
