"""Device farm skeleton — Emitter/Workers/Collector over a worker axis.

The farm's three entities map onto tensor pieces:

  * the **Emitter** is the dispatch step: for each resident item, the
    destination worker and a slot inside that worker's inbound buffer
    (round-robin is the identity sharding; the general data-dependent case
    is bucket-by-destination with a capacity and overflow dropping);
  * the **Workers** process the buffer they received;
  * the **Collector** is the combine step, which routes results back to
    their origin and restores item order (the tagged-token,
    order-preserving farm of paper Fig. 1: ``(dest, pos)`` *is* the tag).

The port's copy of ``repro.core.dfarm``, in torch, on one device: the
skeleton mesh lowering (:class:`~repro_torch.core.skeleton.MeshProgram`)
uses ``farm_map`` as its farm stage, ``roundrobin_dest`` as its emitter
policy and ``farm_until`` as its wrap-around loop.  The reference's
worker axis spans devices and its ``"a2a"``/``"ring"`` exchanges move the
buckets between them; here ``workers`` is that axis' size, and over one
worker either exchange is the identity.  More than one worker is
multi-GPU (ROADMAP §1 item 11) and raises.

This module also holds the tensor half of the mesh programs — the
host-side packing of a call's items (:func:`pack`, :func:`pad`,
:func:`unpack`) and the device programs themselves
(:func:`chain_program`, :func:`keyed_program`) — so that the skeleton,
the keyed shuffle and the autotuner stay plain Python and import this
module, and torch, only when a mesh program is built.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ops import resolve_device
from .skeleton import LoweringError

__all__ = ["dispatch", "combine", "farm_map", "farm_until",
           "roundrobin_dest", "farm_utilisation", "resolve_device",
           "device_count", "pack", "pad", "unpack", "chain_program",
           "keyed_program"]

_BACKENDS = ("a2a", "ring")


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


def _exchange(backend: str, workers: int) -> None:
    """The bucket exchange between workers: the identity over one."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown dispatch backend {backend!r}")
    if workers != 1:
        raise NotImplementedError(
            f"the {backend!r} exchange over {workers} workers moves buckets "
            f"between devices: multi-GPU, ROADMAP §1 item 11, not yet "
            f"ported to repro_torch (over one worker it is the identity)")


def _bucket_positions(dest: torch.Tensor, n_buckets: int, capacity: int):
    """Slot index of each item within its destination bucket (+validity)."""
    onehot = torch.nn.functional.one_hot(dest.long(), n_buckets)   # (L, n)
    pos = torch.cumsum(onehot, dim=0) - onehot                     # rank in bucket
    pos = (pos * onehot).sum(dim=1)                                # (L,)
    return pos, pos < capacity


def dispatch(items: torch.Tensor, dest: torch.Tensor, workers: int,
             capacity: int, *, backend: str = "a2a"
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Route ``(L, d)`` items to ``workers`` buckets of ``capacity`` slots.

    Returns ``(recv, (dest, pos, valid))`` where ``recv`` has shape
    ``(workers, capacity, d)``: ``recv[s]`` are the items source ``s``
    sent to this worker.  Items past a bucket's capacity are dropped
    (``valid`` False)."""
    _exchange(backend, workers)
    L, d = items.shape
    pos, valid = _bucket_positions(dest, workers, capacity)
    send = items.new_zeros((workers, capacity, d))
    send[dest[valid].long(), pos[valid]] = items[valid]
    return send, (dest, pos, valid)


def combine(processed: torch.Tensor, info: Tuple[torch.Tensor, ...],
            workers: int, *, backend: str = "a2a") -> torch.Tensor:
    """Inverse of :func:`dispatch`: results return to their emitters in
    item order (the order-preserving collector).  Invalid (dropped) items
    combine to zeros."""
    _exchange(backend, workers)
    dest, pos, valid = info
    gathered = processed[dest.long(), pos.clamp(max=processed.shape[1] - 1)]
    return torch.where(valid[:, None], gathered,
                       torch.zeros((), dtype=processed.dtype,
                                   device=processed.device))


def farm_map(worker_fn: Callable[[torch.Tensor], torch.Tensor],
             items: torch.Tensor, dest: torch.Tensor, workers: int,
             capacity: int, *, backend: str = "a2a") -> torch.Tensor:
    """Full farm round-trip: dispatch → worker → collect, order-preserving."""
    recv, info = dispatch(items, dest, workers, capacity, backend=backend)
    flat = recv.reshape(-1, recv.shape[-1])
    out = worker_fn(flat).reshape(recv.shape[0], capacity, -1)
    return combine(out, info, workers, backend=backend)


def roundrobin_dest(n_local: int, workers: int,
                    device: Any = None) -> torch.Tensor:
    """The Emitter's round-robin policy: destination worker of each item
    is its stream index mod ``workers``, mirroring the thread dispatch
    arbiter's ``"rr"`` mode (on one device the local index is the global
    one)."""
    return torch.arange(n_local, dtype=torch.int32, device=device) % workers


def farm_until(worker_fn: Callable[[torch.Tensor], torch.Tensor],
               loop_while: Callable[[torch.Tensor], Any],
               items: torch.Tensor, dest: torch.Tensor, workers: int,
               capacity: int, *, valid: Optional[torch.Tensor] = None,
               max_trips: Optional[int] = None,
               backend: str = "a2a") -> torch.Tensor:
    """Feedback farm: dispatch → re-apply ``worker_fn`` while
    ``loop_while`` holds → ordered combine.

    The device flavour of the thread farm's wrap-around edge.  The
    reference runs it as one compiled ``while_loop``; here it is a bounded
    host loop over device tensors that reads the continue flag once a
    trip.  Semantics match the thread backend's ``Feedback`` (do-while):
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


def chain_program(stages: Sequence[Any], workers: int,
                  capacity: Optional[int], device: Any) -> Callable:
    """The skeleton mesh program: ``stages`` (the mesh plan: ``map``,
    ``farm`` and ``feedback`` kinds) applied in order to a padded
    ``(rows, d + 1)`` array on ``device``; returns the host tensor.  Each
    farm is :func:`farm_map` over round-robin destinations, each
    wrap-around loop :func:`farm_until`; the validity flag rides along
    untouched (the ordered combine returns rows to their origin)."""
    def apply_stage(st, xf):
        x, flag = xf[:, :-1], xf[:, -1:]
        k = x.shape[0]
        if st.kind == "map":
            return _with_flag(st.fn(x), flag)
        dest = roundrobin_dest(k, workers, device=x.device)
        need = -(-k // workers)   # max bucket fill under round-robin dest
        cap = capacity or need + 1
        if cap < need:
            raise LoweringError(
                f"capacity={cap} would drop items: round-robin dispatch of "
                f"{k} rows over {workers} workers needs ≥ {need} slots per "
                f"(source, worker) pair")
        if st.kind == "farm":
            y = farm_map(st.fn, x, dest, workers, cap)
        else:
            y = farm_until(st.fn, st.loop_while, x, dest, workers, cap,
                           valid=flag, max_trips=st.max_trips)
        return _with_flag(y, flag)

    def program(padded: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(padded).to(device)
        for st in stages:
            x = apply_stage(st, x)
        return x.cpu()

    return program


def keyed_program(pre: Sequence[Callable], by: Callable, kind: str,
                  nkeys: int, workers: int, rows: int,
                  device: Any) -> Callable:
    """The keyed-shuffle mesh program: a padded ``(rows, 2)`` array
    (payload, validity flag) through the elementwise ``pre`` maps, each
    row to its key's owner (``key % workers``, :func:`dispatch`), and a
    segment reduction over the static key space — ``index_add_`` for
    ``sum`` and ``count``, ``scatter_reduce`` for ``min`` and ``max``.
    Returns ``(fold per key, count per key)`` as host lists.  Keys of the
    ``n`` real rows outside ``[0, nkeys)`` are refused (one read)."""
    def program(padded: np.ndarray, n: int) -> Tuple[List[Any], List[int]]:
        xf = torch.from_numpy(padded).to(device)
        x, flag = xf[:, :1], xf[:, 1]
        for f in pre:
            x = f(x)                    # elementwise maps, (rows, 1)
        keys = torch.as_tensor(by(x[:, 0])).to(torch.int64)
        # key-range precondition over the real rows: an out-of-range key
        # would otherwise clip into the boundary segment and silently
        # diverge from the threads/procs fold
        lo, hi = torch.stack([keys[:n].min(), keys[:n].max()]).tolist()
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
        dest = keys.clamp(0, nkeys - 1) % workers
        recv, _ = dispatch(aug, dest, workers, rows)
        flat = recv.reshape(-1, 2)      # (workers*rows, payload+flag)
        vals = flat[:, 0]
        valid = flat[:, 1] != 0
        k2 = torch.as_tensor(by(vals)).to(torch.int64)
        # invalid rows (padding, unfilled capacity slots) reduce into
        # segment nkeys, which is sliced away
        k2 = torch.where(valid, k2.clamp(0, nkeys - 1), nkeys)
        cnt = torch.zeros(nkeys + 1, dtype=torch.int32, device=xf.device)
        cnt = cnt.index_add_(0, k2, valid.to(torch.int32))[:nkeys]
        if kind == "count":
            acc = cnt
        else:
            seg = vals.new_zeros(nkeys + 1)
            if kind == "sum":
                seg.index_add_(0, k2, vals)
            else:
                seg.scatter_reduce_(0, k2, vals,
                                    "amin" if kind == "min" else "amax",
                                    include_self=False)
            acc = seg[:nkeys]
        return acc.tolist(), cnt.tolist()

    return program
