"""Streaming aggregation operators on top of the all-to-all block.

The port's copy of ``repro_torch.core.stream_ops``.  Everything here is an **IR rewrite**: each operator returns plain skeleton
nodes (:class:`~repro_torch.core.skeleton.AllToAll`, :class:`~repro_torch.core.
skeleton.Stage`), so every operator inherits the backends the IR has —
threads and procs (and, in the reference, the mesh for statically-keyed
reductions) — without one line of backend code of its own.  This is the aggregation shape of the
parquet-aggregator workload: record streams → keyed shuffle → per-key
fold.

=================  =========================================================
operator           rewrite
=================  =========================================================
``partition_by``   ``AllToAll(identity, worker×n, by=key)`` — all items
                   sharing a key are serviced by the same right-vertex
                   instance (keyed affinity without a reduction)
``reduce_by_key``  ``AllToAll(left, _KeyFold×n, by=key, reduce=spec)`` —
                   per-key fold, flushed at EOS; named folds carry a
                   segment implementation, so the mesh backend compiles
                   the same IR node to one ``shard_map`` keyed shuffle
``window``         ``Stage(_WindowNode)`` — tumbling n-item windows folded
                   in-stream (host backends; the node is stateful, which
                   the mesh cannot trace)
=================  =========================================================

Host fold state lives in the right vertices (one ``_KeyFold`` instance
per partition — never shared), accumulates via ``svc`` and leaves the
network through the EOS flush hook (``ff_node.svc_eos``), so a fold's
results are on the wire *before* its vertex's EOS propagates — no side
channel, no post-run collection step.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Union

from .a2a import _ident
from .skeleton import GO_ON, AllToAll, EmitMany, Stage, ff_node

__all__ = [
    "Fold", "FOLDS", "KeyedReduce",
    "partition_by", "reduce_by_key", "window",
]


def _count_step(acc: int, _x: Any) -> int:
    return acc + 1


@dataclass(frozen=True)
class Fold:
    """A named reduction: the host-side binary fold plus the mesh-side
    segment kind.  ``seed_first=True`` seeds each key's accumulator with
    its first item (sum/min/max — no neutral element needed, and int/float
    types are preserved exactly); ``count`` instead starts from ``init``.

    ``kind`` names the segment/collective implementation the mesh keyed
    shuffle uses (``segment_sum``+``psum`` etc.); it is a string, not a
    jax callable, so importing this module never touches jax.

    ``combine`` merges two *partial accumulators* of the same key — what
    spill-to-disk folds and map-side combining (:mod:`repro_torch.core.oocore`)
    need on top of the per-item step.  Seed-first folds default to the
    step fn itself (``fn`` is accumulator-closed there); seeded folds
    like ``count`` step with an item, so they carry an explicit one."""

    name: str
    fn: Callable[[Any, Any], Any]
    init: Any = None
    seed_first: bool = True
    kind: Optional[str] = None
    combine: Optional[Callable[[Any, Any], Any]] = None


FOLDS = {
    "sum": Fold("sum", operator.add, kind="sum"),
    "min": Fold("min", min, kind="min"),
    "max": Fold("max", max, kind="max"),
    "count": Fold("count", _count_step, init=0, seed_first=False,
                  kind="count", combine=operator.add),
}


@dataclass(frozen=True)
class KeyedReduce:
    """The static part of a keyed reduction — what the mesh backend needs
    to compile the shuffle as one ``shard_map`` program: the key function
    (array-polymorphic, integer keys in ``[0, nkeys)``), the named fold,
    and the key-space bound.  Host backends ignore it (their ``_KeyFold``
    right nodes carry the same semantics dynamically)."""

    by: Callable[[Any], Any]
    fold: Fold
    nkeys: Optional[int] = None


class _KeyFold(ff_node):
    """Right-vertex node of a keyed reduction: fold every arriving item
    into its key's accumulator, emit nothing until EOS, then flush all
    ``(key, fold)`` pairs (``svc_eos``) — one instance per partition, and
    the shuffle guarantees each key visits exactly one instance."""

    def __init__(self, by: Callable[[Any], Any], fn: Callable[[Any, Any], Any],
                 init: Any = None, seed_first: bool = True):
        self.by = by
        self.fn = fn
        self.init = init
        self.seed_first = seed_first
        self._acc: dict = {}

    def svc(self, x):
        k = self.by(x)
        if k in self._acc:
            self._acc[k] = self.fn(self._acc[k], x)
        elif self.seed_first:
            self._acc[k] = x
        else:
            self._acc[k] = self.fn(self.init, x)
        return GO_ON

    def svc_eos(self):
        items = list(self._acc.items())
        self._acc = {}
        try:
            # sorted-key flush: dict insertion order differs per partition
            # history, so two processes folding the same partition would
            # emit the same pairs in different orders — sorting makes
            # threads/procs runs byte-identical (unorderable keys keep
            # arrival order, and the spill path's _OrdKey total order
            # covers the exotic cases)
            items.sort(key=lambda kv: kv[0])
        except TypeError:
            pass
        out = EmitMany(items)
        return out if out else None


class _WindowNode(ff_node):
    """Tumbling window: fold each run of ``n`` consecutive items into one
    emission; the final partial window flushes at EOS."""

    def __init__(self, n: int, fn: Callable[[Any, Any], Any],
                 init: Any = None, seed_first: bool = True):
        assert n >= 1
        self.n = n
        self.fn = fn
        self.init = init
        self.seed_first = seed_first
        self._acc: Any = None
        self._count = 0

    def svc(self, x):
        if self._count == 0:
            self._acc = x if self.seed_first else self.fn(self.init, x)
        else:
            self._acc = self.fn(self._acc, x)
        self._count += 1
        if self._count < self.n:
            return GO_ON
        out, self._acc, self._count = self._acc, None, 0
        return out

    def svc_eos(self):
        if self._count == 0:
            return None
        out, self._acc, self._count = self._acc, None, 0
        return out


def _resolve_fold(fold: Union[str, Fold, Callable], init: Any) \
        -> tuple:
    """-> (host fn, init, seed_first, Fold-or-None).

    A registry name or :class:`Fold` carries its own seed, so a
    user-passed ``init=`` would be silently discarded — that conflict is
    an error, not a preference fight the spec always wins."""
    if isinstance(fold, Fold):
        if init is not None:
            raise ValueError(
                f"init={init!r} conflicts with the Fold spec "
                f"{fold.name!r}, which already defines init={fold.init!r}"
                f" — pass a bare callable to use a custom seed")
        return fold.fn, fold.init, fold.seed_first, fold
    if isinstance(fold, str):
        try:
            spec = FOLDS[fold]
        except KeyError:
            raise ValueError(
                f"unknown fold {fold!r} (have {sorted(FOLDS)}, or pass a "
                f"binary callable)") from None
        if init is not None:
            raise ValueError(
                f"init={init!r} conflicts with the named fold {fold!r}, "
                f"which already defines init={spec.init!r} — pass a bare "
                f"callable to use a custom seed")
        return spec.fn, spec.init, spec.seed_first, spec
    if callable(fold):
        # custom binary fold: host backends only (no segment form); with
        # no init the first item seeds the accumulator
        return fold, init, init is None, None
    raise ValueError(f"fold must be a name, Fold, or callable, got {fold!r}")


def _worker_row(worker: Any, n: int) -> List[Any]:
    if worker is None:
        return [_ident] * n
    if isinstance(worker, (list, tuple)):
        assert len(worker) == n, "worker list must match partition count"
        return list(worker)
    if isinstance(worker, type):
        return [worker() for _ in range(n)]  # fresh instance per partition
    return [worker] * n  # shared by reference — stateless callers only


def partition_by(by: Callable[[Any], Any], nparts: int,
                 worker: Any = None, *, nleft: int = 1,
                 scheduling: Any = "rr",
                 name: str = "partition-by") -> AllToAll:
    """Keyed repartition: every item whose key hashes alike is serviced by
    the *same* right-vertex ``worker`` instance — keyed affinity as a
    network, for per-key state that a reduction does not cover (dedup
    sets, per-tenant caches, sticky sessions).

    ``worker`` may be ``None`` (pure shuffle), one node/callable shared by
    the row, a *class* (instantiated fresh per partition — the right way
    to ship per-partition state), or a list of ``nparts`` nodes."""
    return AllToAll(_ident, _worker_row(worker, nparts), by=by,
                    nleft=nleft, nright=nparts, scheduling=scheduling,
                    name=name)


def reduce_by_key(by: Callable[[Any], Any],
                  fold: Union[str, Fold, Callable] = "sum", *,
                  init: Any = None, nleft: int = 1, nright: int = 2,
                  nkeys: Optional[int] = None, left: Any = None,
                  scheduling: Any = "rr", budget: Any = None,
                  spill_dir: Optional[str] = None,
                  combine: Optional[Callable[[Any, Any], Any]] = None,
                  name: str = "reduce-by-key") -> AllToAll:
    """Partitioned keyed reduction: shuffle by ``by``, fold each key's
    items on the partition that owns it, flush ``(key, fold)`` pairs at
    EOS (sorted per partition, unordered across partitions — compare as
    a dict).

    ``fold`` is a registry name (``"sum"``/``"min"``/``"max"``/
    ``"count"``), a :class:`Fold`, or any binary callable (host backends
    only).  Named folds make the node mesh-lowerable when ``nkeys`` bounds
    the key space (``by`` must then be array-polymorphic with integer
    keys in ``[0, nkeys)``).  ``left`` optionally maps items before the
    shuffle (the columnar-explode stage of an aggregation pipeline).

    ``budget`` bounds the host partitions' fold state: a per-partition
    byte count or a :class:`~repro_torch.core.oocore.MemoryBudget` — the right
    row becomes spill-backed :class:`~repro_torch.core.oocore.SpillFold` stores
    (cold keys go to sorted on-disk runs under ``spill_dir``, merged back
    at the EOS flush), the default scatter policy upgrades to the
    budget-aware backpressure policy, and spill/stall telemetry lands in
    the node's ``.stats``.  The mesh lowering is untouched (it compiles
    the static ``reduce`` spec and never runs the right row), so one
    budgeted skeleton still runs on all three backends.  ``combine``
    merges two partial accumulators of one key — required for spilling
    with a seeded *custom* fold (named folds carry their own)."""
    fn, init, seed_first, spec = _resolve_fold(fold, init)
    if budget is not None:
        # lazy import: oocore composes on top of this module
        from .oocore import MemoryBudget, SpillFold, resolve_combine
        from .sched import BudgetBackpressure
        if not isinstance(budget, MemoryBudget):
            budget = MemoryBudget(int(budget), nparts=nright)
        comb = resolve_combine(spec, fn, seed_first, combine)
        rights: List[Any] = [
            SpillFold(by, fn, init, seed_first, combine=comb,
                      budget=budget, part=j, spill_dir=spill_dir)
            for j in range(nright)]
        if scheduling == "rr":
            scheduling = BudgetBackpressure(budget)
    else:
        rights = [_KeyFold(by, fn, init, seed_first) for _ in range(nright)]
    reduce_spec = (KeyedReduce(by=by, fold=spec, nkeys=nkeys)
                   if spec is not None and spec.kind else None)
    return AllToAll(left if left is not None else _ident, rights, by=by,
                    nleft=nleft, nright=nright, scheduling=scheduling,
                    reduce=reduce_spec, name=name)


def window(n: int, fold: Union[str, Fold, Callable] = "sum", *,
           init: Any = None, name: str = "window") -> Stage:
    """Tumbling window: fold each run of ``n`` consecutive stream items
    into one emission (partial tail flushes at EOS).  A single stateful
    stage — threads and procs backends (the mesh cannot trace stream
    state); composes freely before or after a shuffle."""
    fn, init, seed_first, _ = _resolve_fold(fold, init)
    return Stage(_WindowNode(n, fn, init, seed_first), name=name)
