"""Out-of-core keyed aggregation — spill-to-disk folds under a byte budget.

The port's copy of ``repro_torch.core.oocore``.  The parquet-aggregator scenario (ROADMAP) aggregates key spaces and
inputs that exceed memory; a plain ``reduce_by_key`` holds every key's
accumulator in an unbounded ``_KeyFold`` dict, which loses exactly that
fight.  This module is the missing layer, and — like everything in
``stream_ops`` — it is **pure IR + ff_node code**: every piece slots into
the existing :class:`~repro_torch.core.skeleton.AllToAll` lowering, so threads
and procs inherit it with no backend code of their own (and the
reference's mesh backend compiles the *same* skeleton from its static
``KeyedReduce`` spec, which never looks at the right row).

Four pieces:

:class:`SpillFold`
    A drop-in ``_KeyFold`` replacement: a bounded *hot* dict with
    recency order; when the per-partition byte budget is exceeded, the
    coldest half of the keys is written out as one **sorted run**
    (length-framed pickle records) and its bytes are released.  The EOS
    flush (``svc_eos`` — the same hook ``_KeyFold`` uses, so results are
    on the wire before EOS propagates) k-way-merges all runs plus the
    hot remainder with ``heapq.merge`` and re-combines equal keys, so
    peak flush memory is ``O(runs)``, not ``O(keys)``, until the final
    ``(key, fold)`` pairs materialise.  Output is sorted by key — a
    superset of the determinism the in-memory flush now guarantees.

:class:`MemoryBudget`
    The accounting board shared by one reduction's partitions: bytes
    held / spill count / spilled bytes per partition plus one global
    backpressure-stall counter.  Plain Python counters on the threads
    backend; on procs, :func:`~repro_torch.core.a2a.build_proc_a2a` swaps in a
    :class:`~repro_torch.core.shm.ShmCounters` board (``share``) before the
    vertices are pickled, every partition process writes only its own
    slots (single-writer per counter), and the runner copies the board
    back (``collect``) before shared memory is unlinked.  Either way the
    totals fold into the skeleton's ``FarmStats`` (``spills`` /
    ``spill_bytes`` / ``backpressure_stalls``) through the graph
    finalizer hook.

:func:`shard_source` / :class:`CombiningReader`
    Columnar record-batch sharding: ``nshards`` source nodes split one
    dataset by row ranges (round-robin over batches, so skew spreads),
    each streaming its batches independently — many left vertices, one
    dataset.  ``CombiningReader`` additionally pre-folds rows *inside
    the reader* under its own byte bound and emits ``(key, partial)``
    pairs — the map-side combiner: shuffle volume drops from rows to
    distinct keys, which is what lets the parallel aggregation beat the
    single-process in-memory loop on wall time, not just RSS.

:func:`shard_reduce` / :func:`rekey_reduce`
    The compositions.  ``shard_reduce`` assembles readers → (N×M keyed
    shuffle) → pair-mode ``SpillFold`` row into ONE ``AllToAll``.
    ``rekey_reduce`` chains a *second* keyed reduction after a first
    shuffle (``a2a∘a2a`` — the groupby-then-join shape): a pure
    ``Pipeline`` of two ``AllToAll`` nodes, which the host lowerings
    already wire (the second scatter fan-in-merges the first right row's
    rings) and ``fuse`` provably never crosses.

Everything here is host-only Python: no torch, no numpy — the module is
safe in the eager ``repro_torch.core`` import set that every spawned
vertex pays.
"""
from __future__ import annotations

import heapq
import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

from .skeleton import GO_ON, AllToAll, EmitMany, KeyBatch, Pipeline, ff_node

__all__ = [
    "MemoryBudget", "SpillFold", "ShardReader", "CombiningReader",
    "shard_source", "shard_reduce", "rekey_reduce", "pair_key",
]

_MISSING = object()


def pair_key(kv: Any) -> Any:
    """Routing key of a ``(key, value)`` pair — the shuffle ``by=`` for
    streams of pre-keyed pairs (combiner output, a second reduction's
    input).  A module-level function, so it pickles by name."""
    return kv[0]


class _OrdKey:
    """Sort key giving *any* key set a deterministic total order: natural
    ``<`` where the keys support it, falling back to ``(type name, repr)``
    where they don't (``None`` vs ``int``, mixed exotic keys).  Keys of a
    well-typed reduction are homogeneous, so the fallback is a safety
    net, not the common path."""

    __slots__ = ("k",)

    def __init__(self, k: Any):
        self.k = k

    def __lt__(self, other: "_OrdKey") -> bool:
        try:
            return self.k < other.k
        except TypeError:
            a, b = self.k, other.k
            return (type(a).__name__, repr(a)) < (type(b).__name__, repr(b))


def _sort_pairs(items: List[Tuple[Any, Any]]) -> List[Tuple[Any, Any]]:
    items.sort(key=lambda kv: _OrdKey(kv[0]))
    return items


def _entry_nbytes(k: Any, v: Any) -> int:
    """Approximate resident cost of one hot-dict entry: the dict slot plus
    the shallow sizes of key and value (one level into tuples, the common
    accumulator shape).  An estimate, not an audit — the budget bounds
    the *tracked* state, and the benchmark pins the resulting RSS."""
    n = 120 + sys.getsizeof(k) + sys.getsizeof(v)
    if type(v) is tuple:
        for e in v:
            n += sys.getsizeof(e)
    return n


# ---------------------------------------------------------------------------
# the accounting board
# ---------------------------------------------------------------------------
class MemoryBudget:
    """Byte budget + spill/stall telemetry for one keyed reduction.

    ``limit`` is the per-partition hot-state bound (bytes); a reduction
    with ``nparts`` partitions may hold at most ``limit × nparts`` in
    total.  Slot layout: three counters per partition (bytes held,
    spills, spilled bytes) and one trailing global stall counter —
    the exact shape :class:`~repro_torch.core.shm.ShmCounters` boards carry on
    the procs backend.  Each counter has one writer: partition ``j``
    writes only its own three slots, the scatter writes the stall slot.

    The object is plain picklable state: on procs every vertex process
    gets a copy, and the shared board travels by segment name
    (``ShmCounters.__reduce__``), so all copies write the same memory.
    """

    SLOTS_PER_PART = 3
    _BYTES, _SPILLS, _SPILL_BYTES = 0, 1, 2

    def __init__(self, limit_bytes: int, nparts: int = 1, *,
                 adaptive: bool = False, min_limit: Optional[int] = None,
                 max_limit: Optional[int] = None):
        if int(limit_bytes) <= 0:
            raise ValueError(f"budget must be positive, got {limit_bytes!r}")
        self.limit = int(limit_bytes)
        self.nparts = max(1, int(nparts))
        self._local = [0] * self.n_slots
        self._board: Any = None
        # adaptive mode: after each run (the fold_into finalizer) the
        # limit is resized from that run's spill/stall deltas — stalls
        # mean intake outran the hot set (shrink it so spilling starts
        # earlier and the scatter stops blocking); a clean run grows the
        # hot set back toward max_limit to spill less next time.
        self.adaptive = bool(adaptive)
        self.min_limit = int(min_limit) if min_limit is not None \
            else max(1, self.limit // 8)
        self.max_limit = int(max_limit) if max_limit is not None \
            else self.limit * 8
        self._seen_spills = 0
        self._seen_stalls = 0

    @property
    def n_slots(self) -> int:
        return self.SLOTS_PER_PART * self.nparts + 1

    # -- board lifecycle (procs backend; see build_proc_a2a) ----------------
    def share(self, board: Any) -> None:
        """Swap in a shared counter board (``ShmCounters(self.n_slots)``).
        Carried-over local totals (from earlier runs of the same skeleton)
        seed the board so the counters stay cumulative across runs."""
        for i, v in enumerate(self._local):
            if v:
                board.add(i, v)
        self._board = board

    def collect(self) -> None:
        """Copy the shared board back into local counters and drop the
        board reference — called by the graph finalizer *before* the
        shared memory is unlinked, so the budget object (and the IR node
        holding it) stays readable and re-runnable afterwards."""
        if self._board is not None:
            self._local = [int(v) for v in self._board.snapshot()]
            self._board = None

    # -- counter access ------------------------------------------------------
    def _add(self, i: int, d: int) -> None:
        if self._board is not None:
            self._board.add(i, d)
        else:
            self._local[i] += d

    def _get(self, i: int) -> int:
        return int(self._board.get(i)) if self._board is not None \
            else self._local[i]

    def charge(self, part: int, nbytes: int) -> None:
        self._add(part * self.SLOTS_PER_PART + self._BYTES, nbytes)

    def spilled(self, part: int, nbytes: int) -> None:
        self._add(part * self.SLOTS_PER_PART + self._SPILLS, 1)
        self._add(part * self.SLOTS_PER_PART + self._SPILL_BYTES, nbytes)

    def stalled(self) -> None:
        self._add(self.SLOTS_PER_PART * self.nparts, 1)

    # -- readouts ------------------------------------------------------------
    def held(self, part: int) -> int:
        return self._get(part * self.SLOTS_PER_PART + self._BYTES)

    def held_total(self) -> int:
        return sum(self.held(j) for j in range(self.nparts))

    def over_total(self) -> bool:
        """Global high-water for intake backpressure: ¾ of the aggregate
        budget.  A partition spills itself back to ``LOW_WATER × limit``,
        so each hovers in ``[½, 1]×limit`` and the aggregate can approach
        but never exceed the full budget — throttling must therefore cut
        in *below* the roof to ever engage, and ¾ is the midpoint of the
        hover band (all-partitions-hot ⇒ stall, all-just-spilled ⇒ run)."""
        return self.held_total() * 4 > self.limit * self.nparts * 3

    def spills(self) -> int:
        return sum(self._get(j * self.SLOTS_PER_PART + self._SPILLS)
                   for j in range(self.nparts))

    def spill_bytes(self) -> int:
        return sum(self._get(j * self.SLOTS_PER_PART + self._SPILL_BYTES)
                   for j in range(self.nparts))

    def stalls(self) -> int:
        return self._get(self.SLOTS_PER_PART * self.nparts)

    def adapt(self) -> int:
        """Resize the limit from the spill/stall deltas since the last
        call (one run, when driven by the ``fold_into`` finalizer).

        Stalls dominate the cost ladder (a stalled scatter blocks the
        whole intake, a spill costs one sorted-run write), so any stalls
        ⇒ halve the limit: a smaller hot set spills earlier and keeps the
        aggregate under the ¾ high-water that trips backpressure.  A run
        with neither stalls nor spills had headroom ⇒ double the limit
        (toward ``max_limit``) so future runs keep more keys hot.  A run
        that spilled but never stalled is the regime working as designed
        — hold.  Returns the (possibly unchanged) limit."""
        d_spills = self.spills() - self._seen_spills
        d_stalls = self.stalls() - self._seen_stalls
        self._seen_spills += d_spills
        self._seen_stalls += d_stalls
        if d_stalls > 0:
            self.limit = max(self.min_limit, self.limit // 2)
        elif d_spills == 0:
            self.limit = min(self.max_limit, self.limit * 2)
        return self.limit

    def fold_into(self, stats: Any) -> None:
        """Surface the telemetry in a ``FarmStats``.  The budget's
        counters are cumulative across runs of the same skeleton, so the
        graph finalizer *assigns* (not adds) — ``stats`` then always
        shows lifetime totals, matching the counters it mirrors.  An
        ``adaptive=True`` budget also re-sizes its limit here, so each
        ``lower()`` run of the same skeleton starts from the adapted
        value (procs vertices get the new limit with the next pickle)."""
        stats.spills = self.spills()
        stats.spill_bytes = self.spill_bytes()
        stats.backpressure_stalls = self.stalls()
        if self.adaptive:
            self.adapt()

    def __repr__(self) -> str:
        return (f"MemoryBudget(limit={self.limit}, nparts={self.nparts}, "
                f"held={self.held_total()}, spills={self.spills()}, "
                f"spill_bytes={self.spill_bytes()}, stalls={self.stalls()})")


def resolve_combine(spec: Any, fn: Callable, seed_first: bool,
                    combine: Optional[Callable]) -> Optional[Callable]:
    """The merge op for two *partial accumulators* of the same key — what
    spilling (and map-side combining) needs on top of a fold.  For a
    seed-first fold the step function is its own combiner (``sum``/
    ``min``/``max``: associative over values); seeded folds (``count``,
    custom ``init=`` folds) step with an *item*, which a partial
    accumulator is not, so they need an explicit combiner — the ``Fold``
    registry carries one for ``count``."""
    if combine is not None:
        return combine
    if spec is not None and getattr(spec, "combine", None) is not None:
        return spec.combine
    if seed_first:
        return fn
    return None


# ---------------------------------------------------------------------------
# the spill store
# ---------------------------------------------------------------------------
class SpillFold(ff_node):
    """Keyed fold with a bounded hot dict and sorted on-disk runs — the
    out-of-core ``_KeyFold``.

    Ingest (``svc``) folds each arriving item into its key's hot
    accumulator (recency order: an updated key moves to the back, so the
    front of the dict is always the coldest state).  When the tracked
    bytes exceed ``budget.limit``, the coldest half of the keys is
    sorted, written as one run file, and released.  The EOS flush merges
    every run with the hot remainder (``heapq.merge`` over sorted
    streams), combines equal keys with ``combine``, deletes the run
    directory, and emits sorted ``(key, fold)`` pairs — the same
    ``svc_eos`` contract as ``_KeyFold``, so the surrounding a2a wiring
    is untouched.

    ``pairs=True`` switches the input contract to pre-keyed ``(key,
    partial)`` pairs (a :class:`CombiningReader` row upstream, or a
    second reduction consuming a first one's output): the value IS a
    partial accumulator, so ingest combines instead of folding.

    One instance per partition; after a full run the instance is back to
    its initial state (empty dict, no runs, no temp dir), so the same
    skeleton object lowers and runs repeatedly — and pickles cleanly to
    spawned vertex processes at run start.
    """

    #: spill down to this fraction of the budget, so one spill buys many
    #: inserts of headroom instead of thrashing at the boundary
    LOW_WATER = 0.5
    #: EOS flush ships this many pairs per :class:`KeyBatch` wire message
    FLUSH_CHUNK = 4096
    #: the vertex loop hands whole :class:`KeyBatch` messages to ``svc``
    #: instead of unpacking them — ingest amortizes per-call overhead
    accepts_batches = True
    #: the hosting vertex binds its lane here before svc_init, so spills
    #: surface as trace instants (child-side on procs, shipped at EOS)
    wants_tracer = True
    tracer = None

    def __init__(self, by: Callable[[Any], Any], fn: Callable[[Any, Any], Any],
                 init: Any = None, seed_first: bool = True, *,
                 combine: Optional[Callable[[Any, Any], Any]] = None,
                 budget: Optional[MemoryBudget] = None, part: int = 0,
                 spill_dir: Optional[str] = None, pairs: bool = False):
        self.by = by
        self.fn = fn
        self.init = init
        self.seed_first = seed_first
        self.combine = combine if combine is not None else \
            resolve_combine(None, fn, seed_first, None)
        if self.combine is None:
            raise ValueError(
                "SpillFold needs a combine(acc, acc) op to merge spilled "
                "partials: a seeded fold's step fn takes (acc, item), not "
                "two accumulators — pass combine= (for fold='count' the "
                "registry already carries one)")
        self.budget = budget
        self.part = part
        self.spill_dir = spill_dir
        self.pairs = pairs
        self._acc: dict = {}          # key -> (accumulator, est. bytes)
        self._bytes = 0
        self._runs: List[str] = []
        self._dir: Optional[str] = None

    # -- accounting ----------------------------------------------------------
    def _charge(self, d: int) -> None:
        self._bytes += d
        if self.budget is not None:
            self.budget.charge(self.part, d)

    def _ensure_dir(self) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(
                prefix=f"ff-spill-p{self.part}-", dir=self.spill_dir)
        return self._dir

    def _drop_dir(self) -> None:
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None
        self._runs = []

    # -- ingest --------------------------------------------------------------
    def svc(self, x):
        if type(x) is KeyBatch:       # batched wire format (combiner chunks)
            one = self._svc_one
            for e in x:
                one(e)
            return GO_ON
        return self._svc_one(x)

    def _svc_one(self, x):
        if self.pairs:
            k, v = x
            ent = self._acc.pop(k, _MISSING)
            val = v if ent is _MISSING else self.combine(ent[0], v)
        else:
            k = self.by(x)
            ent = self._acc.pop(k, _MISSING)
            if ent is not _MISSING:
                val = self.fn(ent[0], x)
            elif self.seed_first:
                val = x
            else:
                val = self.fn(self.init, x)
        sz = _entry_nbytes(k, val)
        self._acc[k] = (val, sz)      # pop+reinsert: recency order
        self._charge(sz - (0 if ent is _MISSING else ent[1]))
        if self.budget is not None and self._bytes > self.budget.limit:
            self._spill()
        return GO_ON

    # -- spill ---------------------------------------------------------------
    def _spill(self) -> None:
        target = int(self.budget.limit * self.LOW_WATER)
        evicted: List[Tuple[Any, Any]] = []
        freed = 0
        for k in list(self._acc):     # dict front = coldest keys
            if self._bytes - freed <= target:
                break
            val, sz = self._acc.pop(k)
            evicted.append((k, val))
            freed += sz
        if not evicted:               # one giant entry: nothing to trade
            return
        _sort_pairs(evicted)
        path = os.path.join(self._ensure_dir(),
                            f"run-{len(self._runs):06d}.pkl")
        with open(path, "wb") as f:
            for kv in evicted:
                pickle.dump(kv, f, protocol=pickle.HIGHEST_PROTOCOL)
        self._runs.append(path)
        self._charge(-freed)
        run_bytes = os.path.getsize(path)
        if self.budget is not None:
            self.budget.spilled(self.part, run_bytes)
        if self.tracer is not None:
            self.tracer.instant("spill", {
                "items": len(evicted), "bytes": run_bytes,
                "runs": len(self._runs)})

    @staticmethod
    def _run_iter(path: str) -> Iterator[Tuple[Any, Any]]:
        with open(path, "rb") as f:
            while True:
                try:
                    yield pickle.load(f)
                except EOFError:
                    return

    def _chunked(self, items: List[Tuple[Any, Any]]):
        """Flush wire format: the sorted pairs ride in :class:`KeyBatch`
        chunks — one message per chunk instead of one per pair (the
        vertex/results drains unpack, so consumers still see pairs)."""
        if not items:
            return None
        step = self.FLUSH_CHUNK
        return EmitMany(KeyBatch(items[i:i + step])
                        for i in range(0, len(items), step))

    # -- EOS flush: k-way merge of runs + hot remainder ----------------------
    def svc_eos(self):
        hot = _sort_pairs([(k, v) for k, (v, _sz) in self._acc.items()])
        self._acc = {}
        self._charge(-self._bytes)
        if not self._runs:
            return self._chunked(hot)
        streams = [self._run_iter(p) for p in self._runs] + [iter(hot)]
        merged = heapq.merge(*streams, key=lambda kv: _OrdKey(kv[0]))
        out_items: List[Tuple[Any, Any]] = []
        ck: Any = _MISSING
        cv: Any = None
        for k, v in merged:
            if ck is not _MISSING and k == ck:
                cv = self.combine(cv, v)
            else:
                if ck is not _MISSING:
                    out_items.append((ck, cv))
                ck, cv = k, v
        if ck is not _MISSING:
            out_items.append((ck, cv))
        self._drop_dir()
        return self._chunked(out_items)

    def svc_end(self) -> None:
        # error-path teardown: an aborted run must not leak /tmp run files
        # (the normal path already cleaned up in svc_eos)
        self._drop_dir()


# ---------------------------------------------------------------------------
# columnar record-batch sharding
# ---------------------------------------------------------------------------
class ShardReader(ff_node):
    """Source node streaming shard ``shard``-of-``nshards`` of one dataset
    as row-range batches: ``reader(lo, hi)`` is any callable returning the
    rows in ``[lo, hi)`` (a parquet row-group slice, a numpy view, a list
    slice).  Batches are dealt round-robin over the shards so a skewed
    tail spreads.  Emits one batch per ``svc(None)`` call — or, with
    ``explode=``, the batch's rows (``EmitMany``) — then ``None`` (EOS);
    the exhausted cursor resets, so the same instance re-runs."""

    def __init__(self, reader: Callable[[int, int], Any], shard: int,
                 nshards: int, *, batch_rows: int = 4096,
                 nrows: Optional[int] = None,
                 explode: Optional[Callable[[Any], Iterable[Any]]] = None):
        if nrows is None:
            nrows = getattr(reader, "nrows", None)
        if nrows is None:
            raise ValueError(
                "ShardReader needs the dataset length: pass nrows= or give "
                "the reader an .nrows attribute")
        assert 0 <= shard < nshards and batch_rows >= 1
        self.reader = reader
        self.explode = explode
        self.ranges: List[Tuple[int, int]] = [
            (lo, min(lo + batch_rows, nrows))
            for i, lo in enumerate(range(0, int(nrows), batch_rows))
            if i % nshards == shard]
        self._pos = 0

    def svc(self, _task):
        if self._pos >= len(self.ranges):
            self._pos = 0
            return None
        lo, hi = self.ranges[self._pos]
        self._pos += 1
        batch = self.reader(lo, hi)
        if self.explode is None:
            return batch
        out = EmitMany(self.explode(batch))
        return out if out else GO_ON


def shard_source(reader: Callable[[int, int], Any], nshards: int, *,
                 batch_rows: int = 4096, nrows: Optional[int] = None,
                 explode: Optional[Callable] = None) -> List[ShardReader]:
    """``nshards`` source nodes over one dataset — the left row of an
    :class:`AllToAll` (no upstream edge: the lowering runs them as
    sources), so many left vertices stream one dataset in parallel."""
    return [ShardReader(reader, i, nshards, batch_rows=batch_rows,
                        nrows=nrows, explode=explode)
            for i in range(nshards)]


class CombiningReader(ff_node):
    """Map-side combiner source: wraps a batch source (``svc(None)``
    protocol, e.g. :class:`ShardReader`), pre-folds its rows into a
    bounded local dict, and emits ``(key, partial)`` pairs — evicting the
    coldest partials early when the local bound fills, flushing the rest
    at EOS (sorted, same determinism as the right row).  Shuffle volume
    drops from rows to ~distinct keys, which is what makes the parallel
    aggregation cheaper than the single-process loop on wall time.
    Downstream must re-combine: pair with a ``SpillFold(pairs=True)``
    right row (:func:`shard_reduce` wires exactly that)."""

    def __init__(self, source: ff_node, by: Callable[[Any], Any],
                 fn: Callable[[Any, Any], Any], init: Any = None,
                 seed_first: bool = True, *,
                 combine: Optional[Callable] = None,
                 limit_bytes: int = 1 << 20,
                 explode: Optional[Callable[[Any], Iterable[Any]]] = None):
        self.source = source
        self.by = by
        self.fn = fn
        self.init = init
        self.seed_first = seed_first
        self.combine = resolve_combine(None, fn, seed_first, combine)
        self.limit = int(limit_bytes)
        self.explode = explode
        self._acc: dict = {}
        self._bytes = 0

    def svc_init(self) -> None:
        self.source.svc_init()

    def svc_end(self) -> None:
        self.source.svc_end()

    def svc(self, _task):
        batch = self.source.svc(None)
        while batch is GO_ON:
            batch = self.source.svc(None)
        if batch is None:
            return None               # svc_eos flushes the remainder
        rows = batch if self.explode is None else self.explode(batch)
        if isinstance(rows, EmitMany) or not isinstance(
                rows, (list, tuple)):
            rows = list(rows)
        # the per-row hot loop: locals hoisted — this is the cost every
        # row pays, and it competes with the single-process baseline
        acc, by, fn = self._acc, self.by, self.fn
        pop, sizeof = acc.pop, _entry_nbytes
        seed_first, init = self.seed_first, self.init
        nbytes = self._bytes
        for x in rows:
            k = by(x)
            ent = pop(k, _MISSING)
            if ent is not _MISSING:
                val = fn(ent[0], x)
                sz = sizeof(k, val)
                nbytes += sz - ent[1]
            elif seed_first:
                val = x
                sz = sizeof(k, val)
                nbytes += sz
            else:
                val = fn(init, x)
                sz = sizeof(k, val)
                nbytes += sz
            acc[k] = (val, sz)        # pop+reinsert: recency order
        self._bytes = nbytes
        if nbytes <= self.limit:
            return GO_ON
        target = self.limit // 2      # emit the coldest half as partials
        evicted = KeyBatch()          # one wire message per destination
        for k in list(acc):
            if nbytes <= target:
                break
            val, sz = pop(k)
            evicted.append((k, val))
            nbytes -= sz
        self._bytes = nbytes
        return evicted if evicted else GO_ON

    def svc_eos(self):
        items = _sort_pairs([(k, v) for k, (v, _sz) in self._acc.items()])
        self._acc = {}
        self._bytes = 0
        out = KeyBatch(items)
        return out if out else None


# ---------------------------------------------------------------------------
# compositions
# ---------------------------------------------------------------------------
def shard_reduce(reader: Callable[[int, int], Any],
                 by: Callable[[Any], Any], fold: Any = "sum", *,
                 init: Any = None, combine: Optional[Callable] = None,
                 nleft: int = 4, nright: int = 2,
                 budget: Any = None, spill_dir: Optional[str] = None,
                 batch_rows: int = 4096, nrows: Optional[int] = None,
                 explode: Optional[Callable] = None,
                 combine_limit: Optional[int] = None,
                 name: str = "shard-reduce") -> AllToAll:
    """The whole out-of-core aggregation as ONE :class:`AllToAll`:
    ``nleft`` sharded combining readers over one dataset → keyed shuffle
    on the pair key → ``nright`` pair-mode :class:`SpillFold` partitions
    under a shared :class:`MemoryBudget`.  Host backends only (the left
    row is stateful source nodes); ``budget`` is a byte count or a
    :class:`MemoryBudget`, ``None`` for unbounded right-row dicts."""
    from .stream_ops import _resolve_fold
    fn, init, seed_first, spec = _resolve_fold(fold, init)
    comb = resolve_combine(spec, fn, seed_first, combine)
    if comb is None:
        raise ValueError(
            "shard_reduce pre-combines on the readers, which needs a "
            "combine(acc, acc) op — pass combine= for seeded custom folds")
    if budget is not None and not isinstance(budget, MemoryBudget):
        budget = MemoryBudget(int(budget), nparts=nright)
    lim = combine_limit if combine_limit is not None else (
        budget.limit if budget is not None else 1 << 20)
    lefts = [CombiningReader(src, by, fn, init, seed_first, combine=comb,
                             limit_bytes=lim, explode=explode)
             for src in shard_source(reader, nleft, batch_rows=batch_rows,
                                     nrows=nrows)]
    rights = [SpillFold(by, fn, init, seed_first, combine=comb,
                        budget=budget, part=j, spill_dir=spill_dir,
                        pairs=True)
              for j in range(nright)]
    return AllToAll(lefts, rights, by=pair_key, nleft=nleft, nright=nright,
                    name=name)


def rekey_reduce(first: AllToAll, by: Callable[[Any], Any],
                 fold: Any = "sum", *, init: Any = None,
                 combine: Optional[Callable] = None,
                 nleft: int = 1, nright: int = 2, budget: Any = None,
                 spill_dir: Optional[str] = None,
                 left: Any = None, name: str = "rekey-reduce") -> Pipeline:
    """Chain a second keyed reduction after ``first`` — ``a2a∘a2a`` with
    key re-partitioning between the reductions, the groupby-then-join
    shape.  Pure IR: ``Pipeline(first, second)``; the host lowerings
    already wire it (the second scatter fan-in-merges the first right
    row's out rings), ``fuse`` treats both shuffles as hard boundaries,
    and the mesh backend rejects it (one shuffle per mesh program).

    The second reduction consumes the first's ``(key, fold)`` pairs: its
    ``by`` and ``fold`` see whole pairs (use ``left=`` to re-map them
    first).  ``budget=`` makes the second row spill-backed too."""
    from .stream_ops import reduce_by_key
    second = reduce_by_key(by, fold, init=init, nleft=nleft, nright=nright,
                           left=left, budget=budget, spill_dir=spill_dir,
                           combine=combine, name=name)
    return Pipeline(first, second)
