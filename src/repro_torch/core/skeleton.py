"""Backend-neutral skeleton IR — the vocabulary, and its host runtimes.

FastFlow's central claim (paper Sec. 2, tutorial TR-12-04) is that one small
skeleton vocabulary — pipeline, farm, feedback — covers every streaming
application while the machinery underneath stays swappable.  This module is
that vocabulary as *pure data*: declarative :class:`Stage`, :class:`Source`,
:class:`Pipeline`, :class:`Farm` and :class:`Feedback` nodes, composable
with ``compose``/``>>`` (the paper's ∘), carrying ``ordered=``,
``nworkers=`` and ``grain=`` attributes, and *no* execution state.

Execution is a separate step, :func:`lower`:

``lower(skel, backend="threads")``
    produces a :class:`ThreadProgram` over the thread/SPSC-ring graph
    runtime (see :func:`repro_torch.core.graph.build`).  Ordered-stream
    semantics come from the tagged-token collector.

``lower(skel, backend="procs")``
    produces a :class:`~repro_torch.core.procgraph.ProcProgram`: every
    vertex a spawned process, every edge a shared-memory SPSC ring, with
    the same ordered-output contract.

``lower(skel, backend="mesh")``
    produces a :class:`MeshProgram`: the whole skeleton as **one** device
    program over ``(rows, d)`` tensors (a CUDA card by default,
    ``device="cpu"`` for the plain path), with ``dfarm.farm_map`` for each
    farm and ``dfarm.farm_until`` for each wrap-around loop — no host SPSC
    hop between stages.  Over ``devices > 1`` the program runs in as many
    rank processes (:mod:`.ranks`), a ``(stage, worker)`` grid of them,
    farms exchanging over their stage row and the pipeline streaming down
    the worker columns.  Skeletons holding an :class:`AllToAll` compile to
    the keyed-shuffle program (:class:`~repro_torch.core.a2a.A2AMeshProgram`).

This is the port's copy of the reference runtime (``repro.core.skeleton``):
the same IR, the same ordered outputs on every backend, the same
``tune=``/``profile=`` two-phase compile (:mod:`.autotune`),
``metrics=`` run reports and ``monitor=`` live sampling (:mod:`.monitor`).
The host backends additionally support host-only features (``GO_ON``
filtering, emitter / collector nodes, speculative re-issue, arbitrary
``feedback=`` routing), which the mesh lowering rejects with a
:class:`LoweringError` rather than silently approximating.

The programming-model primitives (``ff_node``, ``FnNode``, ``GO_ON``) live
here too: they are the *node* vocabulary every backend shares (the mesh
backend unwraps ``FnNode`` to its callable and applies it to ``(rows, d)``
tensors, which for elementwise arithmetic is identical to the scalar form).

Plain Python: the mesh programs import torch inside their constructors.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Type

from .obs import (MetricsRegistry, Tracer, farm_stats_snapshot,
                  qualname as _obs_qualname)

__all__ = [
    "GO_ON", "EmitMany", "KeyBatch", "ff_node", "FnNode", "FusedNode",
    "FarmStats", "LatencyReservoir",
    "Skeleton", "Stage", "Source", "Pipeline", "Farm", "Feedback",
    "AllToAll",
    "compose", "as_skeleton", "fuse", "walk_stats",
    "LoweringError", "lower", "BACKENDS", "ThreadProgram", "MeshProgram",
]

# The reference's shard_map axis names of the mesh lowering's (stage,
# worker) grid; the port's grid is RankContext.grid's groups, and these
# name its axes.
STAGE_AXIS = "skel_stage"
WORKER_AXIS = "skel_worker"


# ---------------------------------------------------------------------------
# programming model (paper Fig. 2) — shared by every backend
# ---------------------------------------------------------------------------
class ff_node:
    """Base class for network entities (paper Fig. 2)."""

    def svc_init(self) -> None:  # noqa: D401
        """Called once in the entity's own thread before the stream starts."""

    def svc(self, task: Any) -> Any:
        """Process one task.  Sources receive ``None`` and return the next
        task (``None`` = end-of-stream); other nodes receive a task and
        return a result (``GO_ON`` = nothing to emit, keep streaming)."""
        raise NotImplementedError

    def svc_end(self) -> None:
        """Called once after EOS has been processed."""

    def svc_eos(self) -> Any:
        """EOS flush (FastFlow's ``eosnotify``): called once when every
        inbound edge has delivered EOS, *before* this vertex's own EOS
        propagates downstream.  Return a payload (or :class:`EmitMany`)
        to flush buffered state into the stream — the keyed folds in
        :mod:`repro.core.stream_ops` emit their per-key accumulators
        here — or ``None``/``GO_ON`` for nothing (the default)."""
        return None


class FnNode(ff_node):
    """Wrap a plain callable as an ``ff_node``."""

    def __init__(self, fn: Callable[[Any], Any]):
        self._fn = fn

    def svc(self, task: Any) -> Any:
        return self._fn(task)


class _SeqNode(ff_node):
    """Source node replaying a finite iterable (then EOS)."""

    def __init__(self, items: Iterable[Any]):
        self._it = iter(items)

    def svc(self, _):
        try:
            return next(self._it)
        except StopIteration:
            return None


class _GoOn:
    _instance: Optional["_GoOn"] = None

    def __new__(cls) -> "_GoOn":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __reduce__(self):
        # identity survives pickling (same contract as _EOS: a worker
        # process returning GO_ON must satisfy `payload is GO_ON` in the
        # merge arbiter's process)
        return (_GoOn, ())

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<GO_ON>"


GO_ON = _GoOn()


class EmitMany(list):
    """Return type for a *Stage* node's ``svc`` when one input produces
    several outputs: ``return EmitMany([a, b])`` emits ``a`` then ``b``
    downstream (an empty ``EmitMany`` emits nothing, like ``GO_ON``).
    Plain lists stay ordinary payloads — multi-emit is opt-in by type.
    Only ``StageVertex`` flattens it (the reorder stage's flush is the
    canonical use); farm workers and collectors pass it through as an
    ordinary payload, because their tokens are 1:1 by tag."""


class KeyBatch(EmitMany):
    """A multi-emit that rides the stream as **one message**: the producing
    vertex pushes the whole batch onto a single ring (one pickle, one slot)
    and the *consuming* vertex unpacks it — ``svc`` still sees items, so
    nodes stay batch-oblivious unless they opt in (``accepts_batches =
    True``, e.g. :class:`~repro.core.oocore.SpillFold`).  The a2a left
    vertices instead *split* a batch by routing key into one sub-batch per
    destination ring, which is what lets a keyed shuffle amortize its
    per-hand-off cost over thousands of pairs (the map-side combiner's
    eviction chunks).  As an :class:`EmitMany` subclass it degrades to a
    plain per-item flatten everywhere no batch-aware path exists."""


class _FarmEmitMany(EmitMany):
    """Marker: a farm-absorbed tail chain multi-emitted.  The merge
    arbiter flattens this downstream (one ``_deliver`` per element) — the
    behaviour the unfused trailing ``StageVertex`` would have had —
    whereas an ordinary ``EmitMany`` worker payload still crosses the
    collector whole (tokens are 1:1 by tag)."""


class FusedNode(ff_node):
    """Several nodes executed back-to-back inside ONE vertex — the result
    of the :func:`fuse` pass collapsing a sub-threshold-grain hand-off.

    Chain semantics mirror what the separate vertices would have done.

    ``flatten=True`` (stage∘stage fusion): ``GO_ON`` anywhere filters the
    item; ``None`` from the FIRST node propagates as ``None`` (in source
    position that is EOS, mid-pipeline the vertex filters it — both
    exactly the unfused behaviour), while ``None`` from a later node
    becomes ``GO_ON`` (the downstream vertex would merely have skipped
    that one item, never ended the stream).  An intermediate
    :class:`EmitMany` fans each element through the rest of the chain,
    because ``StageVertex._emit`` would have flattened it onto the ring.

    ``flatten=False`` (farm-worker∘stage fusion): a worker's token is 1:1
    by tag and the merge arbiter retires ``GO_ON`` payloads silently but
    delivers anything else — including ``None`` and whole ``EmitMany``
    payloads — so the fused tail runs on every non-``GO_ON`` worker
    result; a tail result of ``None``/``GO_ON`` returns ``GO_ON`` (the
    token retires, nothing is emitted — what the downstream stage
    vertex's filtering would have produced), and a tail result that IS an
    ``EmitMany`` is wrapped in :class:`_FarmEmitMany` so the merge
    arbiter flattens it downstream — because unfused, the trailing
    ``StageVertex`` flattens whatever ``EmitMany`` its node returns.

    ``svc_init``/``svc_end`` run once per constituent, in stream order
    (``svc_end`` reversed, like unwinding the pipeline)."""

    def __init__(self, nodes: Iterable[Any], *, flatten: bool = True):
        self.nodes: List[ff_node] = [_as_node(n) for n in nodes]
        self.flatten = flatten

    def svc_init(self) -> None:
        for n in self.nodes:
            n.svc_init()

    def svc_end(self) -> None:
        for n in reversed(self.nodes):
            n.svc_end()

    def svc(self, task: Any) -> Any:
        if not self.flatten:
            return self._apply_farm(task)
        return self._apply(0, task)

    def svc_eos(self) -> Any:
        """Chain the EOS flush: each constituent's ``svc_eos`` output runs
        through the *rest* of the chain, exactly as its separate vertex's
        flush would have streamed through the downstream vertices.  Only
        meaningful for ``flatten=True`` (stage∘stage) fusions — farm
        workers are never flushed by the merge arbiter, so the
        ``flatten=False`` junction keeps the default no-op."""
        if not self.flatten:
            return None
        out = EmitMany()
        for i, n in enumerate(self.nodes):
            r = n.svc_eos()
            if r is None or r is GO_ON:
                continue
            for t in (r if isinstance(r, EmitMany) else [r]):
                rr = self._apply(i + 1, t)
                if rr is None or rr is GO_ON:
                    continue
                if isinstance(rr, EmitMany):
                    out.extend(rr)
                else:
                    out.append(rr)
        return out if out else None

    def _apply(self, i: int, task: Any) -> Any:
        nodes = self.nodes
        start = i
        while i < len(nodes):
            task = nodes[i].svc(task)
            i += 1
            if task is None:
                # only the head of the chain may signal EOS/None onward;
                # a later node's None filters one item, like its vertex
                return None if (start == 0 and i == 1) else GO_ON
            if task is GO_ON:
                return GO_ON
            if isinstance(task, EmitMany) and i < len(nodes):
                out = EmitMany()
                for t in task:
                    r = self._apply(i, t)
                    if r is None or r is GO_ON:
                        continue
                    if isinstance(r, EmitMany):
                        out.extend(r)
                    else:
                        out.append(r)
                return out
        return task

    def _apply_farm(self, task: Any) -> Any:
        nodes = self.nodes
        task = nodes[0].svc(task)          # the original worker
        for n in nodes[1:]:                # the absorbed stage chain
            if task is GO_ON:
                return GO_ON               # merge would have retired it
            task = n.svc(task)             # unfused stages see None too
        if task is None or task is GO_ON:
            return GO_ON
        return _FarmEmitMany(task) if isinstance(task, EmitMany) else task


class LatencyReservoir:
    """Bounded sliding-window latency sample (most recent ``cap`` values).

    The merge arbiter appends one latency per collected task; a plain list
    grew without bound, which leaked memory in long-running farms (the
    ``ServeEngine`` decode loop appends one per tick, forever).  A ring
    overwrite of the oldest entry keeps the sample bounded AND makes the
    p95 a *recent-window* statistic, which is the better straggler signal
    anyway — ancient latencies from a cold start should not set today's
    re-issue threshold.  ``count`` still tracks lifetime appends.

    Single-writer: only the merge arbiter appends; the dispatch arbiter's
    reads (p95) are benignly stale, same as every other cross-arbiter read
    in the runtime."""

    __slots__ = ("_cap", "_buf", "_next", "count")

    def __init__(self, cap: int = 2048):
        assert cap > 0
        self._cap = cap
        self._buf: List[float] = []
        self._next = 0
        self.count = 0

    def append(self, x: float) -> None:
        if len(self._buf) < self._cap:
            self._buf.append(x)
        else:
            self._buf[self._next] = x
            self._next = (self._next + 1) % self._cap
        self.count += 1

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)


@dataclass
class FarmStats:
    """Thread-backend farm telemetry (dispatch/merge arbiters and the
    workers fill it in; every field has exactly one writer thread — or,
    for the per-worker dicts, one writer per key)."""

    tasks_emitted: int = 0
    tasks_collected: int = 0
    duplicates_issued: int = 0
    duplicates_dropped: int = 0
    steals: int = 0
    # out-of-core keyed aggregation (oocore.MemoryBudget folds these in
    # through the graph finalizer hook): spill runs written, bytes spilled
    # to disk, and scatter intake stalls from budget backpressure
    spills: int = 0
    spill_bytes: int = 0
    backpressure_stalls: int = 0
    per_worker: Dict[int, int] = field(default_factory=dict)
    # worker i's service-time EWMA, written only by worker i; the
    # CostModel scheduling policy reads it for adaptive placement
    service_ewma: Dict[int, float] = field(default_factory=dict)
    latencies: LatencyReservoir = field(default_factory=LatencyReservoir)
    worker_failures: List = field(default_factory=list)

    def p95_latency(self) -> float:
        xs = sorted(self.latencies)
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]


def _as_node(x: Any) -> ff_node:
    return x if isinstance(x, ff_node) else FnNode(x)


# ---------------------------------------------------------------------------
# the IR: declarative skeleton nodes (pure data)
# ---------------------------------------------------------------------------
class Skeleton:
    """A declarative description of a streaming network.

    Skeletons are pure data: they carry nodes and attributes, never threads
    or device buffers.  ``a >> b`` (or ``compose(a, b)``) chains skeletons
    into a :class:`Pipeline` — the paper's ∘.  Execution goes through
    :func:`lower`; the ``to_graph``/``run``/``run_and_wait`` methods below
    are thread-backend conveniences that preserve PR 1's ``Net`` API
    (``repro_torch.core.graph.Net`` is now an alias of this class).
    """

    def __rshift__(self, other: Any) -> "Pipeline":
        return Pipeline(self, other)

    def __rrshift__(self, other: Any) -> "Pipeline":
        return Pipeline(other, self)

    # -- thread-backend conveniences (the PR-1 Net surface) -----------------
    def to_graph(self, stream: Optional[Iterable[Any]] = None, *,
                 queue_class: Optional[Type] = None, capacity: int = 512):
        return lower(self, "threads", queue_class=queue_class,
                     capacity=capacity).to_graph(stream)

    def run(self, stream: Optional[Iterable[Any]] = None, **kw):
        return self.to_graph(stream, **kw).run()

    def run_and_wait(self, stream: Optional[Iterable[Any]] = None,
                     **kw) -> List[Any]:
        return self.to_graph(stream, **kw).run_and_wait()


def as_skeleton(x: Any) -> Skeleton:
    """Coerce a skeleton / ``ff_node`` / plain callable into IR."""
    if isinstance(x, Skeleton):
        return x
    if isinstance(x, ff_node) or callable(x):
        return Stage(x)
    raise TypeError(f"cannot interpret {x!r} as a network stage")


class Stage(Skeleton):
    """A single sequential node (paper Fig. 2) as a one-vertex network.

    ``capacity`` sizes this stage's *outbound* SPSC ring on the host
    backends (``None`` = the graph-wide default) — the per-edge knob the
    autotune pass (:mod:`repro_torch.core.autotune`) sets from the measured
    producer/consumer service-rate ratio."""

    def __init__(self, node: Any, *, name: str = "ff-stage",
                 grain: Optional[int] = None,
                 capacity: Optional[int] = None):
        self.node = _as_node(node)
        self.name = name
        self.grain = grain
        self.capacity = capacity


class Source(Skeleton):
    """A stream source: an ``ff_node`` (``svc(None)`` protocol) or any
    iterable, replayed then EOS.  ``grain`` carries the same per-stage
    hint as :class:`Stage` (the procs backend's ``batch="grain"`` reads
    it as the source's emit-batch size); ``capacity`` sizes the outbound
    ring like :class:`Stage`."""

    def __init__(self, items: Any, *, name: str = "ff-source",
                 grain: Optional[int] = None,
                 capacity: Optional[int] = None):
        self.node = items if isinstance(items, ff_node) else _SeqNode(items)
        self.name = name
        self.grain = grain
        self.capacity = capacity


class Pipeline(Skeleton):
    """Chain sub-networks over streaming edges (paper Sec. 3.1 pipeline).

    Nested pipelines are flattened, so ``Pipeline(a, Pipeline(b, c))`` and
    ``compose(a, b, c)`` are the same IR — handy for the mesh lowering,
    which plans over the flat stage list."""

    def __init__(self, *stages: Any):
        assert stages, "empty pipeline"
        flat: List[Skeleton] = []
        for s in stages:
            s = as_skeleton(s)
            flat.extend(s.stages if isinstance(s, Pipeline) else [s])
        self.stages = flat


def compose(*stages: Any) -> Pipeline:
    """``compose(a, b, c)`` == ``Pipeline(a, b, c)`` — functional spelling."""
    return Pipeline(*stages)


class Farm(Skeleton):
    """The farm skeleton (paper Sec. 3.1, Figs. 1-2), backend-neutral.

    Parameters
    ----------
    workers: one ``ff_node``/callable shared by all workers, or a list with
        one node per worker (thread backend only — the mesh backend needs a
        single jax-traceable function).
    nworkers: worker-pool width (defaults to ``len(workers)`` for a list).
        On the mesh backend actual parallelism is the worker-axis size.
    emitter / collector: optional ``ff_node``s (thread backend only).
    ordered: reorder results by tag — Fig. 1 (right) tagged-token collector.
        The mesh lowering is always order-preserving (its ``(dest, pos)``
        routing tags are the same construction).
    grain: items per microbatch hint — the mesh lowering uses it as the
        ``pipeline_apply`` microbatch size; the fusion policy (ROADMAP) will
        use it on the thread side.
    scheduling: thread-backend placement policy — a registry name
        (``"rr"`` | ``"ondemand"`` | ``"worksteal"`` | ``"costmodel"``) or
        a :class:`repro_torch.core.sched.Scheduler` instance/subclass (cloned
        per build, so the IR stays pure data).  The mesh emitter policy is
        round-robin by global item index — see ``dfarm.roundrobin_dest``.
    speculative / straggler_factor / min_straggler_age: straggler re-issue
        (thread backend).
    feedback: wrap-around (collector → emitter) edge, paper Sec. 5, called
        per result as ``feedback(result) -> (emit, tasks)``.  This is the
        thread backend's fully general routing protocol; for a
        backend-neutral loop use :class:`Feedback`.
    """

    def __init__(
        self,
        workers: Any,
        nworkers: Optional[int] = None,
        *,
        emitter: Optional[ff_node] = None,
        collector: Optional[ff_node] = None,
        ordered: bool = False,
        grain: Optional[int] = None,
        scheduling: Any = "rr",
        speculative: bool = False,
        straggler_factor: float = 4.0,
        min_straggler_age: float = 0.05,
        feedback: Optional[Callable[[Any], Tuple[Any, Iterable[Any]]]] = None,
        feedback_capacity: int = 1 << 16,
        queue_class: Optional[Type] = None,
        capacity: Optional[int] = None,
        stats: Optional[FarmStats] = None,
    ):
        if isinstance(workers, (list, tuple)):
            nodes = [_as_node(w) for w in workers]
            nworkers = len(nodes) if nworkers is None else nworkers
        else:
            node = _as_node(workers)
            nworkers = 1 if nworkers is None else nworkers
            nodes = [node] * nworkers
        assert nworkers >= 1 and len(nodes) == nworkers
        from .sched import make_scheduler
        make_scheduler(scheduling)  # raises ValueError on an unknown policy
        assert not (ordered and feedback is not None), \
            "ordering across a wrap-around edge is undefined (tags are " \
            "re-assigned per loop trip) — use ordered=False with feedback"
        self.worker_nodes = nodes
        self.nworkers = nworkers
        self.emitter = emitter
        self.collector = collector
        self.ordered = ordered
        self.grain = grain
        self.scheduling = scheduling
        self.speculative = speculative
        self.straggler_factor = straggler_factor
        self.min_straggler_age = min_straggler_age
        self.feedback = feedback
        self.feedback_capacity = feedback_capacity
        self.queue_class = queue_class
        self.capacity = capacity
        self.stats = stats if stats is not None else FarmStats()


class AllToAll(Skeleton):
    """FastFlow's third core building block (tutorial TR-12-04): ``nleft``
    left workers, each able to route every emission to any of ``nright``
    right workers — the shape that unlocks keyed shuffles, partitioned
    reduction and data-parallel aggregation, none of which Pipeline/Farm
    can express.

    Host lowerings (threads AND procs) wire an **N×M matrix of SPSC
    edges**: each left vertex owns one private ring per right vertex, so
    the single-writer discipline holds with *no arbiter between the
    layers* — the configuration where the paper's per-hand-off overhead
    argument matters most.  Each right vertex counts EOS once per inbound
    edge (fan-in termination), then flushes its node's buffered state
    (:meth:`ff_node.svc_eos`) before its own EOS propagates.

    Parameters
    ----------
    left / right: one ``ff_node``/callable shared by the whole row, or a
        list with one node per vertex.  A single *stateful* node instance
        is shared by reference across the row on the threads backend
        (same convention as ``Farm``); pass a list of fresh instances —
        what :mod:`repro.core.stream_ops` does — for per-vertex state.
        With no upstream edge the left nodes run as sources (``svc(None)``
        until ``None``), the tutorial's generators-into-shuffle shape.
    by: key function for the left→right route: an emission ``x`` lands on
        right vertex ``stable_hash(by(x)) % nright`` (deterministic across
        processes — see :func:`repro.core.a2a.stable_hash`), so every left
        vertex agrees on each key's owner with zero coordination.
        ``None`` degrades to per-left-vertex round-robin (a plain
        repartition).
    ordered: preserve input stream order via the existing tagged-token
        machinery: a tagger assigns stream indices at the scatter, tags
        ride the matrix untouched, and a reorder stage downstream releases
        in index order.  Requires an upstream stream and 1:1 nodes
        (EOS-flushing right nodes cannot be tagged).
    scheduling: how the scatter distributes upstream items over the left
        row — any pick()-based policy (``"rr"``/``"ondemand"``/
        ``"costmodel"``/:class:`~repro_torch.core.sched.KeyAffinity`).
    reduce: optional static keyed-reduction spec
        (:class:`repro.core.stream_ops.KeyedReduce`) that lets the mesh
        backend lower the shuffle to ONE ``shard_map`` program
        (dispatch-by-key exchange + segment reduction); host backends
        ignore it and run the ``right`` nodes.
    """

    def __init__(self, left: Any, right: Any, *, by: Optional[Callable] = None,
                 nleft: Optional[int] = None, nright: Optional[int] = None,
                 ordered: bool = False, scheduling: Any = "rr",
                 reduce: Any = None, grain: Optional[int] = None,
                 name: str = "ff-a2a", queue_class: Optional[Type] = None,
                 capacity: Optional[int] = None):
        def pool(spec: Any, n: Optional[int]) -> Tuple[List[ff_node], int]:
            if isinstance(spec, (list, tuple)):
                nodes = [_as_node(s) for s in spec]
                n = len(nodes) if n is None else n
                assert len(nodes) == n, "node list does not match row width"
                return nodes, n
            n = 1 if n is None else n
            return [_as_node(spec)] * n, n

        from .sched import Scheduler, make_scheduler
        s = make_scheduler(scheduling)  # raises ValueError on unknown policy
        if type(s).place is not Scheduler.place \
                and type(s).route is Scheduler.route:
            raise ValueError(
                f"AllToAll scatter routing supports only pick()/route()-"
                f"based policies (rr / ondemand / costmodel / keyaffinity),"
                f" not the token-holding {s.name!r}")
        self.left_nodes, self.nleft = pool(left, nleft)
        self.right_nodes, self.nright = pool(right, nright)
        assert self.nleft >= 1 and self.nright >= 1
        assert not (ordered and reduce is not None), \
            "a keyed reduction emits per-key folds at EOS — stream order " \
            "across it is undefined; use ordered=False"
        self.by = by
        self.ordered = ordered
        self.scheduling = scheduling
        self.reduce = reduce
        self.grain = grain
        self.name = name
        self.queue_class = queue_class
        self.capacity = capacity
        # telemetry surface (same convention as Farm.stats): budgeted
        # reductions fold spill/backpressure counters in after each run
        self.stats = FarmStats()


class _ReorderNode(ff_node):
    """Buffer ``(i, x)`` pairs and release ``x``s in index order."""

    def __init__(self):
        self._buf: Dict[int, Any] = {}
        self._next = 0

    def svc(self, t):
        idx, value = t
        self._buf[idx] = value
        out = EmitMany()
        while self._next in self._buf:
            out.append(self._buf.pop(self._next))
            self._next += 1
        return out if out else GO_ON

    def svc_eos(self):
        # residue flush: indices skipped upstream (e.g. a GO_ON filter
        # inside an ordered all-to-all) leave a gap that would otherwise
        # strand everything behind it — release in tag order at EOS
        out = EmitMany(self._buf.pop(k) for k in sorted(self._buf))
        return out if out else None


# Loop-plumbing nodes for Feedback.as_thread_net.  These are classes (not
# closures) so the lowered net is picklable: the procs backend ships each
# vertex to a spawned process, and every piece of state below lives in
# exactly one vertex (tagger counter in the tagger's process, trip caps in
# the merge arbiter's), so replication-by-pickle is semantically inert.
class _LoopTagger(ff_node):
    """Attach ``(stream_index, trip_count)`` to each item entering a loop."""

    def __init__(self):
        self._next = 0

    def svc(self, x):
        idx = self._next
        self._next += 1
        return idx, 0, x


class _LoopBody(ff_node):
    """Run the user's worker under the loop's (index, trips) envelope."""

    def __init__(self, node: ff_node):
        self._node = node

    def svc_init(self) -> None:
        self._node.svc_init()

    def svc_end(self) -> None:
        self._node.svc_end()

    def svc(self, task):
        idx, trips, x = task
        return idx, trips + 1, self._node.svc(x)


class _LoopRoute:
    """The wrap-around route: loop while the predicate holds and the trip
    cap allows, else emit ``(index, value)`` for the reorder stage."""

    def __init__(self, pred: Callable[[Any], Any], max_trips: Optional[int]):
        self._pred = pred
        self._cap = max_trips

    def __call__(self, result):
        idx, trips, value = result
        if bool(self._pred(value)) and \
                (self._cap is None or trips < self._cap):
            return None, [result]       # back around the loop
        return (idx, value), []         # leaves the loop


class Feedback(Skeleton):
    """Backend-neutral wrap-around loop: re-apply ``worker`` while
    ``loop_while(result)`` holds, emit the first result for which it is
    false (do-while: every item is serviced at least once).  Unlike the raw
    ``Farm(feedback=route)`` protocol, ``Feedback`` preserves input order
    on both backends.

    Thread lowering: a :class:`Farm` whose ``feedback=`` route sends
    still-looping results back over the wrap-around SPSC ring (paper
    Sec. 5), bracketed by an index tagger and a reorder stage; termination
    by loop quiescence.  Mesh lowering: a masked ``lax.while_loop`` between
    the farm's dispatch and ordered combine (``dfarm.farm_until``) — the
    wrap-around ring becomes the loop carry.

    ``loop_while`` must be jax-traceable for the mesh backend (on the
    thread backend any callable returning truthy works).  ``max_trips``
    bounds the trip count on BOTH backends (``None`` = loop until the
    predicate releases the item): a still-looping result is emitted as-is
    once it has been serviced ``max_trips`` times.
    """

    def __init__(self, worker: Any, loop_while: Callable[[Any], Any], *,
                 nworkers: int = 1, max_trips: Optional[int] = None,
                 scheduling: Any = "rr", grain: Optional[int] = None,
                 name: str = "ff-feedback"):
        from .sched import make_scheduler
        make_scheduler(scheduling)  # raises ValueError on an unknown policy
        self.node = _as_node(worker)
        self.loop_while = loop_while
        self.nworkers = nworkers
        self.max_trips = max_trips
        self.scheduling = scheduling
        self.grain = grain
        self.name = name

    def as_thread_net(self) -> "Pipeline":
        """The predicate loop as a wrap-around farm (threads AND procs
        backends — both host graph runtimes share this lowering).

        The wrap-around ring emits in *completion* order (loop tags are
        re-assigned per trip), but the :class:`Feedback` contract — like the
        mesh lowering, whose ``(dest, pos)`` tags survive the while_loop —
        is input order.  So items carry a stream index and a trip counter
        through the loop (the counter enforces ``max_trips``, mirroring the
        mesh ``while_loop`` bound) and a reorder stage restores order
        downstream.  The plumbing nodes are picklable classes
        (:class:`_LoopTagger` / :class:`_LoopBody` / :class:`_LoopRoute`),
        never closures, so the procs backend can ship them to spawned
        vertex processes."""
        return Pipeline(
            Stage(_LoopTagger(), name=f"{self.name}-tagger"),
            Farm(_LoopBody(self.node), self.nworkers,
                 feedback=_LoopRoute(self.loop_while, self.max_trips),
                 scheduling=self.scheduling),
            Stage(_ReorderNode(), name=f"{self.name}-reorder"),
        )


# ---------------------------------------------------------------------------
# grain-aware stage fusion (IR -> IR rewrite for the threads lowering)
# ---------------------------------------------------------------------------
def _stage_fusible(s: "Skeleton", threshold_us: Optional[float],
                   force: bool) -> bool:
    if not isinstance(s, Stage):
        return False
    if force:
        return True
    return (s.grain is not None and threshold_us is not None
            and s.grain < threshold_us)


def _stateless(node: ff_node) -> bool:
    """Conservatively 'safe to replicate across farm workers': FnNode
    wrappers (pure-callable convention) and fusions thereof."""
    if isinstance(node, FusedNode):
        return all(_stateless(n) for n in node.nodes)
    return isinstance(node, FnNode)


def _merge_stages(a: "Stage", b: "Stage") -> "Stage":
    def parts(s: "Stage") -> List[ff_node]:
        n = s.node
        return list(n.nodes) if isinstance(n, FusedNode) and n.flatten else [n]

    # the fused stage's grain is the combined per-item work, so a run of
    # fine-grain stages stops merging once the fusion itself gets coarse
    grain = (a.grain + b.grain
             if a.grain is not None and b.grain is not None else None)
    return Stage(FusedNode(parts(a) + parts(b)),
                 name=f"fuse({a.name}+{b.name})", grain=grain)


def _farm_can_absorb(farm: "Farm", stage: "Stage") -> bool:
    # feedback would re-apply the stage every loop trip; a collector node
    # runs between merge and the stage, so absorbing would reorder them;
    # a stateful stage node cannot be replicated across workers.
    return (farm.feedback is None and farm.collector is None
            and _stateless(stage.node))


def _chain_parts(node: ff_node) -> List[ff_node]:
    return (list(node.nodes)
            if isinstance(node, FusedNode) and node.flatten else [node])


def _absorb_one(worker: ff_node, snode: ff_node) -> FusedNode:
    """Fuse ``snode`` behind ``worker``: flatten=False exactly at the
    worker/stage junction (the collector crossing), while repeated
    absorptions keep the stage side one flatten=True chain (stage-to-stage
    EmitMany flattening is preserved between absorbed stages)."""
    if isinstance(worker, FusedNode) and not worker.flatten:
        head, tail = worker.nodes[0], worker.nodes[1]
        parts = _chain_parts(tail) + _chain_parts(snode)
        return FusedNode([head, FusedNode(parts)], flatten=False)
    return FusedNode([worker, snode], flatten=False)


def _absorb_stage_into_farm(farm: "Farm", stage: "Stage") -> "Farm":
    return Farm(
        [_absorb_one(w, stage.node) for w in farm.worker_nodes],
        emitter=farm.emitter, ordered=farm.ordered, grain=farm.grain,
        scheduling=farm.scheduling, speculative=farm.speculative,
        straggler_factor=farm.straggler_factor,
        min_straggler_age=farm.min_straggler_age,
        queue_class=farm.queue_class, capacity=farm.capacity,
        stats=farm.stats)


def _farm_fusible(f: "Skeleton", threshold_us: Optional[float],
                  force: bool) -> bool:
    if not isinstance(f, Farm):
        return False
    if force:
        return True
    return (f.grain is not None and threshold_us is not None
            and f.grain < threshold_us)


def _farms_mergeable(a: "Farm", b: "Farm") -> bool:
    """Farm∘Farm is collapsible when the junction between them carries no
    semantics of its own: no wrap-around loop on either side (the fused
    worker would re-run both nodes every trip), no collector on ``a`` / no
    emitter on ``b`` (both run *between* the farms, which fusion removes),
    no speculation (a re-issued fused task would redo both halves), equal
    ``ordered`` (a's merge establishes the order b's dispatch re-tags —
    fusing an ordered with an unordered farm would invent or destroy an
    ordering the unfused network had), and every worker stateless (the
    fused farm replicates ``max(nworkers)`` copies).  ``b``'s workers must
    be plain chains, not already-absorbed ``flatten=False`` junctions
    (their ``_FarmEmitMany`` flattening belongs to b's own merge)."""
    return (a.feedback is None and b.feedback is None
            and a.collector is None and b.emitter is None
            and not a.speculative and not b.speculative
            and a.ordered == b.ordered
            and all(_stateless(n) for n in a.worker_nodes)
            and all(_stateless(n) for n in b.worker_nodes)
            and all(not (isinstance(n, FusedNode) and not n.flatten)
                    for n in b.worker_nodes))


def _merge_farms(a: "Farm", b: "Farm") -> "Farm":
    """ONE farm of fused workers: worker i runs a's node then b's
    (``_absorb_one`` — the same worker∘stage junction semantics the
    farm-absorb rewrite uses, so a ``GO_ON`` from a's half retires the
    token exactly as a's merge would have, and a multi-emit from a's half
    crosses into b's node whole, as b's dispatch would have seen it).
    ``a``'s scheduling/emitter and ``b``'s collector-free tail survive;
    ``b``'s scheduling is subsumed by the fused dispatch."""
    n = max(a.nworkers, b.nworkers)
    workers = [_absorb_one(a.worker_nodes[i % a.nworkers],
                           b.worker_nodes[i % b.nworkers])
               for i in range(n)]
    grain = (a.grain + b.grain
             if a.grain is not None and b.grain is not None else None)
    return Farm(workers, emitter=a.emitter, ordered=a.ordered, grain=grain,
                scheduling=a.scheduling,
                queue_class=a.queue_class or b.queue_class,
                capacity=a.capacity or b.capacity, stats=a.stats)


def _a2a_can_absorb(a2a: "Skeleton", stage: "Stage") -> bool:
    """A stateless post-shuffle stage can sink into the right row when the
    rewrite is invisible: unordered (the ordered reorder stage runs *after*
    the rights — absorbing under it would re-tag flush items), no
    ``reduce=`` spec (the mesh shuffle program runs the spec INSTEAD of the
    right nodes, so an absorbed stage would silently vanish there), and no
    batch-aware or budget-carrying right nodes (the ``FusedNode`` wrapper
    would hide ``accepts_batches``/``budget`` from the vertex and the
    budget-board plumbing — see :func:`repro.core.a2a._a2a_budgets`)."""
    return (isinstance(a2a, AllToAll) and not a2a.ordered
            and a2a.reduce is None and _stateless(stage.node)
            and not any(getattr(n, "accepts_batches", False)
                        or getattr(n, "budget", None) is not None
                        for n in a2a.right_nodes))


def _absorb_stage_into_a2a(a2a: "AllToAll", stage: "Stage") -> "AllToAll":
    """Rebuild the shuffle with the stage chained behind every right-row
    vertex (flatten=True: the rights ARE stage vertices, so stage∘stage
    chain semantics apply — including ``svc_eos`` flush items streaming
    through the absorbed stage, exactly as the separate vertex saw them)."""
    rights = [FusedNode(_chain_parts(n) + _chain_parts(stage.node))
              for n in a2a.right_nodes]
    new = AllToAll(a2a.left_nodes, rights, by=a2a.by, nleft=a2a.nleft,
                   nright=a2a.nright, ordered=False,
                   scheduling=a2a.scheduling, reduce=None, grain=a2a.grain,
                   name=a2a.name, queue_class=a2a.queue_class,
                   capacity=a2a.capacity)
    new.stats = a2a.stats  # telemetry identity survives the rewrite
    return new


def fuse(skel: Any, *, threshold_us: Optional[float] = None,
         force: bool = False) -> "Skeleton":
    """Grain-aware fusion pass (ROADMAP "graph-level fusion"): rewrite the
    IR so hand-offs that cost more than the work they move disappear.

    Two rewrites, applied left-to-right over a :class:`Pipeline`:

    * **stage ∘ stage** — adjacent ``Stage``\\ s whose declared ``grain=``
      (per-item service time, µs, the threads-side reading of the grain
      attribute; the mesh backend reads it as microbatch rows) is below
      ``threshold_us`` collapse into one vertex running a
      :class:`FusedNode` chain.  The merged stage's grain is the sum, so
      runs stop merging once the fusion itself gets coarse.
    * **farm ∘ trailing stage** — a ``Farm`` followed by a sub-threshold
      stateless ``Stage`` absorbs it into every worker (the hand-off
      through the collector ring disappears; ordering still holds because
      tags reorder at the merge arbiter regardless of what ran in the
      worker).  Farms with ``feedback=`` or a collector node, and stateful
      stage nodes, are never absorbed.

    Two more rewrites landed with the autotune pass (ROADMAP "self-tuning
    runtime"), both driven by the same grain-vs-threshold test:

    * **farm ∘ farm** — adjacent ``Farm``\\ s whose grains BOTH sit under
      the threshold collapse into ONE farm of :class:`FusedNode` workers
      (``_merge_farms``): four arbiters and a full ring layer become two
      arbiters, and each item pays one dispatch instead of two.  Requires
      stateless workers, matching ``ordered``, and a semantically empty
      junction (no collector on the left / emitter on the right, no
      feedback, no speculation) — see :func:`_farms_mergeable`.
    * **a2a ∘ trailing stage** — a sub-threshold stateless ``Stage`` after
      an *unordered, spec-free* :class:`AllToAll` sinks into every
      right-row vertex (``_absorb_stage_into_a2a``), removing the M→1
      fan-in hand-off behind the shuffle.

    ``force=True`` fuses every adjacent eligible pair regardless of grain
    (used by tests/benchmarks to pin behaviour); the default ``"auto"``
    mode of ``lower(skel, "threads")`` calls this with the calibrated
    hand-off threshold (:func:`repro_torch.core.sched.calibrate_handoff_us`)
    only when some stage actually declares a grain — skeletons that don't
    opt in are untouched.

    An :class:`AllToAll` otherwise stays a hard fusion boundary: merging a
    stage into (or across) the shuffle's scatter side, an *ordered* or
    ``reduce=``-carrying shuffle, or a budgeted right row would change
    what the N×M matrix computes or hide the budget/batch plumbing — only
    the narrow right-row absorption above is ever applied, and
    ``tests/test_a2a.py`` pins that a ``reduce_by_key`` shuffle is
    untouched even under ``force=True``.
    """
    skel = as_skeleton(skel)
    if not isinstance(skel, Pipeline):
        return skel
    out: List[Skeleton] = []
    for s in skel.stages:
        prev = out[-1] if out else None
        if _stage_fusible(s, threshold_us, force):
            if isinstance(prev, Stage) and _stage_fusible(prev, threshold_us,
                                                          force):
                out[-1] = _merge_stages(prev, s)
                continue
            if isinstance(prev, Farm) and _farm_can_absorb(prev, s):
                out[-1] = _absorb_stage_into_farm(prev, s)
                continue
            if isinstance(prev, AllToAll) and _a2a_can_absorb(prev, s):
                out[-1] = _absorb_stage_into_a2a(prev, s)
                continue
        elif _farm_fusible(s, threshold_us, force) \
                and _farm_fusible(prev, threshold_us, force) \
                and _farms_mergeable(prev, s):
            out[-1] = _merge_farms(prev, s)
            continue
        out.append(s)
    return out[0] if len(out) == 1 else Pipeline(*out)


def _has_grained_stage(skel: "Skeleton") -> bool:
    if isinstance(skel, Pipeline):
        return any(_has_grained_stage(s) for s in skel.stages)
    return isinstance(skel, Stage) and skel.grain is not None


_fuse_pass = fuse  # ThreadProgram's `fuse=` parameter shadows the name


# ---------------------------------------------------------------------------
# lowering: backend registry + programs
# ---------------------------------------------------------------------------
class LoweringError(ValueError):
    """A skeleton uses a feature its target backend cannot express."""


BACKENDS: Dict[str, Type] = {}


def lower(skel: Any, backend: str = "threads", **opts: Any):
    """Lower a skeleton to an executable program on ``backend``.

    Programs are callables: ``lower(skel, b)(items)`` runs the finite
    stream ``items`` through the network and returns the output list.
    Backends are a registry (``BACKENDS``) so scheduling policies and
    fused runtimes can plug in without touching the IR.

    ``tune=True`` makes the compile two-phase: the first call runs a
    bounded pilot slice of the stream through an instrumented threads
    lowering, records per-stage service times / queue high-water marks /
    hand-off cost into a :class:`repro_torch.core.autotune.Profile`,
    re-lowers via ``retune()`` with measured grains and ring capacities,
    and runs the remainder (plus all later calls) through the tuned
    program.  ``tune_pilot=`` bounds the pilot slice (item count);
    ``profile=`` skips the pilot entirely and re-lowers from a
    saved/loaded Profile.
    """
    skel = as_skeleton(skel)
    tune = opts.pop("tune", False)
    tune_pilot = opts.pop("tune_pilot", None)
    profile = opts.pop("profile", None)
    if tune or profile is not None:
        from .autotune import TunedProgram
        return TunedProgram(skel, backend, pilot=tune_pilot,
                            profile=profile, opts=opts)
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise LoweringError(
            f"unknown backend {backend!r} (have {sorted(BACKENDS)})") from None
    return cls(skel, **opts)


def walk_stats(skel: Skeleton, path: str = "") -> Iterable[Tuple[str, Any]]:
    """Yield ``(qualname, FarmStats)`` for every stats-carrying node in
    the IR tree — the walk a :class:`~repro_torch.core.obs.RunReport` absorbs.
    Keys are IR-path qualified (``ff-farm@1``), so two farms in one
    pipeline land in separate report rows."""
    if isinstance(skel, Pipeline):
        for i, s in enumerate(skel.stages):
            yield from walk_stats(s, f"{path}.{i}" if path else str(i))
    elif isinstance(skel, Farm):
        yield _obs_qualname("ff-farm", path), skel.stats
    elif isinstance(skel, AllToAll):
        yield _obs_qualname(skel.name, path), skel.stats


def _coerce_tracer(trace: Any) -> Optional[Tracer]:
    if isinstance(trace, Tracer):
        return trace
    return Tracer() if trace else None


def _coerce_metrics(metrics: Any) -> Optional[MetricsRegistry]:
    if isinstance(metrics, MetricsRegistry):
        return metrics
    return MetricsRegistry() if metrics else None


def _coerce_monitor(monitor: Any):
    """``monitor=`` on lower(): None/False -> off, True -> a fresh
    default :class:`~repro_torch.core.monitor.Monitor`, an instance ->
    shared.  The import is lazy so ``monitor=None`` programs never touch
    monitor.py at all."""
    if not monitor:
        return None
    from .monitor import Monitor
    if isinstance(monitor, Monitor):
        return monitor
    return Monitor()


class ThreadProgram:
    """Threads lowering: the skeleton wired onto the graph runtime (one
    thread per vertex, lock-free SPSC rings for every edge).

    ``fuse`` controls the grain-aware fusion pass: ``"auto"`` (default)
    collapses hand-offs whose declared stage ``grain=`` is below the
    calibrated threshold (``fuse_threshold_us``, or the measured per-item
    hand-off cost when None — calibration only runs if some stage declares
    a grain); ``True`` force-fuses every eligible adjacent pair; ``False``
    disables the pass.

    ``trace=True`` (or a :class:`~repro_torch.core.obs.Tracer`) gives every
    vertex a sampled event lane; the merged
    :class:`~repro_torch.core.obs.Trace` lands on ``last_trace`` after each
    call.  ``metrics=True`` (or a
    :class:`~repro_torch.core.obs.MetricsRegistry`) samples queue depths
    while the run drains and absorbs the skeleton's ``FarmStats`` into a
    :class:`~repro_torch.core.obs.RunReport` on ``last_report``.

    ``monitor=True`` (or a :class:`~repro_torch.core.monitor.Monitor`)
    attaches the continuous live sampler for the duration of each call:
    queue depths, farm EWMAs and counters land in ``monitor.timeline``
    while the stream runs — see :mod:`repro_torch.core.monitor`."""

    backend = "threads"

    def __init__(self, skeleton: Skeleton, *,
                 queue_class: Optional[Type] = None, capacity: int = 512,
                 fuse: Any = "auto", fuse_threshold_us: Optional[float] = None,
                 trace: Any = False, metrics: Any = False,
                 monitor: Any = None):
        if fuse and isinstance(skeleton, Pipeline):
            force = fuse is True
            thr = fuse_threshold_us
            if not force and thr is None and _has_grained_stage(skeleton):
                from .sched import calibrate_handoff_us
                thr = calibrate_handoff_us()
            skeleton = _fuse_pass(skeleton, threshold_us=thr, force=force)
        self.skeleton = skeleton
        self.queue_class = queue_class
        self.capacity = capacity
        self.tracer = _coerce_tracer(trace)
        self.metrics = _coerce_metrics(metrics)
        self.monitor = _coerce_monitor(monitor)
        self.last_trace = None
        self.last_report = None

    def to_graph(self, stream: Optional[Iterable[Any]] = None):
        from . import graph  # the threads backend (vertex machinery)
        from .spsc import SPSCQueue
        g = graph.Graph(queue_class=self.queue_class or SPSCQueue,
                        capacity=self.capacity)
        # a live monitor wants per-worker service EWMAs: opt the farm
        # workers into the timing they otherwise skip (same flag the
        # procs backend uses to arm its live counter boards)
        g.live_telemetry = self.monitor is not None
        # Build the driving Source separately (at path "in") so the user
        # skeleton keeps its root IR paths — telemetry keys vertices by
        # path, and wrapping in a fresh Pipeline would shift every
        # top-level index by one.
        in_ring = None
        if stream is not None:
            in_ring = graph.build(Source(stream), g, None, False, "in")
        graph.build(self.skeleton, g, in_ring, True)
        if self.tracer is not None:
            g.tracer = self.tracer
        return g

    def __call__(self, items: Iterable[Any]) -> List[Any]:
        xs = list(items)
        g = self.to_graph(xs)
        reg = self.metrics
        mon = self.monitor
        if mon is not None:
            mon.attach(g, skeleton=self.skeleton, backend="threads")
        try:
            if reg is None:
                out = g.run_and_wait()
            else:
                hw: Dict[str, int] = {}
                t0 = time.monotonic()
                # a short run can finish before the first poll below: the
                # drain sampler runs inside wait() after the vertex threads
                # join but before teardown, so every edge key still lands
                # exactly once — and never races the caller's results drain
                g.drain_samplers.append(lambda: g.sample_high_water(hw))
                g.run()
                while any(t.is_alive() for t in g._threads):
                    g.sample_high_water(hw)
                    time.sleep(0.0005)
                out = g.wait()
                farms = {q: farm_stats_snapshot(st)
                         for q, st in walk_stats(self.skeleton)}
                self.last_report = reg.finalize(reg.report(
                    farms=farms, queues=hw,
                    meta={"backend": "threads", "vertices": len(g.vertices),
                          "items_in": len(xs), "items_out": len(out),
                          "wall_s": time.monotonic() - t0}))
        finally:
            if mon is not None:
                mon.detach()
        if self.tracer is not None:
            self.last_trace = self.tracer.trace()
        return out


BACKENDS["threads"] = ThreadProgram


# ---------------------------------------------------------------------------
# mesh lowering: one device program for the whole skeleton
# ---------------------------------------------------------------------------
@dataclass
class _MeshStage:
    # NOTE: no per-stage worker count — mesh parallelism is always the
    # negotiated worker-axis size (see the Farm docstring)
    kind: str                                  # "map" | "farm" | "feedback"
    fn: Callable
    loop_while: Optional[Callable] = None
    max_trips: Optional[int] = None


def _tensor_callable(node: ff_node) -> Callable:
    """The tensor function behind a node (FnNode unwraps)."""
    return node._fn if isinstance(node, FnNode) else node.svc


def _mesh_plan(skel: Skeleton) -> List[_MeshStage]:
    """Flatten a skeleton into the mesh backend's stage list, rejecting
    host-only features instead of silently approximating them."""
    if isinstance(skel, Pipeline):
        return [ms for s in skel.stages for ms in _mesh_plan(s)]
    if isinstance(skel, Stage):
        return [_MeshStage("map", _tensor_callable(skel.node))]
    if isinstance(skel, Feedback):
        return [_MeshStage("feedback", _tensor_callable(skel.node),
                           loop_while=skel.loop_while,
                           max_trips=skel.max_trips)]
    if isinstance(skel, Farm):
        if skel.feedback is not None:
            raise LoweringError(
                "Farm(feedback=route) is the thread backend's general "
                "routing protocol; use Feedback(worker, loop_while) for a "
                "backend-neutral wrap-around loop")
        if skel.emitter is not None or skel.collector is not None:
            raise LoweringError(
                "emitter/collector nodes are host-side arbiters; the mesh "
                "farm's dispatch/combine replace them")
        if len({id(n) for n in skel.worker_nodes}) != 1:
            raise LoweringError(
                "mesh farms are SPMD: all workers must share one function")
        return [_MeshStage("farm", _tensor_callable(skel.worker_nodes[0]))]
    if isinstance(skel, Source):
        raise LoweringError(
            "a mesh program takes its stream as the call argument; drop "
            "the Source stage")
    raise LoweringError(f"cannot lower {skel!r} to the mesh backend")


def _skeleton_grain(skel: Skeleton) -> Optional[int]:
    if isinstance(skel, Pipeline):
        for s in skel.stages:
            g = _skeleton_grain(s)
            if g:
                return g
        return None
    return getattr(skel, "grain", None)


def _mesh_devices(devices: Optional[int], device: Any) -> int:
    """The devices a mesh program spans: ``devices=`` when given, else
    the CUDA cards for the default device (``device=None``, as the
    reference takes ``jax.devices()``), else one."""
    if devices is not None:
        if devices < 1:
            raise LoweringError(f"devices must be at least 1, got {devices}")
        return devices
    if device is None:
        from .dfarm import device_count
        return max(1, device_count())
    return 1


def _devices_args(n_stage: int, n_worker: int,
                  transport: Optional[str]) -> Dict[str, Any]:
    """The ``devices`` instant of a mesh program's trace lane."""
    args: Dict[str, Any] = {"devices": n_stage * n_worker,
                            "n_stage": n_stage, "n_worker": n_worker}
    if n_stage * n_worker > 1:
        args["transport"] = transport or "nccl"
    return args


def _rank_plan(world: int, device: Any, transport: Optional[str],
               fns: Any) -> List[str]:
    """Check that a program over ``world`` rank processes can run: the
    layout and transport (:func:`~repro_torch.core.ranks.plan_ranks`), and
    that its functions pickle — each rank process imports them by name.
    Returns the ranks' devices."""
    import pickle
    from .ranks import plan_ranks
    devices, _ = plan_ranks(world, device, transport)
    try:
        pickle.dumps(fns)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise LoweringError(
            f"a mesh program over {world} devices runs its stage functions "
            f"in rank processes, so they must be picklable (module-level "
            f"functions, functools.partial, or ff_node subclasses — not "
            f"lambdas or closures): {e!r}") from e
    return devices


class MeshProgram:
    """Mesh lowering: the whole skeleton as ONE device program.

    A 2-D ``(stage, worker)`` mesh is negotiated from the device count
    (``devices=``, default the CUDA cards; ``dpipeline.
    negotiate_stage_axis``), or taken from ``factorization=`` under the
    reference's rules.  On one device (``device=``: ``None`` is the CUDA
    card and raises without one, ``"cpu"`` the plain path) the stage
    chain runs in order inside one program — each farm through
    ``dfarm.farm_map`` (dispatch, worker, ordered combine), each
    wrap-around loop through ``dfarm.farm_until`` (a host loop that reads
    the continue flag once a trip), with no host hop between stages.

    Over more devices the program runs in one rank process per device
    (:func:`~repro_torch.core.ranks.pool`, shared by the process's mesh
    programs; ``transport=`` as :func:`~repro_torch.core.ranks.
    plan_ranks`: more ranks than cards need ``transport="gloo"``).  Each
    worker column takes its contiguous shard of the packed rows.  With
    one stage row the chain runs in order, each farm dispatching over the
    row's workers; with one row per stage, each row runs its own stage
    and microbatches of ``grain`` rows stream down the columns through
    ``pipeline_apply``.  The rank processes import the stage functions by
    name, so they must be picklable (a lambda raises
    :class:`LoweringError` here, at construction).

    Items are packed host-side into a ``(rows, d)`` array (scalars become
    ``d=1``), padded to a row bucket (power of two floored at ``block``,
    aligned to ``grain``, so repeated calls with nearby sizes reuse the
    program) with a validity-flag column, moved to the device, and
    unpacked in order on the way out as Python scalars or lists.  One
    program is built per ``(rows, d, dtype)`` bucket: a plain function
    closed over the plan, counted in ``mesh.compiles``.

    Observability as the reference's: ``trace=`` gives a ``mesh-program``
    lane with a ``devices`` instant (with the transport over ranks) and
    ``compile``/``call`` spans (the first compile over ranks includes
    starting them); ``metrics=`` the ``mesh.calls``, ``mesh.items``,
    ``mesh.devices``,
    ``mesh.call_us`` and ``mesh.compiles`` metrics; ``monitor=`` one
    :meth:`~repro_torch.core.monitor.Monitor.program_frame` per call.
    """

    backend = "mesh"

    def __init__(self, skeleton: Skeleton, *, devices: Optional[int] = None,
                 grain: Optional[int] = None, capacity: Optional[int] = None,
                 block: int = 64,
                 factorization: Optional[Tuple[int, int]] = None,
                 trace: Any = False, metrics: Any = False,
                 monitor: Any = None, device: Any = None,
                 transport: Optional[str] = None):
        from . import dfarm, dpipeline

        self.skeleton = skeleton
        self.stages = _mesh_plan(skeleton)
        assert self.stages, "empty skeleton"
        self.grain = grain if grain is not None else _skeleton_grain(skeleton)
        self.capacity = capacity
        self.block = block
        ndev = _mesh_devices(devices, device)
        if factorization is not None:
            # autotune override (plan_mesh): the pipelined path still
            # requires n_stage == len(stages), so only (1, ndev) or
            # (len(stages), ndev // len(stages)) are legal here.
            n_stage, n_worker = factorization
            if n_stage not in (1, len(self.stages)) \
                    or n_stage * n_worker > ndev or n_worker < 1:
                raise LoweringError(
                    f"factorization {factorization} is not expressible on "
                    f"{ndev} devices for {len(self.stages)} stages")
            self.n_stage, self.n_worker = n_stage, n_worker
        else:
            self.n_stage, self.n_worker = dpipeline.negotiate_stage_axis(
                len(self.stages), ndev)
        world = self.n_stage * self.n_worker
        self.transport = transport
        self.pool = None         # the rank processes, once started
        if world > 1:
            self.rank_devices = _rank_plan(world, device, transport,
                                           self.stages)
            self.device = device
        else:
            self.rank_devices = None
            self.device = dfarm.resolve_device(device)
        self._programs: Dict[Tuple[int, int, str], Callable] = {}
        # observability: a mesh run has no host vertices, so the trace is
        # program-level — one "mesh-program" lane carrying a devices
        # instant, one compile span per cache miss, one call span per run
        self.tracer = _coerce_tracer(trace)
        self.metrics = _coerce_metrics(metrics)
        # live monitoring: no host vertices to sample, so each call pushes
        # one program-level counter frame (Monitor.program_frame)
        self.monitor = _coerce_monitor(monitor)
        self._mon_calls = 0
        self._mon_items = 0
        self.last_trace = None
        self.last_report = None
        self._lane = None
        if self.tracer is not None:
            self._lane = self.tracer.vertex("mesh-program")
            self._lane.instant("devices", _devices_args(
                self.n_stage, self.n_worker, transport))

    # -- host-side packing ---------------------------------------------------
    def _bucket_rows(self, n: int) -> int:
        """Per-device row count: enough for ``n`` items over the worker
        axis, floored at ``block`` and rounded to a power of two (bounds
        the programs built), then aligned to the microbatch grain."""
        rows = max(-(-n // self.n_worker), 1, self.block)
        rows = 1 << (rows - 1).bit_length()
        if self.grain:
            rows = self.grain * (-(-rows // self.grain))
        return rows

    def __call__(self, items: Iterable[Any]) -> List[Any]:
        from . import dfarm

        xs = list(items)
        if not xs:
            return []
        arr = dfarm.pack(xs, "the threads backend computes exact Python ints")
        squeeze = arr.ndim == 1
        if squeeze:
            arr = arr[:, None]
        if arr.ndim != 2:
            raise LoweringError("mesh payloads must be scalars or 1-D items")
        n, d = arr.shape
        rows = self._bucket_rows(n)
        # last column is the validity flag (dfarm.pad)
        padded = dfarm.pad(arr, self.n_worker * rows)
        prog = self._program(rows, d, str(arr.dtype))
        t0 = time.monotonic()
        out = prog(padded)
        t1 = time.monotonic()
        if self._lane is not None:
            self._lane.span("call", t0, t1, {"items": n, "rows": rows})
            self.last_trace = self.tracer.trace()
        if self.metrics is not None:
            reg = self.metrics
            reg.counter("mesh.calls").inc()
            reg.counter("mesh.items").inc(n)
            reg.gauge("mesh.devices").set(self.n_stage * self.n_worker)
            reg.histogram("mesh.call_us").observe((t1 - t0) * 1e6)
            self.last_report = reg.finalize(reg.report(
                meta={"backend": "mesh", "n_stage": self.n_stage,
                      "n_worker": self.n_worker}))
        if self.monitor is not None:
            self._mon_calls += 1
            self._mon_items += n
            self.monitor.program_frame({
                "mesh.calls": self._mon_calls,
                "mesh.items": self._mon_items,
                "mesh.compiles": len(self._programs),
                "mesh.devices": self.n_stage * self.n_worker,
                "mesh.call_us": (t1 - t0) * 1e6})
        return dfarm.unpack(out, n, d, squeeze)

    # -- the single device program -------------------------------------------
    def _program(self, rows: int, d: int, dtype: str) -> Callable:
        key = (rows, d, dtype)
        if self.pool is not None and self.pool.closed:
            self._programs.clear()   # a failed call closed the ranks: restart
        if key in self._programs:
            return self._programs[key]
        t_compile = time.monotonic()
        from . import dfarm
        if self.rank_devices is None:
            program = dfarm.chain_program(self.stages, self.n_worker,
                                          self.capacity, self.device)
        else:
            from . import ranks
            self.pool = ranks.pool(self.n_stage * self.n_worker,
                                   device=self.device,
                                   transport=self.transport)
            program = dfarm.rank_chain_program(
                self.stages, self.n_stage, self.n_worker, self.capacity,
                self.grain, rows, self.pool)
        self._programs[key] = program
        if self._lane is not None:
            self._lane.span("compile", t_compile, time.monotonic(),
                            {"rows": rows, "d": d, "dtype": dtype})
        if self.metrics is not None:
            self.metrics.counter("mesh.compiles").inc()
        return program


def _contains_a2a(skel: Skeleton) -> bool:
    if isinstance(skel, Pipeline):
        return any(_contains_a2a(s) for s in skel.stages)
    return isinstance(skel, AllToAll)


def _mesh_backend(skeleton: Skeleton, **opts: Any):
    """Mesh-backend factory: skeletons containing an :class:`AllToAll`
    compile to the keyed-shuffle program (:class:`repro_torch.core.a2a.
    A2AMeshProgram` — dispatch-by-key exchange + segment reduction in one
    device program); everything else to :class:`MeshProgram`."""
    if _contains_a2a(skeleton):
        from .a2a import A2AMeshProgram
        return A2AMeshProgram(skeleton, **opts)
    return MeshProgram(skeleton, **opts)


BACKENDS["mesh"] = _mesh_backend
