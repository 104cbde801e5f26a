"""All-to-all subsystem — the keyed-shuffle lowerings of :class:`AllToAll`.

The port's copy of ``repro.core.a2a``: its threads, procs and mesh
lowerings.

FastFlow's tutorial (TR-12-04) makes **all-to-all** the third core
building block next to pipeline and farm: N left workers, each able to
route every emission to any of M right workers.  It is the shape that
keyed shuffles, partitioned reduction and data-parallel aggregation (the
parquet-aggregator workload) are made of, and the configuration where the
paper's per-hand-off overhead argument bites hardest — a single streamed
item crosses ``O(1)`` edges, but the *network* holds ``N×M`` of them.

**threads / procs** (:func:`build_thread_a2a` / :func:`build_proc_a2a`)
    An N×M matrix of SPSC rings.  Each left vertex owns one private ring
    per right vertex, so the single-writer discipline of the whole runtime
    survives with *no arbiter between the layers*: routing is a pure
    function of the emission (``stable_hash(by(x)) % nright``) computed in
    the producing vertex, and termination is per-edge EOS fan-in counting
    at each right vertex (a right vertex EOSes only after all N of its
    inbound edges have).  ``ordered=`` composes with the existing
    tagged-token machinery: a tagger at the scatter, tags riding the
    matrix untouched, a reorder stage downstream.

Routing determinism matters more here than anywhere else in the runtime:
two left vertices in *different processes* must agree where key ``"a"``
lives, so the route hashes with :func:`stable_hash`, never the
interpreter-salted builtin ``hash``.

**mesh** (:class:`A2AMeshProgram`)
    A keyed shuffle as ONE device program, for skeletons carrying a
    static keyed-reduction spec (:class:`repro_torch.core.stream_ops.
    KeyedReduce`): map stages apply elementwise, keys pick a destination
    worker (``key % W``), :func:`repro_torch.core.dfarm.dispatch` moves
    every row to its key's owner, and a segment reduction
    (``index_add_``/``scatter_reduce``) over the static key space folds
    each partition.  On one device ``W`` is 1 and the exchange is the
    identity; over ``devices > 1`` each worker is a rank process
    (:mod:`.ranks`) and the exchange one ``all_to_all_single``.
"""
from __future__ import annotations

import math
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import graph as _graph
from . import procgraph as _procgraph
from .skeleton import (GO_ON, AllToAll, EmitMany, FnNode, KeyBatch,
                       LoweringError, Pipeline, Skeleton, Stage, _ReorderNode,
                       _coerce_metrics, _coerce_tracer, _devices_args,
                       _mesh_devices, _rank_plan, _tensor_callable, ff_node)

__all__ = [
    "stable_hash", "KeyRouter", "build_thread_a2a", "build_proc_a2a",
    "A2AMeshProgram",
]


def stable_hash(key: Any) -> int:
    """Deterministic, process-independent hash for shuffle routing.

    Python's builtin ``hash`` is salted per interpreter (PYTHONHASHSEED),
    so two left vertices running as *processes* (the procs backend) would
    route the same string key to different right vertices — silently
    splitting every key's partition across workers.  Route on a stable
    digest instead: ints map to themselves (so mod-partitioning stays the
    obvious one); str/bytes/float via crc32 of a canonical encoding;
    tuples recursively; frozensets order-independently (their iteration
    order is itself hash-salted).  Any other type raises — a default
    ``repr`` embeds the object's address, which would differ per process
    (and per object) and silently split partitions; route on a canonical
    key (int / str / tuple of those) instead.  Tensors and numpy scalars
    are refused the same way (``numpy.float64`` is a ``float`` and hashes
    as one): route on their ``.tolist()`` values.
    """
    if isinstance(key, bool):
        return int(key)
    if isinstance(key, int):
        return key
    if isinstance(key, bytes):
        return zlib.crc32(key)
    if isinstance(key, str):
        return zlib.crc32(key.encode("utf-8"))
    if key is None:
        return 0
    if isinstance(key, float):
        # hash-consistency with dict equality: 3.0 == 3 and -0.0 == 0.0,
        # and the fold dict at the right vertex merges them — so they must
        # route identically too, or one logical key splits across workers
        if math.isfinite(key) and key == int(key):
            return int(key)
        return zlib.crc32(repr(key).encode("utf-8"))  # repr is canonical
    if isinstance(key, tuple):
        acc = 1
        for k in key:
            # decimal repr of the element hash: canonical and unbounded
            # (int keys hash to themselves, at any magnitude)
            acc = zlib.crc32(b"%d," % stable_hash(k), acc)
        return acc
    if isinstance(key, frozenset):
        return sum(stable_hash(k) for k in key) & 0xFFFFFFFF
    raise TypeError(
        f"no process-stable hash for key type {type(key).__name__!r} "
        f"(its repr/hash varies per interpreter or per object, which "
        f"would split the key's partition across workers) — route on a "
        f"canonical key: int, str, bytes, float, None, or tuples/"
        f"frozensets of those")


def _ident(x: Any) -> Any:
    return x


class KeyRouter:
    """Per-left-vertex routing rule: which of the M private rings an
    emission takes.  ``by=None`` degrades to per-vertex round-robin (a
    plain repartition); otherwise ``stable_hash(by(x)) % nright``, so all
    left vertices agree on every key's owner with zero coordination.
    Plain picklable state — the procs backend ships one per left-vertex
    process, and the counter/keys are private to that process."""

    def __init__(self, by: Optional[Callable[[Any], Any]], nright: int,
                 tagged: bool = False):
        self.by = by
        self.nright = nright
        self.tagged = tagged
        self._rr = 0

    def __call__(self, out: Any) -> int:
        x = out[1] if self.tagged else out
        if self.by is None:
            w = self._rr
            self._rr = (self._rr + 1) % self.nright
            return w
        return stable_hash(self.by(x)) % self.nright

    def split(self, batch: KeyBatch) -> List[Tuple[int, KeyBatch]]:
        """Partition a :class:`~repro_torch.core.skeleton.KeyBatch` by
        destination: one sub-batch per right vertex that owns any of its
        keys — the whole batch then costs one ring message per *destination*
        instead of one per item."""
        if self.nright == 1:
            return [(0, batch)] if batch else []
        buckets: List[Optional[KeyBatch]] = [None] * self.nright
        for x in batch:
            w = self(x)
            b = buckets[w]
            if b is None:
                buckets[w] = b = KeyBatch()
            b.append(x)
        return [(w, b) for w, b in enumerate(buckets) if b]


# ---------------------------------------------------------------------------
# tag plumbing for ordered= (the existing tagged-token machinery, N×M shape)
# ---------------------------------------------------------------------------
class _A2ATagger(ff_node):
    """Attach the global stream index at the scatter of an ordered a2a."""

    def __init__(self):
        self._next = 0

    def svc(self, x):
        i = self._next
        self._next += 1
        return i, x


class _TagCarry(ff_node):
    """Run a node under the ``(index, payload)`` envelope; tags ride the
    matrix untouched.  ``GO_ON``/``None`` filters the item — the reorder
    stage's EOS residue flush releases everything past the gap."""

    def __init__(self, node: ff_node):
        self._node = node

    def svc_init(self) -> None:
        self._node.svc_init()

    def svc_end(self) -> None:
        self._node.svc_end()

    def svc(self, task):
        i, x = task
        r = self._node.svc(x)
        if r is None or r is GO_ON:
            return GO_ON
        if isinstance(r, EmitMany):
            raise RuntimeError(
                "multi-emit (EmitMany) under AllToAll(ordered=True) is "
                "unsupported: stream tags are 1:1, so several emissions "
                "cannot share one index — use ordered=False for 1:n nodes")
        return i, r

    def svc_eos(self):
        out = self._node.svc_eos()
        if out is not None and out is not GO_ON:
            raise RuntimeError(
                "an EOS-flushing node (svc_eos) cannot run under "
                "AllToAll(ordered=True): flush items carry no stream index "
                "— keyed reductions are unordered by construction")
        return None


def _a2a_budgets(skel: AllToAll) -> List[Any]:
    """The distinct memory-budget boards carried by the right row.

    Duck-typed (a budget exposes ``fold_into``, and ``share``/``collect``/
    ``n_slots`` for the procs board swap — :class:`repro_torch.core.
    oocore.MemoryBudget` is the implementation), so the builders stay free of an
    oocore import; identity-deduped because one reduction's partitions
    share one budget."""
    out: List[Any] = []
    for n in skel.right_nodes:
        # a fused right row (autotune's a2a absorption) hides the budget
        # holder behind a FusedNode wrapper — look through its parts
        parts = getattr(n, "nodes", None) or [n]
        for p in parts:
            b = getattr(p, "budget", None)
            if b is not None and hasattr(b, "fold_into") \
                    and not any(b is x for x in out):
                out.append(b)
    return out


# ---------------------------------------------------------------------------
# threads lowering: N×M matrix of SPSC rings, one thread per vertex
# ---------------------------------------------------------------------------
class A2ALeftVertex(_graph.StageVertex):
    """Left vertex of the matrix: applies its node, then key-routes each
    emission onto its own private ring to the owning right vertex —
    single writer per edge, no arbiter between the layers."""

    def __init__(self, node: ff_node, router: KeyRouter, *,
                 name: str = "ff-a2a-left"):
        super().__init__(node, route="rr", name=name)
        self.router = router

    def _emit(self, out: Any) -> None:
        if type(out) is KeyBatch:
            if not self.outs:
                self.graph.results.extend(out)
                return
            for w, sub in self.router.split(out):  # one message per dest
                if not self._push_abortable(self.outs[w], sub):
                    raise _graph._Aborted()
            return
        if isinstance(out, EmitMany):
            for o in out:
                self._emit(o)
            return
        if not self.outs:  # degenerate: a2a as terminal with nright==0
            self.graph.results.append(out)
            return
        if not self._push_abortable(self.outs[self.router(out)], out):
            raise _graph._Aborted()


def _wrap_rows(skel: AllToAll) -> Tuple[List[ff_node], List[ff_node]]:
    if skel.ordered:
        return ([_TagCarry(n) for n in skel.left_nodes],
                [_TagCarry(n) for n in skel.right_nodes])
    return list(skel.left_nodes), list(skel.right_nodes)


def _scatter_node(skel: AllToAll) -> ff_node:
    return _A2ATagger() if skel.ordered else FnNode(_ident)


def build_thread_a2a(skel: AllToAll, g: "_graph.Graph", in_rings: List[Any],
                     terminal: bool, path: str = "") -> Optional[Any]:
    """Wire an :class:`AllToAll` into the thread graph.

    Topology: ``[scatter] → N left → (N×M rings) → M right → [reorder]``.
    The scatter exists only when there is an upstream stream (without one
    the left nodes run as sources); the reorder stage only under
    ``ordered=``.  Returns the outbound ring list — one ring per right
    vertex (the downstream vertex fan-in-merges them), or a single ring
    after a reorder stage.  Every vertex carries ``path`` (the a2a's IR
    position) so telemetry lanes key collision-free."""
    qc = skel.queue_class or g.queue_class
    cap = skel.capacity or g.capacity
    lnodes, rnodes = _wrap_rows(skel)
    for b in _a2a_budgets(skel):
        # same process: the partitions already write the budget's local
        # counters — just surface the totals once the run has joined
        g.finalizers.append(lambda b=b: b.fold_into(skel.stats))

    if in_rings:
        scatter = g.add(_graph.StageVertex(
            _scatter_node(skel), route=skel.scheduling,
            name=f"{skel.name}-scatter"))
        scatter.path = path
        scatter.ins.extend(in_rings)
    elif skel.ordered:
        raise LoweringError(
            "AllToAll(ordered=True) needs an upstream stream to assign "
            "stream indices; compose it after a Source")
    else:
        scatter = None  # left nodes are sources (svc(None) protocol)

    lefts = []
    for i, node in enumerate(lnodes):
        lv = g.add(A2ALeftVertex(
            node, KeyRouter(skel.by, skel.nright, tagged=skel.ordered),
            name=f"{skel.name}-L{i}"))
        lv.path = path
        if scatter is not None:
            g.connect(scatter, lv, capacity=cap, queue_class=qc)
        lefts.append(lv)
    rights = []
    for j, n in enumerate(rnodes):
        rv = g.add(_graph.StageVertex(n, name=f"{skel.name}-R{j}"))
        rv.path = path
        rights.append(rv)
    for lv in lefts:           # the N×M edge matrix
        for rv in rights:
            g.connect(lv, rv, capacity=cap, queue_class=qc)

    if skel.ordered:
        tail = g.add(_graph.StageVertex(_ReorderNode(),
                                        name=f"{skel.name}-reorder"))
        tail.path = path
        for rv in rights:
            g.connect(rv, tail, capacity=cap, queue_class=qc)
        tails = [tail]
    else:
        tails = rights
    if terminal:
        return None  # sink vertices append straight to graph.results
    out_rings = []
    for tv in tails:
        ring = g.channel(cap, qc)
        tv.outs.append(ring)
        out_rings.append(ring)
    return out_rings[0] if len(out_rings) == 1 else out_rings


# ---------------------------------------------------------------------------
# procs lowering: the same matrix, every vertex a spawned process
# ---------------------------------------------------------------------------
class A2AProcScatterVertex(_procgraph.ProcStageVertex):
    """Scatter as a process: fans the upstream stream over the left row
    via a pick()/route()-based scheduling policy (the policy object lives
    entirely in this vertex's process — single-writer discipline holds)."""

    def __init__(self, node: ff_node, scheduling: Any, *,
                 name: str = "ff-a2a-pscatter"):
        super().__init__(node, name=name)
        from .sched import Scheduler, make_scheduler
        self.sched = make_scheduler(scheduling)
        # resolved once, not per emission (mirrors graph.StageVertex)
        self._route = (self.sched.route
                       if type(self.sched).route is not Scheduler.route
                       else None)

    def _loop(self) -> None:
        self.sched.bind(self.outs, None)
        super()._loop()

    def _emit(self, out: Any) -> None:
        if isinstance(out, EmitMany):
            for o in out:
                self._emit(o)
            return
        w = self.sched.pick() if self._route is None else self._route(out)
        if not self._push_abortable(self.outs[w], out):
            raise _procgraph._Aborted()


class A2AProcLeftVertex(_procgraph.ProcStageVertex):
    """Left vertex as a process: key-routes onto its M private ShmRings."""

    def __init__(self, node: ff_node, router: KeyRouter, *,
                 name: str = "ff-a2a-pleft"):
        super().__init__(node, name=name)
        self.router = router

    def _emit(self, out: Any) -> None:
        if type(out) is KeyBatch:
            for w, sub in self.router.split(out):  # one message per dest
                if not self._push_abortable(self.outs[w], sub):
                    raise _procgraph._Aborted()
            return
        if isinstance(out, EmitMany):
            for o in out:
                self._emit(o)
            return
        if not self._push_abortable(self.outs[self.router(out)], out):
            raise _procgraph._Aborted()


def build_proc_a2a(skel: AllToAll, g: "_procgraph.ProcGraph",
                   in_rings: List[Any], terminal: bool,
                   path: str = "") -> Optional[Any]:
    """The procs twin of :func:`build_thread_a2a`: one spawned process per
    vertex, every edge a shared-memory SPSC ring.  A terminal all-to-all
    gets one results ring per sink vertex (each single-producer; the
    caller drains them all and counts EOS per ring)."""
    cap = skel.capacity or g.capacity
    lnodes, rnodes = _wrap_rows(skel)
    for b in _a2a_budgets(skel):
        if hasattr(b, "share") and hasattr(b, "n_slots"):
            # swap in a shared counter board NOW, before run() pickles the
            # vertices: every partition process attaches the same segment
            # (ShmCounters travels by name) and writes only its own slots
            b.share(g.counters(b.n_slots))

            def _collect_budget(b=b, stats=skel.stats):
                b.collect()      # copy the board out before it is unlinked
                b.fold_into(stats)
            g.finalizers.append(_collect_budget)

    if in_rings:
        scatter = g.add(A2AProcScatterVertex(
            _scatter_node(skel), skel.scheduling,
            name=f"{skel.name}-scatter"))
        scatter.path = path
        scatter.ins.extend(in_rings)
    elif skel.ordered:
        raise LoweringError(
            "AllToAll(ordered=True) needs an upstream stream to assign "
            "stream indices; compose it after a Source")
    else:
        scatter = None

    lefts = []
    for i, node in enumerate(lnodes):
        lv = g.add(A2AProcLeftVertex(
            node, KeyRouter(skel.by, skel.nright, tagged=skel.ordered),
            name=f"{skel.name}-L{i}"))
        lv.path = path
        if scatter is not None:
            g.connect(scatter, lv, capacity=cap)
        lefts.append(lv)
    rights = []
    for j, n in enumerate(rnodes):
        rv = g.add(_procgraph.ProcStageVertex(n, name=f"{skel.name}-R{j}"))
        rv.path = path
        rights.append(rv)
    for lv in lefts:           # the N×M edge matrix
        for rv in rights:
            g.connect(lv, rv, capacity=cap)

    if skel.ordered:
        tail = g.add(_procgraph.ProcStageVertex(
            _ReorderNode(), name=f"{skel.name}-reorder"))
        tail.path = path
        for rv in rights:
            g.connect(rv, tail, capacity=cap)
        tails = [tail]
    else:
        tails = rights
    if terminal:
        for tv in tails:
            tv.outs.append(g.results_ring())
        return None
    out_rings = []
    for tv in tails:
        ring = g.channel(cap)
        tv.outs.append(ring)
        out_rings.append(ring)
    return out_rings[0] if len(out_rings) == 1 else out_rings


# ---------------------------------------------------------------------------
# mesh lowering: the keyed shuffle as ONE device program
# ---------------------------------------------------------------------------
def _plan_mesh_a2a(skel: Skeleton) -> Tuple[List[Callable], AllToAll]:
    """Flatten a skeleton into (elementwise pre-maps, the one AllToAll).
    The shuffle must be the last stage: whatever follows it would consume
    ``(key, fold)`` pairs, which have no array form on the mesh."""
    stages = skel.stages if isinstance(skel, Pipeline) else [skel]
    pre: List[Callable] = []
    a2a: Optional[AllToAll] = None
    for s in stages:
        if isinstance(s, AllToAll):
            if a2a is not None:
                raise LoweringError(
                    "the mesh keyed-shuffle program lowers exactly one "
                    "AllToAll; chain reductions on the host backends")
            a2a = s
        elif a2a is None and isinstance(s, Stage):
            pre.append(_tensor_callable(s.node))
        else:
            raise LoweringError(
                f"the mesh keyed-shuffle program is Stage maps followed by "
                f"ONE AllToAll; cannot place {type(s).__name__} "
                f"{'after the shuffle' if a2a is not None else 'here'}")
    assert a2a is not None
    if len({id(n) for n in a2a.left_nodes}) != 1:
        raise LoweringError(
            "the mesh all-to-all is SPMD: all left workers must share one "
            "tensor function")
    pre.append(_tensor_callable(a2a.left_nodes[0]))
    if a2a.reduce is None:
        raise LoweringError(
            "the mesh backend lowers AllToAll only as a static keyed "
            "reduction (stream_ops.reduce_by_key with a named fold and "
            "nkeys=): generic host-side right nodes cannot run as tensor "
            "code — use the threads or procs backend for them")
    return pre, a2a


# mesh-side segment implementation of each named fold kind
_SEG_KINDS = ("sum", "min", "max", "count")


class A2AMeshProgram:
    """The keyed shuffle compiled whole: ONE device program.

    Per call: items pack into a padded ``(rows, payload+flag)`` array
    (same bucketing discipline as :class:`~repro_torch.core.skeleton.
    MeshProgram`, so nearby sizes reuse the program); inside the program
    each row computes its key (``reduce.by``, applied to the whole column
    — it must be tensor-polymorphic, which for arithmetic like ``x % k``
    is the scalar form verbatim), every row travels to the worker that
    owns its key (``key % W`` — the same mod-partitioning the host route's
    :func:`stable_hash` gives integer keys) via
    :func:`repro_torch.core.dfarm.dispatch`, and a segment reduction
    (``index_add_`` for sum and count, ``scatter_reduce`` for min and
    max) folds each key's partition.  Returns ``[(key, fold), ...]`` for
    the keys that actually occurred — the same unordered contract as the
    host backends' EOS flush.

    Static key space required: ``reduce.nkeys`` bounds the segment
    arrays, and ``by`` must yield integer keys in ``[0, nkeys)``; a key
    out of range is refused (checked on the device, one read a call).

    ``devices`` (default: the CUDA cards for ``device=None``, else one)
    sets ``W``.  On one device (``device=``, ``None`` the card) the
    program runs in this process.  Over ``W > 1`` it runs in W rank
    processes (:func:`~repro_torch.core.ranks.pool`, ``transport=`` as
    there): rank w takes the w-th contiguous shard of the packed rows,
    rows travel to rank ``key % W`` by ``all_to_all_single`` and are
    segment-reduced there, and the segments are gathered in key order.
    The maps and ``by`` must then be picklable.
    """

    backend = "mesh"

    def __init__(self, skeleton: Skeleton, *, devices: Optional[int] = None,
                 block: int = 64, capacity: Optional[int] = None,
                 grain: Optional[int] = None, trace: Any = False,
                 metrics: Any = False, device: Any = None,
                 transport: Optional[str] = None):
        from . import dfarm

        self.skeleton = skeleton
        self.pre, self.a2a = _plan_mesh_a2a(skeleton)
        red = self.a2a.reduce
        kind = getattr(red.fold, "kind", None)
        if kind not in _SEG_KINDS:
            raise LoweringError(
                f"mesh keyed reduction needs a named fold with a segment "
                f"implementation (have {_SEG_KINDS}), got {kind!r}")
        if red.nkeys is None:
            raise LoweringError(
                "mesh keyed reduction needs a static key space: pass "
                "nkeys= to reduce_by_key (keys must lie in [0, nkeys))")
        self.by = red.by
        self.kind = kind
        self.nkeys = int(red.nkeys)
        self.block = block
        self.n_worker = _mesh_devices(devices, device)
        self.transport = transport
        self.pool = None         # the rank processes, once started
        if self.n_worker > 1:
            self.rank_devices = _rank_plan(self.n_worker, device, transport,
                                           (self.pre, self.by))
            self.device = device
        else:
            self.rank_devices = None
            self.device = dfarm.resolve_device(device)
        self._programs: Dict[Tuple[int, str], Callable] = {}
        self.tracer = _coerce_tracer(trace)
        self.metrics = _coerce_metrics(metrics)
        self.last_trace = None
        self.last_report = None
        self._lane = None
        if self.tracer is not None:
            self._lane = self.tracer.vertex("mesh-program")
            self._lane.instant("devices", _devices_args(
                1, self.n_worker, transport))

    def _bucket_rows(self, n: int) -> int:
        rows = max(-(-n // self.n_worker), 1, self.block)
        return 1 << (rows - 1).bit_length()

    def __call__(self, items: Any) -> List[Tuple[int, Any]]:
        from . import dfarm

        xs = list(items)
        if not xs:
            return []
        arr = dfarm.pack(xs, "the host backends fold exact Python ints")
        if arr.ndim != 1:
            raise LoweringError(
                "the mesh keyed shuffle streams scalar items (fold values "
                "are per-key scalars)")
        n = arr.shape[0]
        rows = self._bucket_rows(n)
        # validity flag: padding rows never reduce
        padded = dfarm.pad(arr[:, None], self.n_worker * rows)
        prog = self._program(rows, str(arr.dtype))
        t0 = time.monotonic()
        acc, cnt = prog(padded, n)
        t1 = time.monotonic()
        if self._lane is not None:
            self._lane.span("call", t0, t1, {"items": n, "rows": rows})
            self.last_trace = self.tracer.trace()
        if self.metrics is not None:
            reg = self.metrics
            reg.counter("mesh.calls").inc()
            reg.counter("mesh.items").inc(n)
            reg.gauge("mesh.devices").set(self.n_worker)
            reg.histogram("mesh.call_us").observe((t1 - t0) * 1e6)
            self.last_report = reg.finalize(reg.report(meta={
                "backend": "mesh", "items_in": n, "rows": rows,
                "wall_s": t1 - t0}))
        return [(k, acc[k]) for k in range(self.nkeys) if cnt[k] > 0]

    def _program(self, rows: int, dtype: str) -> Callable:
        key = (rows, dtype)
        if self.pool is not None and self.pool.closed:
            self._programs.clear()   # a failed call closed the ranks: restart
        if key in self._programs:
            return self._programs[key]
        t_compile = time.monotonic()
        from . import dfarm
        if self.rank_devices is None:
            program = dfarm.keyed_program(self.pre, self.by, self.kind,
                                          self.nkeys, self.n_worker, rows,
                                          self.device)
        else:
            from . import ranks
            self.pool = ranks.pool(self.n_worker, device=self.device,
                                   transport=self.transport)
            program = dfarm.rank_keyed_program(self.pre, self.by, self.kind,
                                               self.nkeys, rows, self.pool)
        if self._lane is not None:
            self._lane.span("compile", t_compile, time.monotonic(),
                            {"rows": rows, "dtype": dtype})
        if self.metrics is not None:
            self.metrics.counter("mesh.compiles").inc()
        self._programs[key] = program
        return program
