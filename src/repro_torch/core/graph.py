"""Thread-graph runtime — the skeleton IR's host backend.

FastFlow (paper Sec. 2-3) is a *layered* design: between the lock-free SPSC
ring (``spsc.py``, paper Sec. 3.1) and the declarative skeletons
(``skeleton.py``) sits a runtime for **arbitrary streaming networks** in
which any ``ff_node`` is a vertex, every edge is an SPSC ring, and all
multi-party coordination is performed by *active arbiters* walking their
private ring endpoints — never a lock or an atomic RMW on the data path.

This module is the **threads backend** of
:func:`repro_torch.core.skeleton.lower`: the declarative ``Pipeline`` /
``Farm`` / ``Feedback`` / ``Source`` / ``Stage`` vocabulary lives in
:mod:`repro_torch.core.skeleton` (pure data), and :func:`build` below wires
an IR tree into a :class:`Graph` of vertices and rings.  It is the port's
copy of ``repro.core.graph``; the ``AllToAll`` lowering lives in
:mod:`repro_torch.core.a2a`.  The names ``Net``,
``Pipeline``, ``Farm``, ``compose``, ``ff_node``, ... are importable from
here too, as in the reference.

Construct-to-paper map
----------------------
===============================  ==============================================
Construct (this module)          Paper section / figure
===============================  ==============================================
``SPSCQueue`` edge               Sec. 3.1 "Fast SPSC queues" (Lamport ring)
``Graph`` / ``Vertex``           Sec. 2, Fig. 1: streaming networks as graphs
                                 of concurrent entities over SPSC channels
``ff_node`` (svc/svc_init/_end)  Fig. 2: the programming-model node API
``DispatchVertex``               Fig. 1-2 "Emitter" — active arbiter that
                                 fans one logical stream out over private
                                 SPSC rings, driving a pluggable
                                 ``sched.Scheduler`` policy (rr / ondemand
                                 / worksteal / costmodel)
``MergeVertex``                  Fig. 1-2 "Collector" — active arbiter that
                                 fans many rings into one logical stream
``Farm(ordered=True)``           Fig. 1 (right): tagged tokens reordered at
                                 the collector (tagged-token macro data-flow)
``Pipeline`` / ``compose``       Sec. 3.1 "pipeline skeleton": chain of
                                 nodes over SPSC edges
``Farm(feedback=...)``           Sec. 5 wrap-around (collector→emitter) edge
                                 for divide-and-conquer and cyclic networks;
                                 termination by loop quiescence
``Accelerator``                  TR-10-03 "self-offloading": the caller
                                 thread is the source, ``offload()`` is a
                                 push onto the accelerator's inbound ring
===============================  ==============================================

Beyond-paper features carried over from the seed farm (now reusable by any
farm in any composition):

* **straggler re-issue** — the dispatch arbiter speculatively re-sends tasks
  whose age exceeds ``straggler_factor × p95`` of completed latencies; the
  merge arbiter deduplicates by tag (exactly-once delivery downstream);
* **worker-failure tolerance** — a worker thread that dies stops draining
  its ring; its outstanding tags age out and re-speculate to live workers.

Single-writer discipline (what makes this lock-free): every ring has one
producer and one consumer vertex; tag bookkeeping in ``TagSpace`` is split
into dispatch-arbiter-written fields (``next_tag``/``inflight``/``entered``)
and merge-arbiter-written fields (``done``/``retired``).  Cross-thread reads
of the other side's fields are benignly stale — the worst case is one
redundant duplicate, which the merge arbiter drops.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Type

from .obs import qualname as _qualname
from .sched import Scheduler, make_scheduler
from .skeleton import (GO_ON, AllToAll, EmitMany, Farm, FarmStats, Feedback,
                       FnNode, KeyBatch, Pipeline, Skeleton, Source, Stage,
                       _FarmEmitMany, _SeqNode, as_skeleton, compose, ff_node)
from .spsc import EOS, SPSCQueue

__all__ = [
    "GO_ON", "Token", "FarmStats", "TagSpace",
    "ff_node", "FnNode",
    "Graph", "Vertex", "StageVertex", "DispatchVertex", "WorkerVertex",
    "MergeVertex", "build", "ring_list",
    "Net", "Stage", "Source", "Pipeline", "Farm", "Feedback", "AllToAll",
    "compose", "Accelerator",
]

_EMPTY = SPSCQueue._EMPTY
_POLL = 0.000_05  # arbiter poll backoff (matches the SPSC blocking helpers)


# ---------------------------------------------------------------------------
# tagged tokens (paper Fig. 1 right) + farm bookkeeping
# ---------------------------------------------------------------------------
@dataclass
class Token:
    tag: int
    payload: Any
    issued_at: float = 0.0
    duplicate: bool = False


class TagSpace:
    """Per-farm tag bookkeeping shared by the two arbiters.

    Single-writer split: the dispatch arbiter writes ``next_tag``,
    ``inflight`` and ``entered``; the merge arbiter writes ``done`` and
    ``retired``.  ``entered``/``retired`` count tokens entering/leaving a
    wrap-around loop (see ``MergeVertex._complete`` for the ordering that
    makes the quiescence check race-free)."""

    __slots__ = ("inflight", "done", "next_tag", "entered", "retired", "stats")

    def __init__(self, stats: Optional[FarmStats] = None):
        self.inflight: Dict[int, Token] = {}
        self.done: Dict[int, bool] = {}
        self.next_tag = 0
        self.entered = 0
        self.retired = 0
        self.stats = stats if stats is not None else FarmStats()


# ---------------------------------------------------------------------------
# graph runtime: vertices (threads) + SPSC edges
# ---------------------------------------------------------------------------
class _Aborted(Exception):
    """Internal: this vertex gave up because another vertex already failed
    (its consumer may be dead and its ring full — blocking would hang)."""


class Vertex:
    """A network vertex: one thread, private SPSC endpoints."""

    # observability (obs.py): ``tracer`` is bound by ``Graph.run()`` when a
    # Tracer is installed, ``path`` is the vertex's IR path assigned by
    # ``build()``.  Class-level defaults keep the untraced hot path at one
    # attribute read that resolves against the class dict — no per-vertex
    # storage, no allocation, when tracing is off.
    tracer = None
    path = ""

    def __init__(self, node: Optional[ff_node] = None, *, name: str = "ff-vertex"):
        self.node = node
        self.name = name
        # batch-aware nodes (SpillFold) take a whole KeyBatch in one svc
        # call; everyone else gets it unpacked by the vertex loop
        self._takes_batches = bool(getattr(node, "accepts_batches", False))
        self.ins: List[Any] = []
        self.outs: List[Any] = []
        self.graph: Optional["Graph"] = None

    # -- lifecycle (runs in the vertex's own thread) ------------------------
    def _run(self) -> None:
        tr = self.tracer
        t_birth = time.monotonic() if tr is not None else 0.0
        try:
            if self.node is not None:
                if tr is not None and getattr(self.node, "wants_tracer",
                                              False):
                    # opt-in node-level events (SpillFold's spill instants):
                    # the node records into ITS vertex's lane, so the
                    # single-writer-per-buffer discipline holds
                    self.node.tracer = tr
                self.node.svc_init()
            self._loop()
        except _Aborted:
            pass  # secondary shutdown; the original error is in graph.failed
        except BaseException as e:
            self._on_error(e)
        finally:
            for q in self.outs:
                self._push_abortable(q, EOS)
            if self.node is not None:
                try:
                    self.node.svc_end()
                except BaseException as e:  # pragma: no cover - defensive
                    self.graph.failed.append(e)
            if tr is not None:
                tr.instant("eos")
                tr.span("life", t_birth, time.monotonic())

    def _on_error(self, e: BaseException) -> None:
        self.graph.failed.append(e)

    def _loop(self) -> None:
        raise NotImplementedError

    def _push_abortable(self, q: Any, item: Any) -> bool:
        """Blocking push that gives up (returns False) once the graph has a
        recorded failure — the ring's consumer may be dead, and blocking on
        a full ring would hang the whole network teardown."""
        spins = 0
        while not q.push(item):
            if self.graph.failed:
                return False
            spins += 1
            if spins > 64:
                time.sleep(_POLL)
        return True

    def _deliver(self, payload: Any) -> None:
        """Emit one raw payload downstream, or into the graph's result sink
        when this vertex has no outbound edge."""
        if self.outs:
            if not self._push_abortable(self.outs[0], payload):
                raise _Aborted()
        else:
            self.graph.results.append(payload)


class StageVertex(Vertex):
    """Generic vertex: any fan-in (nondeterministic merge of untagged
    payloads), any fan-out (``"bcast"`` broadcast, or any scheduling
    policy — name or :class:`~repro_torch.core.sched.Scheduler` — for the
    single-consumer routes, so ``Stage`` and ``Farm`` share one dispatch
    code path).  With no inbound edges it is a *source*: ``svc(None)`` is
    called until it returns ``None`` (EOS) — paper Fig. 2's emitter
    protocol."""

    def __init__(self, node: ff_node, *, route: Any = "rr",
                 name: str = "ff-stage"):
        super().__init__(node, name=name)
        if route == "bcast":
            self._sched: Optional[Scheduler] = None
            self._route: Optional[Callable] = None
        else:
            try:
                self._sched = make_scheduler(route)
            except ValueError:
                raise ValueError(
                    f"unknown Stage route {route!r}: expected 'bcast', a "
                    f"scheduling policy name, or a Scheduler") from None
            # resolve the payload-dependent hook ONCE: the per-emission
            # path must not pay a route() virtual call for the policies
            # (rr/ondemand/costmodel) that never override it
            self._route = (self._sched.route
                           if type(self._sched).route is not Scheduler.route
                           else None)
            if type(self._sched).place is not Scheduler.place \
                    and self._route is None:
                # stage fan-out is routed per emission (payload-dependent
                # route() or stateless pick()); a policy that holds tokens
                # in the arbiter (custom place/pump, e.g. worksteal)
                # needs the farm dispatch arbiter
                raise ValueError(
                    f"Stage route {route!r} is a token-holding policy "
                    f"(custom place()); stage fan-out supports only "
                    f"pick()/route()-based policies — use a Farm for it")
        self.route = route

    def _loop(self) -> None:
        if self._sched is not None:
            self._sched.bind(self.outs, None)
        tr = self.tracer
        if not self.ins:  # source
            while True:
                if tr is not None:
                    t0 = tr.begin()
                    out = self.node.svc(None)
                    tr.end(t0, "svc")
                else:
                    out = self.node.svc(None)
                if out is None or out is EOS:
                    break
                if out is GO_ON:
                    continue
                self._emit(out)
            self._flush_eos()
            return
        eos: set = set()
        while len(eos) < len(self.ins):
            progress = False
            for i, q in enumerate(self.ins):
                if i in eos:
                    continue
                item = q.pop()
                if item is _EMPTY:
                    continue
                progress = True
                if item is EOS:
                    eos.add(i)
                    continue
                if type(item) is KeyBatch and not self._takes_batches:
                    # batched wire format: unpack here so the node still
                    # sees items (batching is transport, not semantics)
                    for x in item:
                        if tr is not None:
                            t0 = tr.begin()
                            out = self.node.svc(x)
                            tr.end(t0, "svc")
                        else:
                            out = self.node.svc(x)
                        if out is None or out is GO_ON:
                            continue
                        self._emit(out)
                    continue
                if tr is not None:
                    t0 = tr.begin()
                    out = self.node.svc(item)
                    tr.end(t0, "svc")
                else:
                    out = self.node.svc(item)
                if out is None or out is GO_ON:
                    continue  # filtered
                self._emit(out)
            if not progress:
                time.sleep(_POLL)
        self._flush_eos()

    def _flush_eos(self) -> None:
        """EOS flush (FastFlow's eosnotify): give the node one chance to
        emit buffered state (``svc_eos``) into the stream before this
        vertex's own EOS propagates — how the keyed folds and window
        operators release their accumulators."""
        out = self.node.svc_eos()
        if out is not None and out is not GO_ON:
            self._emit(out)

    def _emit(self, out: Any) -> None:
        if type(out) is KeyBatch:  # one wire message; consumers unpack
            if not out:
                return
            if not self.outs:
                self.graph.results.extend(out)  # the caller sees items
                return
        elif isinstance(out, EmitMany):  # multi-emit (e.g. a reorder flush)
            for o in out:
                self._emit(o)
            return
        if not self.outs:
            self.graph.results.append(out)
        elif self.route == "bcast":
            for q in self.outs:
                if not self._push_abortable(q, out):
                    raise _Aborted()
        else:
            w = self._sched.pick() if self._route is None else self._route(out)
            if not self._push_abortable(self.outs[w], out):
                raise _Aborted()


class DispatchVertex(Vertex):
    """The farm's Emitter arbiter (paper Figs. 1-2).

    One logical input — a source ``ff_node``, an upstream ring, or a
    wrap-around ring — fanned out over private SPSC rings to the workers.
    Owns tag assignment and straggler re-issue; task *placement* is
    delegated to a pluggable :class:`~repro_torch.core.sched.Scheduler` (rr /
    ondemand / worksteal / costmodel, or user-supplied), driven entirely
    from this arbiter's thread so the single-writer SPSC discipline is
    untouched.  When ``loop_ring`` is set this vertex is also the loop
    master: it terminates only when every upstream edge has delivered EOS
    *and* the loop is quiescent (``entered == retired``, the wrap-around
    ring drained, and no tokens left inside the scheduling policy)."""

    def __init__(
        self,
        tags: TagSpace,
        node: Optional[ff_node] = None,
        *,
        scheduling: Any = "rr",
        speculative: bool = False,
        straggler_factor: float = 4.0,
        min_straggler_age: float = 0.05,
        loop_ring: Optional[Any] = None,
        name: str = "ff-emitter",
    ):
        super().__init__(node, name=name)
        self.sched = make_scheduler(scheduling)
        self.scheduling = self.sched.name
        self.tags = tags
        self.speculative = speculative
        self.straggler_factor = straggler_factor
        self.min_straggler_age = min_straggler_age
        self.loop_ring = loop_ring
        # wrap-around tokens stashed while a worker ring is full (see
        # _push_with_loop_drain: this is what breaks cyclic backpressure)
        self._stash: List[Any] = []

    def _push_with_loop_drain(self, q: Any, tok: Token) -> None:
        """Blocking push that keeps draining the wrap-around ring while the
        target worker ring is full.  Without this, a full worker ring can
        deadlock the cycle: workers blocked on the merge arbiter, the merge
        arbiter blocked on the wrap-around ring, and this arbiter blocked
        here — draining into the local stash breaks the wait cycle.  Gives
        up once the graph has failed (the ring's worker may be dead)."""
        if q.push(tok):
            return  # fast path: no stall, no clock read
        tr = self.tracer
        t0 = time.monotonic() if tr is not None else 0.0
        spins = 0
        while not q.push(tok):
            if self.graph.failed:
                raise _Aborted()
            if self.loop_ring is not None:
                item = self.loop_ring.pop()
                if item is not _EMPTY:
                    self._stash.append(item)
                    continue
            spins += 1
            if spins > 64:
                time.sleep(_POLL)
        if tr is not None:
            tr.span("stall", t0, time.monotonic())

    def _dispatch(self, task: Any) -> None:
        ts = self.tags
        tok = Token(tag=ts.next_tag, payload=task, issued_at=time.monotonic())
        ts.next_tag += 1
        ts.inflight[tok.tag] = tok
        if self.loop_ring is not None:
            ts.entered += 1
        self.sched.place(tok, self._emit_to)
        ts.stats.tasks_emitted += 1
        # backpressure for token-holding policies (worksteal): stop taking
        # input while the policy backlog is over its high-water mark,
        # draining the wrap-around ring meanwhile (same deadlock-avoidance
        # as _push_with_loop_drain)
        hw = self.sched.high_water
        if hw is not None and self.sched.pending() > hw:
            tr = self.tracer
            t0 = time.monotonic() if tr is not None else 0.0
            spins = 0
            while self.sched.pending() > hw:
                if self.sched.pump():
                    continue
                if self.graph.failed:
                    raise _Aborted()
                if self.loop_ring is not None:
                    item = self.loop_ring.pop()
                    if item is not _EMPTY:
                        self._stash.append(item)
                        continue
                spins += 1
                if spins > 64:
                    time.sleep(_POLL)
            if tr is not None:
                tr.span("stall", t0, time.monotonic())

    def _emit_to(self, widx: int, tok: Token) -> None:
        """Blocking-push callback handed to ``Scheduler.place`` (policies
        that hold tokens, like worksteal, never call it and push
        non-blockingly from ``pump`` instead)."""
        self._push_with_loop_drain(self.outs[widx], tok)

    def _respeculate(self) -> None:
        ts = self.tags
        now = time.monotonic()
        p95 = max(ts.stats.p95_latency(), self.min_straggler_age)
        threshold = self.straggler_factor * p95
        for t, tok in list(ts.inflight.items()):
            if t in ts.done:
                continue
            if now - tok.issued_at > threshold:
                dup = Token(tag=t, payload=tok.payload, issued_at=now, duplicate=True)
                widx = self.sched.pick()
                if self.outs[widx].push(dup):
                    # re-arm the age clock; a still-stale tag (e.g. its copy
                    # landed on a dead worker) will speculate again, to a
                    # different worker (rr advanced) — this is what makes the
                    # farm survive worker loss, not just slowness.
                    tok.issued_at = now
                    ts.stats.duplicates_issued += 1

    def _loop(self) -> None:
        ts = self.tags
        self.sched.bind(self.outs, ts.stats)
        tr = self.tracer
        steals0 = ts.stats.steals if tr is not None else 0
        ndisp = 0
        if self.node is not None and not self.ins:
            # source mode: the emitter node generates the stream
            while True:
                if tr is not None:
                    t0 = tr.begin()
                    task = self.node.svc(None)
                    tr.end(t0, "svc")
                else:
                    task = self.node.svc(None)
                if task is None or task is EOS:
                    break
                if task is GO_ON:
                    continue
                self._dispatch(task)
                ndisp += 1
                self.sched.pump()  # flush/steal while we generate
                if tr is not None and ts.stats.steals != steals0:
                    tr.instant("steal",
                               {"count": ts.stats.steals - steals0})
                    steals0 = ts.stats.steals
                # keep the wrap-around ring moving while we generate
                if self.loop_ring is not None:
                    while True:
                        item = self.loop_ring.pop()
                        if item is _EMPTY:
                            break
                        self._dispatch(item)
                        ndisp += 1
                        if tr is not None:
                            tr.tick("loop")
                if self.speculative and ndisp % 32 == 0:
                    self._respeculate()
            # source exhausted; drain the loop to quiescence
            while self.loop_ring is not None:
                progress = self.sched.pump()
                while self._stash:
                    self._dispatch(self._stash.pop(0))
                    progress = True
                while True:
                    item = self.loop_ring.pop()
                    if item is _EMPTY:
                        break
                    progress = True
                    self._dispatch(item)
                    if tr is not None:
                        tr.tick("loop")
                if not self._stash and not self.sched.pending() \
                        and ts.entered == ts.retired \
                        and self.loop_ring.empty():
                    break
                if self.graph.failed:
                    break  # a vertex died: tokens can never retire
                if not progress:
                    # yield (not sleep) while the policy still holds
                    # tokens: a fine-grain worker drains its primed ring
                    # in far less than a poll tick
                    time.sleep(0 if self.sched.pending() else _POLL)
            # flush tokens still held by the policy (e.g. worksteal
            # backlogs) before the EOS goes out behind them
            while self.sched.pending() and not self.graph.failed:
                if not self.sched.pump():
                    time.sleep(0)
        else:
            eos: set = set()
            spec_mark = 0  # dispatches at the last speculation sweep
            while True:
                progress = self.sched.pump()
                if tr is not None and ts.stats.steals != steals0:
                    tr.instant("steal",
                               {"count": ts.stats.steals - steals0})
                    steals0 = ts.stats.steals
                # wrap-around tokens first: looped-back work is older
                while self._stash:
                    self._dispatch(self._stash.pop(0))
                    ndisp += 1
                    progress = True
                if self.loop_ring is not None:
                    while True:
                        item = self.loop_ring.pop()
                        if item is _EMPTY:
                            break
                        progress = True
                        self._dispatch(item)
                        ndisp += 1
                        if tr is not None:
                            tr.tick("loop")
                for i, q in enumerate(self.ins):
                    if i in eos:
                        continue
                    item = q.pop()
                    if item is _EMPTY:
                        continue
                    progress = True
                    if item is EOS:
                        eos.add(i)
                        continue
                    if self.node is not None:
                        # emitter node as per-item scheduler/filter
                        if tr is not None:
                            t0 = tr.begin()
                            item = self.node.svc(item)
                            tr.end(t0, "svc")
                        else:
                            item = self.node.svc(item)
                        if item is None or item is GO_ON:
                            continue
                    self._dispatch(item)
                    ndisp += 1
                if self.speculative and ndisp - spec_mark >= 32:
                    # per-32-dispatches, not per poll iteration: _respeculate
                    # sorts the whole latency list and must not run while idle
                    spec_mark = ndisp
                    self._respeculate()
                if len(eos) == len(self.ins) and not self._stash \
                        and not self.sched.pending():
                    if self.loop_ring is None:
                        break
                    # Quiescence check — read order matters: ``retired``
                    # first, then the ring.  The merge arbiter pushes
                    # wrap-around tasks *before* incrementing ``retired``,
                    # so if entered == retired here, every looped-back task
                    # from completed tokens is already visible in the ring.
                    if ts.entered == ts.retired and self.loop_ring.empty():
                        break
                if self.graph.failed:
                    break  # a vertex died: quiescence can never be reached
                if not progress:
                    # yield while the policy holds tokens (see above)
                    time.sleep(0 if self.sched.pending() else _POLL)
        # straggler watchdog: keep re-issuing until everything is collected
        while self.speculative and any(t not in ts.done for t in ts.inflight):
            if self.graph.failed:
                break  # e.g. the collector died: tags can never complete
            self._respeculate()
            time.sleep(0.002)


class WorkerVertex(Vertex):
    """Farm worker: one inbound and one outbound ring, tags carried
    through untouched (the worker never sees the tag).

    When the farm's policy asks for it (``needs_service_stats``, e.g.
    ``costmodel``), each worker maintains its own service-time EWMA in
    ``stats.service_ewma[index]`` (single writer per key); other policies
    skip the per-task timing entirely.  With an ``idle_ring`` (the
    ``worksteal`` policy's side-channel) the worker advertises itself to
    the dispatch arbiter whenever its inbound ring runs dry, which is what
    triggers a steal from the deepest peer backlog."""

    # traced runs: the start stamp of this run's first task (its ``svc``
    # span is always sampled in), which ``TaskFarm`` reads after the join
    t_first = 0.0

    def __init__(self, node: ff_node, index: int, stats: FarmStats, *,
                 survivable: bool = False, idle_ring: Optional[Any] = None,
                 record_service: bool = False, name: str = "ff-worker"):
        super().__init__(node, name=name)
        self.index = index
        self.stats = stats
        self.survivable = survivable
        self.idle_ring = idle_ring
        self.record_service = record_service

    def _loop(self) -> None:
        q_in, q_out = self.ins[0], self.outs[0]
        stats = self.stats
        tr = self.tracer
        if tr is not None:
            tr.rewind()
            run = self.graph.run_id
        record = self.record_service  # opt-in: only pay the timing when a
        signaled = False              # policy consumes the EWMA
        spins = 0
        while True:
            if self.idle_ring is None:
                tok = q_in.pop_wait()
            else:
                tok = q_in.pop()
                if tok is _EMPTY:
                    # steal side-channel: advertise idleness (re-advertise
                    # periodically — a signal consumed while the arbiter
                    # had nothing to give must not strand this worker)
                    if not signaled or spins % 512 == 511:
                        signaled = self.idle_ring.push(self.index) or signaled
                    spins += 1
                    if spins > 64:
                        time.sleep(_POLL)
                    continue
                signaled = False
                spins = 0
            if tok is EOS:
                return
            tb = tr.begin() if tr is not None else 0.0
            if record:
                t0 = time.monotonic()
                result = self.node.svc(tok.payload)
                dt = time.monotonic() - t0
                prev = stats.service_ewma.get(self.index)
                stats.service_ewma[self.index] = \
                    dt if prev is None else 0.8 * prev + 0.2 * dt
            else:
                result = self.node.svc(tok.payload)
            if tr is not None and tb:
                if not self.t_first:
                    self.t_first = tb
                tr.end(tb, "svc", {"run": run, "tag": tok.tag})
            out = Token(tag=tok.tag, payload=result,
                        issued_at=tok.issued_at, duplicate=tok.duplicate)
            if not self._push_abortable(q_out, out):
                raise _Aborted()
            stats.per_worker[self.index] = stats.per_worker.get(self.index, 0) + 1

    def _on_error(self, e: BaseException) -> None:
        if self.survivable:
            # fault tolerance: a dying worker is survivable — its
            # outstanding tags age out and re-speculate to live workers.
            self.stats.worker_failures.append((self.index, repr(e)))
        else:
            self.graph.failed.append(e)


class MergeVertex(Vertex):
    """The farm's Collector arbiter (paper Figs. 1-2).

    Merges the worker rings into one logical stream: exactly-once by tag
    (duplicates from speculation are dropped), optional reorder-by-tag
    (``ordered`` — the tagged-token collector of Fig. 1 right), optional
    collector ``ff_node``, and optional wrap-around routing: ``feedback``
    decides, per result, what leaves the loop and what goes back around."""

    def __init__(
        self,
        tags: TagSpace,
        node: Optional[ff_node] = None,
        *,
        ordered: bool = False,
        loop_ring: Optional[Any] = None,
        feedback: Optional[Callable[[Any], Tuple[Any, Iterable[Any]]]] = None,
        name: str = "ff-collector",
    ):
        super().__init__(node, name=name)
        self.tags = tags
        self.ordered = ordered
        self.loop_ring = loop_ring
        self.feedback = feedback

    def _loop(self) -> None:
        ts = self.tags
        eos: set = set()
        next_tag = 0
        reorder: Dict[int, Any] = {}
        while len(eos) < len(self.ins):
            progress = False
            for i, q in enumerate(self.ins):
                if i in eos:
                    continue
                tok = q.pop()
                if tok is _EMPTY:
                    continue
                progress = True
                if tok is EOS:
                    eos.add(i)
                    continue
                if tok.tag in ts.done:
                    ts.stats.duplicates_dropped += 1
                    continue
                ts.done[tok.tag] = True
                ts.stats.tasks_collected += 1
                ts.stats.latencies.append(time.monotonic() - tok.issued_at)
                if self.ordered:
                    reorder[tok.tag] = tok.payload
                    while next_tag in reorder:
                        self._complete(reorder.pop(next_tag))
                        next_tag += 1
                else:
                    self._complete(tok.payload)
            if not progress:
                time.sleep(_POLL)
        # flush any residue (can only happen if tags were skipped upstream)
        for t in sorted(reorder):
            self._complete(reorder.pop(t))

    def _complete(self, payload: Any) -> None:
        if payload is GO_ON:
            # a worker returning GO_ON emits nothing (ff_node contract);
            # the tag is already done, the token just retires silently
            self._retire()
            return
        tr = self.tracer
        if self.node is not None:
            if tr is not None:
                t0 = tr.begin()
                payload = self.node.svc(payload)
                tr.end(t0, "svc")
            else:
                payload = self.node.svc(payload)
            if payload is None or payload is GO_ON:
                self._retire()
                return
        if self.feedback is not None:
            emit, new_tasks = self.feedback(payload)
            # push wrap-around tasks BEFORE retiring the token: the dispatch
            # arbiter's quiescence check relies on this ordering.
            for t in new_tasks:
                if not self._push_abortable(self.loop_ring, t):
                    raise _Aborted()
                if tr is not None:
                    tr.tick("loop")
            self._retire()
            if emit is None:
                return
            payload = emit
        else:
            self._retire()
        if isinstance(payload, _FarmEmitMany):
            # a farm-absorbed tail multi-emitted: flatten downstream, as
            # the unfused trailing StageVertex would have
            for p in payload:
                self._deliver(p)
            return
        self._deliver(payload)

    def _retire(self) -> None:
        if self.loop_ring is not None:
            self.tags.retired += 1


class Graph:
    """A streaming network: vertices (one thread each) + SPSC edges.

    The low-level API (``add`` / ``connect``) supports arbitrary topologies;
    the skeleton layer (``Pipeline`` / ``Farm`` / ``compose``) builds graphs
    for the common shapes.  ``results`` collects whatever reaches a vertex
    with no outbound edge."""

    def __init__(self, *, queue_class: Type = SPSCQueue, capacity: int = 512):
        self.queue_class = queue_class
        self.capacity = capacity
        self.vertices: List[Vertex] = []
        self.results: List[Any] = []
        self.failed: List[BaseException] = []
        self._threads: List[threading.Thread] = []
        # post-run hooks (builders register them): fold telemetry boards
        # back into the IR node's stats once the vertices have joined
        self.finalizers: List[Callable[[], None]] = []
        # observability: when set (obs.Tracer), run() hands each vertex its
        # own single-writer lane before the threads start, and takes the
        # run id the run's spans share
        self.tracer = None
        self.run_id: Optional[int] = None
        # drain-time taps: callables run exactly once inside wait(), after
        # the vertex threads have joined but BEFORE the finalizers tear any
        # telemetry down — the only point where "the stream is complete"
        # and "the rings still exist" are both true, so a short run that
        # finished before the first caller-side poll still lands exactly
        # one sample per edge (and never races the caller's results drain)
        self.drain_samplers: List[Callable[[], None]] = []
        # set by a monitored lowering: farm workers opt into service-EWMA
        # timing so the live sampler has a signal to read (see monitor.py)
        self.live_telemetry = False

    def channel(self, capacity: Optional[int] = None,
                queue_class: Optional[Type] = None) -> Any:
        qc = queue_class or self.queue_class
        return qc(capacity or self.capacity)

    def add(self, v: Vertex) -> Vertex:
        v.graph = self
        self.vertices.append(v)
        return v

    def connect(self, src: Vertex, dst: Vertex, *, capacity: Optional[int] = None,
                queue_class: Optional[Type] = None) -> Any:
        ring = self.channel(capacity, queue_class)
        src.outs.append(ring)
        dst.ins.append(ring)
        return ring

    def run(self) -> "Graph":
        assert not self._threads, "graph already running"
        tr = self.tracer
        if tr is not None:
            self.run_id = tr.next_run()
            for v in self.vertices:
                if v.tracer is None:
                    v.tracer = tr.vertex(v.name, v.path)
        self._threads = [
            threading.Thread(target=v._run, name=v.name, daemon=True)
            for v in self.vertices
        ]
        for t in self._threads:
            t.start()
        return self

    def wait(self, timeout: Optional[float] = None) -> List[Any]:
        for t in self._threads:
            t.join(timeout)
        while self.drain_samplers:
            self.drain_samplers.pop()()  # run once, even if wait() re-enters
        while self.finalizers:
            self.finalizers.pop()()  # run once, even if wait() is re-entered
        if self.failed:
            raise self.failed[0]
        return self.results

    def run_and_wait(self) -> List[Any]:
        return self.run().wait()

    def sample_high_water(self, into: Dict[str, int]) -> Dict[str, int]:
        """Profile tap: record each vertex's current outbound queue depth
        into ``into``, keeping the per-name maximum across calls.  Autotune
        polls this from the caller thread while a pilot run drains —
        ``len()`` on every ring class is a racy-but-benign read of the
        head/tail indices, so no locks and no effect on the stream.

        Keys are IR-path qualified (``name@path``) so two farms — or two
        stages sharing a user-visible name — cannot collide in one merged
        report."""
        for v in self.vertices:
            depth = 0
            for ring in v.outs:
                try:
                    depth = max(depth, len(ring))
                except TypeError:
                    pass
            key = _qualname(v.name, v.path)
            if depth > into.get(key, -1):
                into[key] = depth
        return into

    def sample_depths(self, into: Dict[str, int]) -> Dict[str, int]:
        """Live-monitor tap: the *instantaneous* outbound queue depth per
        vertex (overwrite semantics — each call is one timeline frame,
        unlike :meth:`sample_high_water`'s running max).  Same lock-free
        racy-but-benign ``len()`` reads, same ``name@path`` keys."""
        for v in self.vertices:
            depth = 0
            for ring in v.outs:
                try:
                    depth = max(depth, len(ring))
                except TypeError:
                    pass
            into[_qualname(v.name, v.path)] = depth
        return into


# ---------------------------------------------------------------------------
# threads lowering: IR tree -> vertices + rings
# ---------------------------------------------------------------------------
# Back-compat shims: the declarative layer now lives in skeleton.py; the old
# names keep working for existing callers (PR-1's Net API).
Net = Skeleton
_as_net = as_skeleton


def ring_list(in_ring: Optional[Any]) -> List[Any]:
    """Normalise a build edge: ``None`` (no upstream), one ring, or a list
    of rings (an all-to-all's right row emits one ring per vertex — the
    downstream vertex fan-in-merges them all, EOS counted per edge)."""
    if in_ring is None:
        return []
    return list(in_ring) if isinstance(in_ring, (list, tuple)) else [in_ring]


def build(skel: Skeleton, g: Graph, in_ring: Optional[Any],
          terminal: bool, path: str = "") -> Optional[Any]:
    """Wire a skeleton IR node into ``g`` between an optional inbound ring
    (or ring *list* — see :func:`ring_list`) and (unless terminal) a
    freshly created outbound ring — the threads backend of
    :func:`repro_torch.core.skeleton.lower`.

    ``path`` is the node's position in the IR tree (``"1"``, ``"1.2"`` …);
    vertices remember it so telemetry keys (``sample_high_water``, trace
    lanes) are namespaced per IR path and two same-named nodes never
    collide.

    This is what makes skeletons close under composition: a ``Farm`` is a
    vertex of the enclosing ``Pipeline``, and vice versa."""
    if isinstance(skel, AllToAll):
        from .a2a import build_thread_a2a  # lazy: a2a imports this module
        return build_thread_a2a(skel, g, ring_list(in_ring), terminal,
                                path=path)

    if isinstance(skel, Source):
        assert in_ring is None, "Source cannot have an upstream edge"
        return build(Stage(skel.node, name=skel.name,
                           capacity=skel.capacity), g, None, terminal, path)

    if isinstance(skel, Pipeline):
        ring = in_ring
        last = len(skel.stages) - 1
        for i, s in enumerate(skel.stages):
            p = f"{path}.{i}" if path else str(i)
            if i == last:
                return build(s, g, ring, terminal, p)
            ring = build(s, g, ring, False, p)

    if isinstance(skel, Feedback):
        # predicate loop -> tagger + wrap-around farm + reorder (Sec. 5)
        return build(skel.as_thread_net(), g, in_ring, terminal, path)

    if isinstance(skel, Farm):
        qc = skel.queue_class or g.queue_class
        cap = skel.capacity or g.capacity
        ts = TagSpace(skel.stats)
        loop_ring = (qc(skel.feedback_capacity)
                     if skel.feedback is not None else None)

        disp = g.add(DispatchVertex(
            ts, skel.emitter,
            scheduling=skel.scheduling, speculative=skel.speculative,
            straggler_factor=skel.straggler_factor,
            min_straggler_age=skel.min_straggler_age,
            loop_ring=loop_ring,
        ))
        disp.path = path
        if in_ring is not None:
            disp.ins.extend(ring_list(in_ring))
        else:
            assert skel.emitter is not None, \
                "a standalone farm needs an emitter (or compose it after a Source)"

        merge = g.add(MergeVertex(
            ts, skel.collector, ordered=skel.ordered,
            loop_ring=loop_ring, feedback=skel.feedback,
        ))
        merge.path = path
        for i, node in enumerate(skel.worker_nodes):
            # the policy may want a steal side-channel (worker -> arbiter)
            idle = disp.sched.worker_channel(i, qc)
            w = g.add(WorkerVertex(node, i, ts.stats,
                                   survivable=skel.speculative,
                                   idle_ring=idle,
                                   record_service=(
                                       disp.sched.needs_service_stats
                                       # a live monitor consumes the EWMAs
                                       or getattr(g, "live_telemetry", False)),
                                   name=f"ff-worker-{i}"))
            w.path = path
            g.connect(disp, w, capacity=cap, queue_class=qc)
            g.connect(w, merge, capacity=cap, queue_class=qc)
        if terminal:
            return None
        ring = g.channel(skel.capacity)
        merge.outs.append(ring)
        return ring

    if isinstance(skel, Stage):
        v = g.add(StageVertex(skel.node, name=skel.name))
        v.path = path
        v.ins.extend(ring_list(in_ring))
        if terminal:
            return None
        # per-edge capacity: a tuned Stage sizes its own outbound ring
        ring = g.channel(getattr(skel, "capacity", None))
        v.outs.append(ring)
        return ring

    raise TypeError(f"cannot lower {skel!r} to the thread graph")


class Accelerator:
    """Self-offloading accelerator (TR-10-03): run a network alongside the
    caller, who streams tasks into it and harvests results later.

    The caller thread is the single producer of the inbound ring (SPSC
    discipline holds: ``offload`` must be called from one thread), so the
    main thread of an application can offload kernels to a farm and keep
    computing — the paper's "accelerator" usage of FastFlow.

        acc = Accelerator(Farm(FnNode(f), 4))
        for x in tasks: acc.offload(x)
        results = acc.wait()
    """

    def __init__(self, net: Any, *, queue_class: Type = SPSCQueue,
                 capacity: int = 512):
        self._g = Graph(queue_class=queue_class, capacity=capacity)
        self._in = self._g.channel()
        build(as_skeleton(net), self._g, self._in, True)
        self._g.run()
        self._closed = False

    @property
    def results(self) -> List[Any]:
        return self._g.results

    def offload(self, task: Any) -> None:
        assert not self._closed, "accelerator already EOS'd"
        self._in.push_wait(task)

    def eos(self) -> None:
        if not self._closed:
            self._closed = True
            self._in.push_wait(EOS)

    def wait(self, timeout: Optional[float] = None) -> List[Any]:
        self.eos()
        return self._g.wait(timeout)
