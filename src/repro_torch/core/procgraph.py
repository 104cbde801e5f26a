"""Process-graph runtime — the ``procs`` backend of the skeleton IR.

The port's copy of ``repro.core.procgraph``.  Its ``metrics=`` and
``monitor=`` options, like the threads backend's, belong to a later slice
of the port and raise :class:`~repro_torch.core.skeleton.LoweringError`.

``graph.py`` runs every vertex as a *thread*, which keeps the runtime
cheap but leaves pure-Python stages serialised behind the GIL: the
FastFlow speedup story (paper Sec. 6) only materialises there for
GIL-releasing kernels.  This module mirrors the same vertex machinery —
source/stage vertices, dispatch + merge arbiters, tagged-token ordered
farms, EOS propagation, loop quiescence for wrap-around edges — with each
vertex a **spawned process** and every edge a :class:`~repro_torch.core.shm.ShmRing`
(the paper's SPSC ring over genuinely shared memory, cache-line-separated
head/tail and all).  A farm of pure-Python ``svc`` functions finally
scales with cores.

Construct map (vs the threads backend)
--------------------------------------
=============================  =============================================
threads (``graph.py``)         procs (this module)
=============================  =============================================
``threading.Thread`` vertex    ``spawn``-ed ``multiprocessing.Process``
``SPSCQueue`` edge             ``ShmRing`` edge (pickled = attach by name)
``Graph.results`` list         a results ring drained by the calling process
``Graph.failed`` list          a shared failure flag (:class:`ShmFlag`) + a
                               per-vertex control ring carrying ready/error
                               messages back to the caller
``TagSpace.entered/retired``   ``ShmCounters`` board: two single-writer
                               cache-line-separated u64s (dispatch writes
                               ``entered``, merge writes ``retired``)
``FarmStats`` (shared object)  per-arbiter local stats, merged at EOS and
                               surfaced to the caller over a stats ring
``sched.Scheduler`` policies   the same policy objects, driven from the
                               dispatch arbiter's process (idle/steal and
                               service-EWMA side-channels become ShmRings)
=============================  =============================================

Single-writer discipline is preserved end to end: every ring has one
producer and one consumer process; the quiescence board splits its
counters by writer; the scheduling policy lives entirely inside the
dispatch arbiter's process.  Even the *control plane* is shared-memory
SPSC: ready/error messages ride a per-vertex control ring (vertex →
caller) and the failure signal is a :class:`~repro_torch.core.shm.ShmFlag`
(idempotent multi-writer store).  Nothing on any path needs a lock —
and, unlike ``multiprocessing``'s Queue/Event, every control primitive
pickles as a plain segment attach, which is what lets vertices ride
through a queue to **pooled** worker processes.

Spawn-pool reuse: starting a spawned interpreter costs ~0.1s (import of
``repro_torch.core`` dominates; it imports no torch); a program that lowers the same skeleton
repeatedly would pay it per run, per vertex.  ``run()`` therefore leases
processes from a module-level pool (one per start method): each pooled
worker loops ``job = jobq.get(); vertex._run()``, re-arming between
graphs, so only the first run pays the spawn.  Workers whose graph
failed or timed out are terminated and replaced; clean workers return to
the pool.  Opt out per program (``lower(skel, "procs", pool=False)``)
or globally (``REPRO_PROCS_POOL=0``).

Constraints of the process world (all spawn-start-method induced):

* nodes, payloads and scheduling policies must be **picklable** —
  module-level functions, ``functools.partial``, or ``ff_node``
  subclasses; lambdas and closures are rejected at ``run()`` with a
  :class:`~repro_torch.core.skeleton.LoweringError`;
* ``speculative=`` straggler re-issue is threads-only (its tag bookkeeping
  is cross-arbiter shared state), rejected at lowering;
* ``Farm.stats`` is updated *after* the run (merged snapshot), not live.

The start method defaults to ``spawn``: a fork after CUDA is initialised
is unsafe, and fork would duplicate the caller's runtime threads.
Override with ``REPRO_PROCS_START`` if you must.  A process that leaves
through ``os._exit`` skips the ``atexit`` hook that retires the pool:
call :func:`pool_shutdown` first.
"""
from __future__ import annotations

import atexit
import os
import pickle
import time
import multiprocessing as mp
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .obs import VertexTracer, qualname as _qualname
from .sched import Scheduler, make_scheduler
from .shm import ShmCounters, ShmFlag, ShmRing
from .skeleton import (BACKENDS, GO_ON, AllToAll, EmitMany, Farm, FarmStats,
                       Feedback, KeyBatch, LoweringError, Pipeline, Skeleton,
                       Source, Stage, _FarmEmitMany, _coerce_tracer,
                       _has_grained_stage, as_skeleton, ff_node,
                       fuse as _fuse_pass)
from .spsc import EOS, SPSCQueue

__all__ = [
    "ProcGraph", "ProcVertex", "ProcStageVertex", "ProcDispatchVertex",
    "ProcWorkerVertex", "ProcMergeVertex", "build", "ProcProgram",
    "ProcAccelerator", "pool_stats", "pool_shutdown",
]

_EMPTY = SPSCQueue._EMPTY
_POLL = 0.000_05          # poll backoff (matches the SPSC blocking helpers)
_BATCH = 256              # max items drained per ring per arbiter wake-up
_ENTERED, _RETIRED = 0, 1  # quiescence-board slots (see ShmCounters)


# Wire format: a farm token is a plain ``(tag, issued_at, payload)`` tuple,
# not graph.py's Token dataclass — a tuple pickles in a third of the bytes
# and time, and the procs backend has no speculation, so the ``duplicate``
# flag would be dead weight on every hop.  ``issued_at`` is 0.0 except on a
# 1-in-16 latency sample: clock reads are syscalls, expensive under
# sandboxed kernels, and the latency reservoir only needs a sample.
_LAT_SAMPLE = 15  # tag & _LAT_SAMPLE == 0 -> stamp and measure


class _WorkerStats:
    """A worker's final telemetry, sent down its own data ring just before
    it acknowledges EOS — the single-writer way to get worker-side numbers
    (the service-time EWMA) into the merge arbiter's FarmStats without any
    shared object."""

    __slots__ = ("index", "ewma")

    def __init__(self, index: int, ewma: Optional[float]):
        self.index = index
        self.ewma = ewma


def _start_ctx():
    return mp.get_context(os.environ.get("REPRO_PROCS_START", "spawn"))


class _Aborted(Exception):
    """Internal: this vertex gave up because another vertex already failed
    (its peer may be dead and its ring full — blocking would hang)."""


class _Backoff:
    """Adaptive idle backoff: 50µs doubling to 1ms while nothing moves.

    The thread backend can poll at a fixed 50µs because a sleeping thread
    is nearly free; here every vertex is a *process* competing for the
    same cores as the workers, and on a small machine every arbiter
    wake-up is a context switch that preempts a worker mid-task (markedly
    expensive under sandboxed kernels, where ``sleep(50µs)`` rounds up to
    ~1ms anyway).  Doubling the sleep caps the idle wake rate at ~200/s
    per vertex while bounding added latency at 5ms — noise against any
    grain worth sending to a process farm, and the arbiters batch-drain
    their rings per wake (``_BATCH``) so throughput never rides on the
    wake rate.

    AIMD, not reset-to-floor: progress *halves* the delay, idleness
    doubles it.  A full reset on every popped token would pin a collector
    at the maximum wake rate whenever results trickle in one at a time —
    exactly the steady state of a coarse-grain farm — while halving
    converges the wake rate to ~2× the arrival rate and lets the batch
    drain do the rest."""

    __slots__ = ("delay",)
    _CAP = 0.005

    def __init__(self):
        self.delay = _POLL

    def reset(self) -> None:
        self.delay = max(self.delay / 2, _POLL)

    def idle(self) -> None:
        time.sleep(self.delay)
        self.delay = min(self.delay * 2, self._CAP)


def _vertex_main(vertex: "ProcVertex") -> None:
    """Child-process entry point (module-level: spawn pickles by name)."""
    vertex._run()


class _CtlRing:
    """Vertex-side endpoint of the control ring (vertex → caller).

    Wraps the ring behind a ``put()`` so vertex code keeps its queue-ish
    control surface; the ring never legitimately fills (≤ 3 messages per
    vertex against capacity 8: ready, an optional error, an optional
    EOS-time trace ship-back), so a timeout here means the caller is gone
    and the message is dropped rather than wedging teardown."""

    __slots__ = ("_ring",)

    def __init__(self, ring: ShmRing):
        self._ring = ring

    def put(self, msg: Tuple) -> None:
        self._ring.push_wait(msg, timeout=10.0)


# ---------------------------------------------------------------------------
# the spawn pool: reusable vertex-host processes, one pool per start method
# ---------------------------------------------------------------------------
def _pool_main(jobq, doneq) -> None:
    """Pooled vertex-host: run one vertex per job, then re-arm.  The spawn
    and import cost is paid once per *process*, not once per run."""
    base_cpus = None
    if hasattr(os, "sched_getaffinity"):
        try:
            base_cpus = os.sched_getaffinity(0)
        except OSError:  # pragma: no cover - exotic kernels
            pass
    while True:
        vertex = jobq.get()
        if vertex is None:
            return
        try:
            _vertex_main(vertex)
        finally:
            if base_cpus is not None and vertex.cpus:
                try:  # undo the vertex's pin: the next job chooses its own
                    os.sched_setaffinity(0, base_cpus)
                except OSError:  # pragma: no cover
                    pass
            vertex = None  # drop ring attachments before signalling done
            doneq.put(True)


class _PoolWorker:
    """One leased process: a job queue in, a done-token queue out."""

    __slots__ = ("jobq", "doneq", "proc", "busy")

    def submit(self, vertex: "ProcVertex") -> None:
        # SimpleQueue.put pickles synchronously in THIS thread — an
        # unpicklable vertex raises here, before any bytes hit the pipe,
        # so the worker stays clean and reusable
        self.jobq.put(vertex)
        self.busy = True

    def poll_done(self) -> bool:
        if self.busy:
            while not self.doneq.empty():
                self.doneq.get()
                self.busy = False
        return not self.busy


class _ProcPool:
    """Reusable spawned processes for one start method.

    ``acquire`` hands out an idle worker (or spawns one), ``release``
    parks it for the next graph.  Workers are generic vertex hosts — a
    process that ran a farm worker last graph may run a merge arbiter in
    the next — so the pool needs no shape bookkeeping, only liveness."""

    MAX_IDLE = 12  # parked interpreters cost memory; beyond this, retire

    def __init__(self, ctx):
        self._ctx = ctx
        self._idle: List[_PoolWorker] = []
        self.spawned = 0  # telemetry: processes ever started
        self.reused = 0   # telemetry: acquisitions that skipped a spawn

    def acquire(self) -> _PoolWorker:
        while self._idle:
            w = self._idle.pop()
            if w.proc.is_alive():
                self.reused += 1
                return w
            self.discard(w)
        w = _PoolWorker()
        w.jobq = self._ctx.SimpleQueue()
        w.doneq = self._ctx.SimpleQueue()
        w.busy = False
        self.spawned += 1
        w.proc = self._ctx.Process(target=_pool_main,
                                   args=(w.jobq, w.doneq),
                                   name=f"ff-pool-{self.spawned}",
                                   daemon=True)
        w.proc.start()
        return w

    def release(self, w: _PoolWorker) -> None:
        if w.proc.is_alive() and not w.busy \
                and len(self._idle) < self.MAX_IDLE:
            self._idle.append(w)
        else:
            self.discard(w)

    def discard(self, w: _PoolWorker) -> None:
        try:
            if w.proc.is_alive() and not w.busy:
                w.jobq.put(None)  # polite: let the loop return
                w.proc.join(0.5)
        except Exception:  # pragma: no cover - pipes may already be gone
            pass
        if w.proc.is_alive():
            w.proc.terminate()
            w.proc.join(5.0)
        for q in (w.jobq, w.doneq):
            try:
                q.close()
            except Exception:  # pragma: no cover
                pass

    def shutdown(self) -> None:
        while self._idle:
            self.discard(self._idle.pop())


_POOLS: Dict[str, _ProcPool] = {}


def _get_pool(ctx) -> _ProcPool:
    key = ctx.get_start_method()
    pool = _POOLS.get(key)
    if pool is None:
        pool = _POOLS[key] = _ProcPool(ctx)
    return pool


def _pool_enabled(pool: Optional[bool]) -> bool:
    if pool is not None:
        return pool
    return os.environ.get("REPRO_PROCS_POOL", "1") != "0"


def pool_stats() -> Dict[str, Dict[str, int]]:
    """Spawn-pool telemetry per start method (spawned/reused/idle)."""
    return {k: {"spawned": p.spawned, "reused": p.reused,
                "idle": len(p._idle)}
            for k, p in _POOLS.items()}


def pool_shutdown() -> None:
    """Retire every idle pooled worker (tests and interpreter exit)."""
    for pool in _POOLS.values():
        pool.shutdown()


atexit.register(pool_shutdown)


# ---------------------------------------------------------------------------
# vertices: one spawned process each, private ShmRing endpoints
# ---------------------------------------------------------------------------
class ProcVertex:
    """A network vertex: one process, private shared-memory SPSC endpoints.

    ``failed`` (:class:`ShmFlag`) and ``ctl`` (:class:`_CtlRing`) are
    attached by :meth:`ProcGraph.add` — the control plane.  Both pickle
    as segment attaches, so a vertex travels equally well through
    ``Process`` args (direct spawn) and a pool worker's job queue.
    ``cpus`` is an optional placement hint (see ``Scheduler.worker_cpus``)
    applied best-effort on entry and undone by the pool between jobs.
    """

    def __init__(self, node: Optional[ff_node] = None, *,
                 name: str = "ff-pvertex"):
        self.node = node
        self.name = name
        # batch-aware nodes (SpillFold) take a whole KeyBatch in one svc
        # call; everyone else gets it unpacked by the vertex loop
        self._takes_batches = bool(getattr(node, "accepts_batches", False))
        self.ins: List[ShmRing] = []
        self.outs: List[ShmRing] = []
        self.failed: Any = None   # ShmFlag, set by ProcGraph.add
        self.ctl: Any = None      # _CtlRing, set by ProcGraph.add
        self.cpus: Optional[Tuple[int, ...]] = None
        # observability: ``path`` is the IR path assigned by build();
        # trace config travels as plain ints (picklable through spawn and
        # the pool job queue) — the VertexTracer itself is built child-
        # side in _run() and shipped back over the control ring at EOS
        self.path = ""
        self.trace_sample = 0     # 0 = tracing off
        self.trace_capacity = 0
        self.tracer: Optional[VertexTracer] = None

    # -- lifecycle (runs in the vertex's own process) -----------------------
    def _run(self) -> None:
        t_birth = 0.0
        try:
            if self.trace_sample:
                self.tracer = VertexTracer(self.name, self.path,
                                           sample=self.trace_sample,
                                           capacity=self.trace_capacity)
                t_birth = time.monotonic()
                if self.node is not None and \
                        getattr(self.node, "wants_tracer", False):
                    self.node.tracer = self.tracer
            if self.cpus:
                try:
                    os.sched_setaffinity(0, self.cpus)
                except (AttributeError, OSError):  # hint only: never fatal
                    pass
            if self.node is not None:
                self.node.svc_init()
            self.ctl.put(("ready", self.name))
            self._loop()
        except _Aborted:
            pass  # secondary shutdown; the original error is on the ctl queue
        except BaseException as e:
            self._report_error(e)
        finally:
            for q in self.outs:
                self._push_abortable(q, EOS)
            if self.node is not None:
                try:
                    self.node.svc_end()
                except BaseException as e:  # pragma: no cover - defensive
                    self._report_error(e)
            tr = self.tracer
            if tr is not None:
                tr.instant("eos")
                tr.span("life", t_birth, time.monotonic())
                try:  # ship the lane home; best-effort at teardown
                    self.ctl.put(("trace", self.name, self.path,
                                  os.getpid(), tr.events, tr.dropped))
                except Exception:  # pragma: no cover - caller gone
                    pass
            self._flush_stats()
            for q in self.ins + self.outs:
                q.close()

    def _report_error(self, e: BaseException) -> None:
        self.failed.set()
        # the control ring pickles synchronously in put(), so an
        # unpicklable exception would raise mid-report and LOSE the
        # message — probe first and degrade to the repr
        try:
            pickle.dumps(e)
        except Exception:
            self.ctl.put(("error", self.name, repr(e), None))
        else:
            self.ctl.put(("error", self.name, repr(e), e))

    def _flush_stats(self) -> None:
        """Hook: arbiters surface their stats snapshots at shutdown."""

    def _loop(self) -> None:
        raise NotImplementedError

    def _push_abortable(self, q: ShmRing, item: Any) -> bool:
        """Blocking push that gives up once the graph has failed (the
        ring's consumer may be dead; blocking would hang the teardown)."""
        spins = 0
        while not q.push(item):
            spins += 1
            if spins > 64:
                if self.failed.is_set():
                    return False
                time.sleep(_POLL)
        return True

    def _deliver(self, payload: Any) -> None:
        if not self._push_abortable(self.outs[0], payload):
            raise _Aborted()


class ProcStageVertex(ProcVertex):
    """Generic vertex: nondeterministic fan-in merge, single-out.  With no
    inbound edges it is a *source*: ``svc(None)`` until ``None`` (EOS) —
    paper Fig. 2's emitter protocol, same as ``graph.StageVertex``.

    ``batch > 1`` turns on the batched-emit wire format: outputs gather
    in a local buffer and ship ``batch`` at a time through
    :meth:`ShmRing.push_many` — one slot header and one tail store per
    run of items instead of per item, which is what lets fine-grain
    streams amortize the per-hop cost.  The buffer is flushed after the
    node's EOS hook and *before* the EOS sentinel leaves this vertex, so
    stream ordering (including the eosnotify release of keyed folds) is
    byte-identical to the unbatched wire."""

    def __init__(self, node: ff_node, *, name: str = "ff-pstage",
                 batch: int = 1):
        super().__init__(node, name=name)
        self.batch = max(1, int(batch))
        self._obuf: List[Any] = []

    def _deliver(self, payload: Any) -> None:
        if self.batch <= 1:
            super()._deliver(payload)
            return
        self._obuf.append(payload)
        if len(self._obuf) >= self.batch:
            self._flush_batch()

    def _flush_batch(self) -> None:
        buf = self._obuf
        if not buf:
            return
        out = self.outs[0]
        backoff = _Backoff()
        i = 0
        while i < len(buf):
            n = out.push_many(buf[i:] if i else buf)
            if n:
                i += n
                continue
            if self.failed.is_set():
                self._obuf = []
                raise _Aborted()
            backoff.idle()
        self._obuf = []

    def _loop(self) -> None:
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
            self._flush_batch()
            return
        eos: set = set()
        backoff = _Backoff()
        while len(eos) < len(self.ins):
            progress = False
            for i, q in enumerate(self.ins):
                if i in eos:
                    continue
                # batch-drain: a sleeping process pays ~1ms to wake, so one
                # wake must move everything the ring has (bounded, for
                # fairness across inbound edges)
                for _ in range(_BATCH):
                    item = q.pop()
                    if item is _EMPTY:
                        break
                    progress = True
                    if item is EOS:
                        eos.add(i)
                        break
                    if type(item) is KeyBatch and not self._takes_batches:
                        # batched wire format: unpack here so the node
                        # still sees items (batching is transport only)
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
            if progress:
                backoff.reset()
            else:
                if self.failed.is_set():
                    raise _Aborted()
                # nothing inbound: ship the partial batch rather than
                # holding the stream's tail hostage to the batch size
                self._flush_batch()
                backoff.idle()
        self._flush_eos()
        self._flush_batch()

    def _flush_eos(self) -> None:
        """EOS flush (eosnotify), mirroring ``graph.StageVertex``: the node
        may emit buffered state into the stream before this vertex's EOS
        goes out — keyed folds and window operators release here."""
        out = self.node.svc_eos()
        if out is not None and out is not GO_ON:
            self._emit(out)

    def _emit(self, out: Any) -> None:
        if type(out) is KeyBatch:  # one wire message; consumers unpack
            if out:
                self._deliver(out)
            return
        if isinstance(out, EmitMany):  # multi-emit (e.g. a reorder flush)
            for o in out:
                self._emit(o)
            return
        self._deliver(out)


class ProcDispatchVertex(ProcVertex):
    """The farm's Emitter arbiter as a process (paper Figs. 1-2).

    Drives the same pluggable :class:`~repro_torch.core.sched.Scheduler` policy
    hierarchy as the thread backend — the policy object (and all its
    state: worksteal backlogs, costmodel EWMAs) lives entirely in this
    arbiter's process, so the single-writer discipline is untouched.
    Worker side-channels (worksteal idle rings, costmodel service-EWMA
    rings) are ShmRings, drained here.  When ``loop_ring`` is set this
    vertex is the loop master: quiescence reads the merge arbiter's
    ``retired`` counter off the shared :class:`ShmCounters` board.
    """

    def __init__(self, sched: Scheduler, node: Optional[ff_node] = None, *,
                 loop_ring: Optional[ShmRing] = None,
                 loop_board: Optional[ShmCounters] = None,
                 service_rings: Optional[List[ShmRing]] = None,
                 stats_out: Optional[ShmRing] = None,
                 live_board: Optional[ShmCounters] = None,
                 name: str = "ff-emitter"):
        super().__init__(node, name=name)
        self.sched = sched
        self.loop_ring = loop_ring
        self.loop_board = loop_board
        self.live_board = live_board  # monitor tap: slot 0 = emitted
        self.service_rings = service_rings or []
        self.stats_out = stats_out  # dispatch -> merge stats hand-off
        self.stats = FarmStats()
        self._next_tag = 0
        self._entered = 0
        self._stash: List[Any] = []

    def _drain_service(self) -> None:
        """Fold worker service-EWMA updates into the policy's stats (the
        cross-process replacement for workers writing ``FarmStats``
        directly — arbiter-side state stays in the arbiter process)."""
        for ring in self.service_rings:
            while True:
                upd = ring.pop()
                if upd is _EMPTY:
                    break
                self.sched.observe_service(upd[0], upd[1])

    def _push_with_loop_drain(self, q: ShmRing, tok: tuple) -> None:
        """Blocking push that keeps draining the wrap-around ring while
        the target worker ring is full (breaks cyclic backpressure, same
        argument as ``graph.DispatchVertex._push_with_loop_drain``)."""
        if q.push(tok):
            return  # fast path: no stall, no clock read
        tr = self.tracer
        t0 = time.monotonic() if tr is not None else 0.0
        spins = 0
        while not q.push(tok):
            if self.loop_ring is not None:
                item = self.loop_ring.pop()
                if item is not _EMPTY:
                    self._stash.append(item)
                    continue
            spins += 1
            if spins > 64:
                if self.failed.is_set():
                    raise _Aborted()
                time.sleep(_POLL)
        if tr is not None:
            tr.span("stall", t0, time.monotonic())

    def _emit_to(self, widx: int, tok: tuple) -> None:
        self._push_with_loop_drain(self.outs[widx], tok)

    def _dispatch(self, task: Any) -> None:
        tag = self._next_tag
        issued = time.monotonic() if tag & _LAT_SAMPLE == 0 else 0.0
        tok = (tag, issued, task)
        self._next_tag += 1
        if self.loop_board is not None:
            self._entered += 1
            self.loop_board.add(_ENTERED, 1)
        self.sched.place(tok, self._emit_to)
        self.stats.tasks_emitted += 1
        if self.live_board is not None:
            self.live_board.add(0, 1)  # single writer: this arbiter only
        # backpressure for token-holding policies (worksteal): stop intake
        # while the policy backlog is over its high-water mark
        hw = self.sched.high_water
        if hw is not None and self.sched.pending() > hw:
            tr = self.tracer
            t0 = time.monotonic() if tr is not None else 0.0
            spins = 0
            while self.sched.pending() > hw:
                if self.sched.pump():
                    continue
                if self.failed.is_set():
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

    def _quiescent(self) -> bool:
        """entered == retired and the wrap-around ring is drained.  Read
        order matters: ``retired`` first, then the ring — the merge
        arbiter pushes looped-back tasks *before* bumping ``retired``."""
        retired = self.loop_board.get(_RETIRED)
        return self._entered == retired and self.loop_ring.empty()

    def _loop(self) -> None:
        self.sched.bind(self.outs, self.stats)
        tr = self.tracer
        steals0 = self.stats.steals if tr is not None else 0
        backoff = _Backoff()
        if self.node is not None and not self.ins:
            # source mode: the emitter node generates the stream
            while True:
                self._drain_service()
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
                self.sched.pump()
                if tr is not None and self.stats.steals != steals0:
                    tr.instant("steal",
                               {"count": self.stats.steals - steals0})
                    steals0 = self.stats.steals
                if self.loop_ring is not None:
                    while True:
                        item = self.loop_ring.pop()
                        if item is _EMPTY:
                            break
                        self._dispatch(item)
                        if tr is not None:
                            tr.tick("loop")
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
                        and self._quiescent():
                    break
                if self.failed.is_set():
                    raise _Aborted()
                if progress:
                    backoff.reset()
                elif self.sched.pending():
                    time.sleep(0)  # yield: the policy still holds tokens
                else:
                    backoff.idle()
        else:
            eos: set = set()
            while True:
                progress = self.sched.pump()
                self._drain_service()
                if tr is not None and self.stats.steals != steals0:
                    tr.instant("steal",
                               {"count": self.stats.steals - steals0})
                    steals0 = self.stats.steals
                # wrap-around tokens first: looped-back work is older
                while self._stash:
                    self._dispatch(self._stash.pop(0))
                    progress = True
                if self.loop_ring is not None:
                    while True:
                        item = self.loop_ring.pop()
                        if item is _EMPTY:
                            break
                        progress = True
                        self._dispatch(item)
                        if tr is not None:
                            tr.tick("loop")
                for i, q in enumerate(self.ins):
                    if i in eos:
                        continue
                    for _ in range(_BATCH):  # amortise the wake-up cost
                        item = q.pop()
                        if item is _EMPTY:
                            break
                        progress = True
                        if item is EOS:
                            eos.add(i)
                            break
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
                if len(eos) == len(self.ins) and not self._stash \
                        and not self.sched.pending():
                    if self.loop_ring is None or self._quiescent():
                        break
                if self.failed.is_set():
                    raise _Aborted()  # a vertex died: no quiescence possible
                if progress:
                    backoff.reset()
                elif self.sched.pending():
                    time.sleep(0)  # yield: the policy still holds tokens
                else:
                    backoff.idle()
        # flush tokens still held by the policy (worksteal backlogs)
        # before the EOS goes out behind them
        while self.sched.pending():
            if self.failed.is_set():
                raise _Aborted()
            if not self.sched.pump():
                time.sleep(0)

    def _flush_stats(self) -> None:
        # hand the dispatch-side counters to the merge arbiter, which owns
        # the farm's merged FarmStats snapshot (SPSC: one producer, one
        # consumer; the data rings to the workers are already EOS'd)
        if self.stats_out is not None:
            self.stats_out.push_wait(self.stats, timeout=2.0)
            self.stats_out.close()


class ProcWorkerVertex(ProcVertex):
    """Farm worker process: one inbound and one outbound ring, tags carried
    through untouched.  With an ``idle_ring`` (worksteal) it advertises
    idleness to the arbiter; with a ``service_ring`` (costmodel) it streams
    its service-time EWMA back — both SPSC ShmRings, worker → arbiter."""

    def __init__(self, node: ff_node, index: int, *,
                 idle_ring: Optional[ShmRing] = None,
                 service_ring: Optional[ShmRing] = None,
                 name: str = "ff-worker"):
        super().__init__(node, name=name)
        self.index = index
        self.idle_ring = idle_ring
        self.service_ring = service_ring

    def _loop(self) -> None:
        q_in, q_out = self.ins[0], self.outs[0]
        tr = self.tracer
        record = self.service_ring is not None
        ewma: Optional[float] = None
        backoff = _Backoff()
        signaled = False
        spins = 0
        while True:
            tok = q_in.pop()
            if tok is _EMPTY:
                if self.idle_ring is not None and \
                        (not signaled or spins % 512 == 511):
                    # steal side-channel: advertise idleness (re-advertise
                    # periodically — a signal consumed while the arbiter
                    # had nothing to give must not strand this worker)
                    signaled = self.idle_ring.push(self.index) or signaled
                spins += 1
                if spins > 64:
                    if self.failed.is_set():
                        raise _Aborted()
                    backoff.idle()
                continue
            signaled = False
            spins = 0
            backoff.reset()
            if tok is EOS:
                if record:
                    self._push_abortable(q_out, _WorkerStats(self.index, ewma))
                return
            tag, issued, payload = tok
            tb = tr.begin() if tr is not None else 0.0
            if record:
                t0 = time.monotonic()
                result = self.node.svc(payload)
                dt = time.monotonic() - t0
                ewma = dt if ewma is None else 0.8 * ewma + 0.2 * dt
                self.service_ring.push((self.index, ewma))  # drop-if-full ok
            else:
                result = self.node.svc(payload)
            if tr is not None:
                tr.end(tb, "svc")
            if not self._push_abortable(q_out, (tag, issued, result)):
                raise _Aborted()


class ProcMergeVertex(ProcVertex):
    """The farm's Collector arbiter as a process (paper Figs. 1-2).

    Optional reorder-by-tag (``ordered``), optional collector node,
    optional wrap-around routing (``feedback``), as in
    ``graph.MergeVertex`` — minus the dedup-by-tag bookkeeping: the procs
    backend rejects speculation at lowering, so duplicates are impossible
    by construction and a per-tag seen-dict would only be an unbounded
    leak in a long-lived farm.  Owns the farm's merged :class:`FarmStats`:
    collects its own side, folds in the dispatch side from the ``d2m``
    stats ring at EOS, and surfaces the snapshot to the calling process
    over the farm's stats ring."""

    def __init__(self, node: Optional[ff_node] = None, *,
                 ordered: bool = False,
                 loop_ring: Optional[ShmRing] = None,
                 loop_board: Optional[ShmCounters] = None,
                 feedback: Optional[Callable[[Any], Tuple[Any, Iterable[Any]]]] = None,
                 stats_in: Optional[ShmRing] = None,
                 stats_out: Optional[ShmRing] = None,
                 live_board: Optional[ShmCounters] = None,
                 name: str = "ff-collector"):
        super().__init__(node, name=name)
        self.ordered = ordered
        self.loop_ring = loop_ring
        self.loop_board = loop_board
        self.live_board = live_board  # monitor tap: slot 1 = collected
        self.feedback = feedback
        self.stats_in = stats_in    # dispatch -> merge counter hand-off
        self.stats_out = stats_out  # merge -> caller snapshot
        self.stats = FarmStats()

    def _loop(self) -> None:
        st = self.stats
        eos: set = set()
        next_tag = 0
        reorder: Dict[int, Any] = {}
        backoff = _Backoff()
        while len(eos) < len(self.ins):
            progress = False
            for i, q in enumerate(self.ins):
                if i in eos:
                    continue
                for _ in range(_BATCH):  # amortise the wake-up cost
                    tok = q.pop()
                    if tok is _EMPTY:
                        break
                    progress = True
                    if tok is EOS:
                        eos.add(i)
                        break
                    if isinstance(tok, _WorkerStats):
                        if tok.ewma is not None:
                            st.service_ewma[tok.index] = tok.ewma
                        continue
                    tag, issued, payload = tok
                    st.tasks_collected += 1
                    if self.live_board is not None:
                        self.live_board.add(1, 1)  # single writer: merge only
                    st.per_worker[i] = st.per_worker.get(i, 0) + 1
                    if issued:
                        st.latencies.append(time.monotonic() - issued)
                    if self.ordered:
                        reorder[tag] = payload
                        while next_tag in reorder:
                            self._complete(reorder.pop(next_tag))
                            next_tag += 1
                    else:
                        self._complete(payload)
            if progress:
                backoff.reset()
            else:
                if self.failed.is_set():
                    raise _Aborted()
                backoff.idle()
        # flush any residue (can only happen if tags were skipped upstream)
        for t in sorted(reorder):
            self._complete(reorder.pop(t))

    def _complete(self, payload: Any) -> None:
        if payload is GO_ON:
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
            # push wrap-around tasks BEFORE retiring the token: the
            # dispatch arbiter's quiescence check relies on this ordering
            # (now across processes, on x86-TSO store order).
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
            for p in payload:
                self._deliver(p)
            return
        self._deliver(payload)

    def _retire(self) -> None:
        if self.loop_board is not None:
            self.loop_board.add(_RETIRED, 1)

    def _flush_stats(self) -> None:
        if self.stats_in is not None:
            # fold the dispatch side in (it flushes right after EOS'ing
            # the workers, so it is normally already here)
            disp = self.stats_in.pop_wait(timeout=2.0)
            if disp is not _EMPTY and isinstance(disp, FarmStats):
                _fold_stats(self.stats, disp)
            self.stats_in.close()
        if self.stats_out is not None:
            self.stats_out.push_wait(self.stats, timeout=2.0)
            self.stats_out.close()


def _fold_stats(dst: FarmStats, src: FarmStats) -> None:
    """Merge one FarmStats snapshot into another (disjoint writers: each
    counter was filled by exactly one arbiter/worker, so += is exact)."""
    dst.tasks_emitted += src.tasks_emitted
    dst.tasks_collected += src.tasks_collected
    dst.duplicates_issued += src.duplicates_issued
    dst.duplicates_dropped += src.duplicates_dropped
    dst.steals += src.steals
    dst.spills += src.spills
    dst.spill_bytes += src.spill_bytes
    dst.backpressure_stalls += src.backpressure_stalls
    for k, v in src.per_worker.items():
        dst.per_worker[k] = dst.per_worker.get(k, 0) + v
    dst.service_ewma.update(src.service_ewma)
    for x in src.latencies:
        dst.latencies.append(x)
    dst.worker_failures.extend(src.worker_failures)


# ---------------------------------------------------------------------------
# the graph: spawned vertices + shared-memory edges, driven by the caller
# ---------------------------------------------------------------------------
class ProcGraph:
    """A streaming network of processes over shared-memory SPSC rings.

    Mirrors :class:`graph.Graph`'s API (``add``/``connect``/``run``/
    ``wait``) with process semantics: the caller is the single consumer of
    the results ring, errors arrive over per-vertex control rings, and
    ``wait`` tears everything down — returns pooled workers (or joins /
    terminates direct-spawned ones) and unlinks every shared-memory
    segment, so no run leaks processes or ``/dev/shm`` entries.

    ``zero_copy`` flows to every edge ring (typed buffer-protocol slots);
    ``batch`` turns on batched emit for stage vertices — ``None`` off,
    an int for a global batch size, or ``"grain"`` to read each stage's
    declared ``grain=`` as its batch size; ``pool`` selects spawn-pool
    reuse (default: on unless ``REPRO_PROCS_POOL=0``)."""

    def __init__(self, *, capacity: int = 512, slot_size: int = 248,
                 zero_copy: bool = True, batch: Any = None,
                 pool: Optional[bool] = None):
        self.capacity = capacity
        self.slot_size = slot_size
        self.zero_copy = zero_copy
        self.batch = batch
        self._ctx = _start_ctx()
        self._pool = _get_pool(self._ctx) if _pool_enabled(pool) else None
        self.vertices: List[ProcVertex] = []
        self.results: List[Any] = []
        self.failed: List[BaseException] = []
        self._rings: List[Any] = []          # every segment, for unlink
        self.failed_event = ShmFlag()
        self._rings.append(self.failed_event)
        self._ctl_rings: List[ShmRing] = []  # one per vertex, vertex->caller
        self._procs: List[Any] = []
        self._pool_workers: List[_PoolWorker] = []
        self._farm_stats: List[Tuple[Farm, ShmRing]] = []
        # post-run hooks (builders register them): read telemetry boards
        # back into the IR node's stats BEFORE shared memory is unlinked
        self.finalizers: List[Callable[[], None]] = []
        self._results_rings: List[ShmRing] = []
        self._eos_rings: set = set()
        self._eos_seen = False
        self._ready = 0
        self._cleaned = False
        # observability: when set (obs.Tracer), run() hands each vertex
        # its sampling config; lanes come home over the control rings at
        # EOS and are absorbed here (caller side) by _on_ctl
        self.tracer = None
        # live monitoring: when live_telemetry is set before build(), each
        # farm gets a 2-slot single-writer ShmCounters board (slot 0 =
        # emitted by the dispatch arbiter, slot 1 = collected by the merge
        # arbiter) registered here by farm qualname — the Monitor reads
        # them caller-side with peek(), no ring traffic
        self.live_telemetry = False
        self.live_boards: Dict[str, ShmCounters] = {}

    # -- construction -------------------------------------------------------
    def channel(self, capacity: Optional[int] = None,
                slot_size: Optional[int] = None) -> ShmRing:
        ring = ShmRing(capacity or self.capacity,
                       slot_size or self.slot_size,
                       zero_copy=self.zero_copy)
        self._rings.append(ring)
        return ring

    def counters(self, n: int = 2) -> ShmCounters:
        board = ShmCounters(n)
        self._rings.append(board)
        return board

    def batch_for(self, grain: Optional[int]) -> int:
        """Resolve the effective emit-batch size for a stage declaring
        ``grain`` (1 = unbatched; see the class docstring)."""
        if self.batch is None:
            return 1
        if self.batch == "grain":
            return int(grain) if grain else 1
        return max(1, int(self.batch))

    def sample_high_water(self, into: Dict[str, int]) -> Dict[str, int]:
        """Profile tap, mirroring :meth:`graph.Graph.sample_high_water`:
        record each vertex's current outbound queue depth into ``into``,
        keeping the per-name maximum across calls.  The caller owns the
        ring segments, so ``len()`` (a read of the shared head/tail
        counters) works cross-process without touching the stream.  Keys
        are IR-path qualified (``name@path``), mirroring the threads
        backend, so merged reports cannot collide."""
        for v in self.vertices:
            depth = 0
            for ring in v.outs:
                try:
                    depth = max(depth, len(ring))
                except (TypeError, OSError, ValueError):
                    pass  # ValueError: memoryview released mid-teardown
            key = _qualname(v.name, v.path)
            if depth > into.get(key, -1):
                into[key] = depth
        return into

    def sample_depths(self, into: Dict[str, int]) -> Dict[str, int]:
        """Live-monitor tap, mirroring :meth:`graph.Graph.sample_depths`:
        the *instantaneous* outbound depth per vertex (overwrite
        semantics — one call = one timeline frame).  Safe against the
        monitor thread racing ``_cleanup()``: a ring whose segment is
        already unlinked reads as depth 0, never raises."""
        for v in self.vertices:
            depth = 0
            for ring in v.outs:
                try:
                    depth = max(depth, len(ring))
                except (TypeError, OSError, ValueError):
                    pass
            into[_qualname(v.name, v.path)] = depth
        return into

    def add(self, v: ProcVertex) -> ProcVertex:
        v.failed = self.failed_event
        # control edge: SPSC (this vertex produces, the caller consumes);
        # plain pickle — identity and fidelity over speed off the data path
        ring = ShmRing(8, 512, zero_copy=False)
        self._rings.append(ring)
        self._ctl_rings.append(ring)
        v.ctl = _CtlRing(ring)
        self.vertices.append(v)
        return v

    def connect(self, src: ProcVertex, dst: ProcVertex, *,
                capacity: Optional[int] = None) -> ShmRing:
        ring = self.channel(capacity)
        src.outs.append(ring)
        dst.ins.append(ring)
        return ring

    def results_ring(self) -> ShmRing:
        """A terminal edge: produced by ONE sink vertex, consumed by the
        calling process (SPSC discipline includes the caller).  Every call
        creates a fresh ring — a network with several sinks (the right row
        of a terminal all-to-all) gets one ring per sink, each
        single-producer, and the caller drains them all; the stream is
        complete when every ring has delivered EOS."""
        ring = self.channel(max(self.capacity, 1024))
        self._results_rings.append(ring)
        return ring

    def register_farm_stats(self, farm: Farm, ring: ShmRing) -> None:
        self._farm_stats.append((farm, ring))

    # -- execution ----------------------------------------------------------
    def run(self) -> "ProcGraph":
        assert not self._procs, "graph already running"
        tr = self.tracer
        if tr is not None:
            for v in self.vertices:
                v.trace_sample = tr.sample
                v.trace_capacity = tr.capacity
        pickling_errors = (pickle.PicklingError, AttributeError, TypeError)
        if self._pool is not None:
            for v in self.vertices:
                w = self._pool.acquire()
                try:
                    w.submit(v)
                except pickling_errors as e:
                    self._pool.release(w)  # put failed pre-pipe: still clean
                    self.shutdown()
                    raise self._lowering_error(e) from e
                self._pool_workers.append(w)
                self._procs.append(w.proc)
            return self
        try:
            for v in self.vertices:
                p = self._ctx.Process(target=_vertex_main, args=(v,),
                                      name=v.name, daemon=True)
                p.start()
                self._procs.append(p)
        except pickling_errors as e:
            self.shutdown()
            raise self._lowering_error(e) from e
        return self

    @staticmethod
    def _lowering_error(e: BaseException) -> LoweringError:
        return LoweringError(
            f"the procs backend spawns vertices, so nodes/payloads/"
            f"policies must be picklable (module-level functions, "
            f"functools.partial, or ff_node subclasses — not lambdas "
            f"or closures): {e!r}")

    def wait_ready(self, timeout: float = 60.0) -> None:
        """Block until every vertex has finished ``svc_init`` (used to
        exclude spawn/import cost from steady-state measurements)."""
        deadline = time.monotonic() + timeout
        while self._ready < len(self.vertices):
            if time.monotonic() > deadline:
                self.shutdown()
                raise TimeoutError(
                    f"procs graph: {self._ready}/{len(self.vertices)} "
                    f"vertices ready after {timeout}s")
            self._drain_ctl()
            if not self.failed:
                self._check_liveness()
            if self.failed:
                self.shutdown()
                raise self.failed[0]
            if self._ready < len(self.vertices):
                time.sleep(0.002)

    def poll_results(self) -> bool:
        """Drain whatever the results rings hold right now (non-blocking).
        Returns True once EVERY results ring has delivered EOS."""
        if self._eos_seen or not self._results_rings:
            return self._eos_seen
        for i, ring in enumerate(self._results_rings):
            if i in self._eos_rings:
                continue
            while True:
                item = ring.pop()
                if item is _EMPTY:
                    break
                if item is EOS:
                    self._eos_rings.add(i)
                    break
                if type(item) is KeyBatch:  # batched wire: caller sees items
                    self.results.extend(item)
                else:
                    self.results.append(item)
        self._eos_seen = len(self._eos_rings) == len(self._results_rings)
        return self._eos_seen

    def _on_ctl(self, msg: Tuple) -> None:
        if msg[0] == "ready":
            self._ready += 1
        elif msg[0] == "error":
            _, name, rep, exc = msg
            self.failed.append(
                exc if exc is not None else RuntimeError(f"{name}: {rep}"))
        elif msg[0] == "trace":
            _, name, path, pid, events, dropped = msg
            if self.tracer is not None:
                self.tracer.absorb(name, path, pid, events, dropped)

    def _drain_ctl(self) -> None:
        for ring in self._ctl_rings:
            while True:
                msg = ring.pop()
                if msg is _EMPTY:
                    break
                self._on_ctl(msg)

    def _all_vertices_exited(self) -> bool:
        if self._pool is not None:
            return bool(self._pool_workers) and all(
                w.poll_done() or not w.proc.is_alive()
                for w in self._pool_workers)
        return bool(self._procs) and all(not p.is_alive()
                                         for p in self._procs)

    def _check_liveness(self) -> None:
        for p in self._procs:
            if not p.is_alive() and p.exitcode not in (0, None):
                self._drain_ctl()
                if not self.failed:
                    self.failed.append(RuntimeError(
                        f"vertex process {p.name!r} died with exit code "
                        f"{p.exitcode} (killed?)"))
                return
        if self._results_rings and self._all_vertices_exited() \
                and not self.poll_results():
            self._drain_ctl()
            if not self.failed:  # pragma: no cover - defensive
                self.failed.append(RuntimeError(
                    "every vertex exited but EOS never reached the "
                    "results ring"))

    def wait(self, timeout: Optional[float] = None) -> List[Any]:
        """Drain results to EOS, join every vertex, surface FarmStats,
        unlink all shared memory; raise the first vertex error (or
        TimeoutError after terminating a wedged network)."""
        return self._wait_until(self.poll_results, timeout)

    def _wait_until(self, done_fn: Callable[[], bool],
                    timeout: Optional[float]) -> List[Any]:
        """Shared teardown: poll ``done_fn`` (which drains whatever rings
        the caller consumes and returns True once the stream has fully
        arrived), then join/terminate and unlink everything."""
        deadline = None if timeout is None else time.monotonic() + timeout
        timed_out = False
        try:
            backoff = _Backoff()
            last_ctl_check = 0.0
            while not done_fn():
                now = time.monotonic()
                if deadline is not None and now > deadline:
                    timed_out = True
                    break
                if now - last_ctl_check > 0.05:
                    # error/liveness checks off the hot path: the caller
                    # is a polling process too, and must not tax the cores
                    # the workers are using
                    last_ctl_check = now
                    self._drain_ctl()
                    if not self.failed:
                        self._check_liveness()
                    if self.failed:
                        break
                backoff.idle()
            if timed_out or self.failed:
                self.failed_event.set()  # unblock every vertex
            self._join_vertices(deadline,
                                aborting=timed_out or bool(self.failed))
            self._drain_ctl()
            if self.failed_event.is_set() and not self.failed \
                    and not timed_out:  # timeout sets the flag itself
                # belt over _report_error: a set flag with no message must
                # never let a truncated stream pass as success
                self.failed.append(RuntimeError(
                    "a vertex signalled failure but its error report was "
                    "lost"))
            self._collect_stats()
        finally:
            self._cleanup()
        if self.failed:
            raise self.failed[0]
        if timed_out:
            raise TimeoutError(
                f"procs graph did not reach EOS within {timeout}s "
                f"(vertices terminated, shared memory unlinked)")
        return self.results

    def run_and_wait(self, timeout: Optional[float] = None) -> List[Any]:
        return self.run().wait(timeout)

    def _collect_stats(self) -> None:
        for farm, ring in self._farm_stats:
            snap = ring.pop()
            if snap is not _EMPTY and isinstance(snap, FarmStats):
                _fold_stats(farm.stats, snap)
        while self.finalizers:
            self.finalizers.pop()()  # runs before _cleanup unlinks boards

    def _join_vertices(self, deadline: Optional[float],
                       aborting: bool) -> None:
        """Wait for every vertex to finish, then hand processes back.

        Pool mode: poll each worker's done token; clean live workers
        return to the pool, wedged or dead ones are terminated and
        retired (a failed graph must never donate a poisoned process).
        Direct-spawn mode: join, then terminate stragglers — as before.
        """
        if self._pool is not None:
            grace = 2.0 if aborting else (
                10.0 if deadline is None
                else max(0.1, deadline - time.monotonic()))
            end = time.monotonic() + grace
            while time.monotonic() < end:
                if all(w.poll_done() or not w.proc.is_alive()
                       for w in self._pool_workers):
                    break
                time.sleep(0.001)
            for w in self._pool_workers:
                if w.poll_done() and w.proc.is_alive():
                    self._pool.release(w)
                else:
                    w.proc.terminate()
                    w.proc.join(5.0)
                    self._pool.discard(w)
            self._pool_workers = []
            self._procs = []
            return
        for p in self._procs:
            grace = 10.0 if deadline is None \
                else max(0.1, deadline - time.monotonic())
            p.join(grace if not aborting else 2.0)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)

    def shutdown(self) -> None:
        """Hard stop: abort live vertices, unlink all shared memory.

        Pooled workers get a short grace to notice the failure flag and
        finish their job cleanly (so the pool keeps them); anything still
        busy after that is terminated and retired."""
        self.failed_event.set()
        if self._pool is not None:
            self._join_vertices(time.monotonic() + 1.0, aborting=True)
        else:
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
            for p in self._procs:
                p.join(5.0)
        self._cleanup()

    def _cleanup(self) -> None:
        if self._cleaned:
            return
        self._cleaned = True
        for ring in self._rings:
            ring.unlink()


# ---------------------------------------------------------------------------
# procs lowering: IR tree -> spawned vertices + shared-memory rings
# ---------------------------------------------------------------------------
def build(skel: Skeleton, g: ProcGraph, in_ring: Optional[Any],
          terminal: bool, path: str = "") -> Optional[Any]:
    """Wire a skeleton IR node into ``g`` — the procs twin of
    :func:`repro_torch.core.graph.build`, one spawned process per vertex.
    ``in_ring`` may be one ring or a list (a terminal all-to-all row).
    ``path`` is the node's IR path, carried onto every vertex so
    telemetry keys match the threads backend's."""
    from .graph import ring_list

    if isinstance(skel, AllToAll):
        from .a2a import build_proc_a2a  # lazy: a2a imports this module
        return build_proc_a2a(skel, g, ring_list(in_ring), terminal,
                              path=path)

    if isinstance(skel, Source):
        assert in_ring is None, "Source cannot have an upstream edge"
        return build(Stage(skel.node, name=skel.name, grain=skel.grain,
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
        if skel.speculative:
            raise LoweringError(
                "speculative straggler re-issue is threads-only (its tag "
                "bookkeeping is shared between the two arbiters); use "
                "lower(skel, 'threads') for it")
        cap = skel.capacity or g.capacity
        has_loop = skel.feedback is not None
        # the wrap-around ring: merge -> dispatch, plus the quiescence
        # board (entered/retired, one single-writer counter each)
        loop_ring = (g.channel(min(skel.feedback_capacity, 4096))
                     if has_loop else None)
        board = g.counters(2) if has_loop else None
        d2m = g.channel(4)          # dispatch -> merge stats hand-off
        stats_ring = g.channel(4)   # merge -> caller FarmStats snapshot
        g.register_farm_stats(skel, stats_ring)
        live = None
        if getattr(g, "live_telemetry", False):
            live = g.counters(2)    # monitor tap: emitted / collected
            g.live_boards[_qualname("ff-farm", path)] = live

        sched = make_scheduler(skel.scheduling)
        service_rings: List[ShmRing] = []
        disp = g.add(ProcDispatchVertex(
            sched, skel.emitter, loop_ring=loop_ring, loop_board=board,
            service_rings=service_rings, stats_out=d2m, live_board=live))
        disp.path = path
        if in_ring is not None:
            disp.ins.extend(ring_list(in_ring))
        else:
            assert skel.emitter is not None, \
                "a standalone farm needs an emitter (or compose it after a Source)"

        merge = g.add(ProcMergeVertex(
            skel.collector, ordered=skel.ordered, loop_ring=loop_ring,
            loop_board=board, feedback=skel.feedback,
            stats_in=d2m, stats_out=stats_ring, live_board=live))
        merge.path = path
        for i, node in enumerate(skel.worker_nodes):
            idle = sched.worker_channel(i, g.channel)
            # a live monitor consumes the EWMAs too: arm the service
            # rings so the detach-time frame carries real service times
            service = (g.channel(64)
                       if sched.needs_service_stats
                       or getattr(g, "live_telemetry", False) else None)
            if service is not None:
                service_rings.append(service)
            w = g.add(ProcWorkerVertex(node, i, idle_ring=idle,
                                       service_ring=service,
                                       name=f"ff-worker-{i}"))
            w.path = path
            w.cpus = sched.worker_cpus(i, len(skel.worker_nodes))
            g.connect(disp, w, capacity=cap)
            g.connect(w, merge, capacity=cap)
        if terminal:
            merge.outs.append(g.results_ring())
            return None
        ring = g.channel(skel.capacity)
        merge.outs.append(ring)
        return ring

    if isinstance(skel, Stage):
        v = g.add(ProcStageVertex(skel.node, name=skel.name,
                                  batch=g.batch_for(skel.grain)))
        v.path = path
        v.ins.extend(ring_list(in_ring))
        if terminal:
            v.outs.append(g.results_ring())
            return None
        # per-edge capacity: a tuned Stage sizes its own outbound ring
        ring = g.channel(getattr(skel, "capacity", None))
        v.outs.append(ring)
        return ring

    raise TypeError(f"cannot lower {skel!r} to the process graph")


class ProcProgram:
    """Procs lowering: the skeleton wired onto spawned processes over
    shared-memory SPSC rings — ``lower(skel, "procs")``.

    Same ordered-output contract as the other two backends; the win is
    that pure-Python (GIL-holding) ``svc`` functions actually run in
    parallel.  ``timeout`` bounds the whole run: a hung child process is
    terminated (and all shared memory unlinked) instead of wedging the
    caller.  ``fuse`` is the same grain-aware pass as the threads backend
    — with processes costing more per vertex than threads, collapsing
    sub-threshold hand-offs pays off even sooner.

    Data-plane options (see :class:`ProcGraph`): ``zero_copy`` (typed
    buffer-protocol slots, default on), ``batch`` (batched emit: ``None``
    off / int / ``"grain"``), ``pool`` (spawn-pool reuse; ``None`` =
    honour ``REPRO_PROCS_POOL``, default on).  ``trace=`` works as on
    threads: each vertex builds its lane from plain config and ships it
    home over its control ring at EOS.  The reference's ``metrics=`` and
    ``monitor=`` belong to a later slice of the port and raise
    :class:`LoweringError`."""

    backend = "procs"

    def __init__(self, skeleton: Skeleton, *, capacity: int = 512,
                 slot_size: int = 248, timeout: Optional[float] = 120.0,
                 fuse: Any = "auto", fuse_threshold_us: Optional[float] = None,
                 zero_copy: bool = True, batch: Any = None,
                 pool: Optional[bool] = None,
                 trace: Any = False, metrics: Any = False,
                 monitor: Any = None):
        for opt, on in (("metrics", metrics), ("monitor", monitor)):
            if on:
                raise LoweringError(
                    f"{opt}= is the run-report/monitor slice, not yet "
                    f"ported to repro_torch")
        if fuse and isinstance(skeleton, Pipeline):
            force = fuse is True
            thr = fuse_threshold_us
            if not force and thr is None and _has_grained_stage(skeleton):
                from .sched import calibrate_handoff_us
                thr = calibrate_handoff_us()
            skeleton = _fuse_pass(skeleton, threshold_us=thr, force=force)
        self.skeleton = skeleton
        self.capacity = capacity
        self.slot_size = slot_size
        self.timeout = timeout
        self.zero_copy = zero_copy
        self.batch = batch
        self.pool = pool
        self.tracer = _coerce_tracer(trace)
        self.last_trace = None

    def to_graph(self, stream: Optional[Iterable[Any]] = None) -> ProcGraph:
        g = ProcGraph(capacity=self.capacity, slot_size=self.slot_size,
                      zero_copy=self.zero_copy, batch=self.batch,
                      pool=self.pool)
        try:
            # Build the driving Source separately (at path "in") so the
            # user skeleton keeps its root IR paths — telemetry keys
            # vertices by path, and wrapping in a fresh Pipeline would
            # shift every top-level index by one.
            in_ring = None
            if stream is not None:
                in_ring = build(Source(stream), g, None, False, "in")
            build(self.skeleton, g, in_ring, True)
        except BaseException:
            g.shutdown()  # unlink whatever the partial build created
            raise
        if self.tracer is not None:
            g.tracer = self.tracer
        return g

    def __call__(self, items: Iterable[Any]) -> List[Any]:
        xs = list(items)
        if not xs:
            return []  # nothing to stream; skip the spawn entirely
        out = self.to_graph(xs).run_and_wait(self.timeout)
        if self.tracer is not None:
            self.last_trace = self.tracer.trace()
        return out


BACKENDS["procs"] = ProcProgram


class ProcAccelerator:
    """Self-offloading accelerator over processes (TR-10-03, procs twin of
    :class:`graph.Accelerator`): the *caller* is the single producer of
    the inbound ring(s) and the single consumer of the results, so a
    Python main thread can offload pure-Python kernels to a process farm
    and keep computing.

        acc = ProcAccelerator(Farm(f, 4))   # f must be picklable
        for x in tasks: acc.offload(x)
        results = acc.wait()

    For a plain farm — no emitter/collector node, no feedback edge, a
    ``pick()``-based scheduling policy (rr / ondemand / costmodel) — the
    accelerator runs **caller-side arbitration**: the calling thread IS
    the dispatch and merge arbiter (tagging, placement, dedup-free
    collection, reorder-by-tag), so the network is exactly ``nworkers``
    processes and zero polling arbiters.  That is the paper's
    self-offloading design taken literally, and on a small machine it
    matters: every extra polling process is a core-thief.  Skeletons that
    need an arbiter process (compositions, feedback loops, worksteal's
    pump) fall back to the full process graph transparently.

    ``offload`` opportunistically drains results while the target ring is
    full — the caller is part of the network, so it must not create a
    blocking cycle through itself."""

    def __init__(self, net: Any, *, capacity: int = 512,
                 slot_size: int = 248, ready_timeout: float = 60.0,
                 zero_copy: bool = True, pool: Optional[bool] = None):
        skel = as_skeleton(net)
        self._g = ProcGraph(capacity=capacity, slot_size=slot_size,
                            zero_copy=zero_copy, pool=pool)
        self._farm: Optional[Farm] = None
        try:
            if self._caller_side_ok(skel):
                self._build_caller_farm(skel)
            else:
                self._in = self._g.channel()
                build(skel, self._g, self._in, True)
        except BaseException:
            self._g.shutdown()  # unlink whatever the partial build created
            raise
        self._g.run()
        self._g.wait_ready(ready_timeout)
        self._closed = False

    @staticmethod
    def _caller_side_ok(skel: Skeleton) -> bool:
        if not isinstance(skel, Farm):
            return False
        if skel.emitter is not None or skel.collector is not None \
                or skel.feedback is not None or skel.speculative:
            return False
        sched = make_scheduler(skel.scheduling)
        # token-holding policies (custom place/pump, e.g. worksteal) need
        # the dispatch arbiter's pump loop — same test StageVertex uses
        return type(sched).place is Scheduler.place

    def _build_caller_farm(self, skel: Farm) -> None:
        g = self._g
        self._farm = skel
        self._sched = make_scheduler(skel.scheduling)
        self._stats = FarmStats()
        self._in_rings: List[ShmRing] = []
        self._out_rings: List[ShmRing] = []
        self._service_rings: List[ShmRing] = []
        cap = skel.capacity or g.capacity
        for i, node in enumerate(skel.worker_nodes):
            service = (g.channel(64)
                       if self._sched.needs_service_stats else None)
            if service is not None:
                self._service_rings.append(service)
            w = g.add(ProcWorkerVertex(node, i, service_ring=service,
                                       name=f"ff-worker-{i}"))
            w.cpus = self._sched.worker_cpus(i, len(skel.worker_nodes))
            q_in, q_out = g.channel(cap), g.channel(cap)
            w.ins.append(q_in)
            w.outs.append(q_out)
            self._in_rings.append(q_in)
            self._out_rings.append(q_out)
        self._sched.bind(self._in_rings, self._stats)
        self._next_tag = 0
        self._reorder: Dict[int, Any] = {}
        self._next_out = 0
        self._worker_eos = 0
        self._drain_backoff = _Backoff()

    # -- caller-side merge ---------------------------------------------------
    def _collect(self, payload: Any) -> None:
        if payload is GO_ON:
            return  # the merge arbiter would have retired it silently
        if isinstance(payload, _FarmEmitMany):
            self._g.results.extend(payload)
            return
        self._g.results.append(payload)

    def _drain(self) -> bool:
        """One pass over the worker output (and service) rings; returns
        True if anything moved.  This IS MergeVertex._loop, inlined into
        the caller."""
        moved = False
        for ring in self._service_rings:
            while True:
                upd = ring.pop()
                if upd is _EMPTY:
                    break
                self._sched.observe_service(upd[0], upd[1])
        st = self._stats
        for i, q in enumerate(self._out_rings):
            for _ in range(_BATCH):
                tok = q.pop()
                if tok is _EMPTY:
                    break
                moved = True
                if tok is EOS:
                    self._worker_eos += 1
                    break
                if isinstance(tok, _WorkerStats):
                    if tok.ewma is not None:
                        st.service_ewma[tok.index] = tok.ewma
                    continue
                tag, issued, payload = tok
                st.tasks_collected += 1
                st.per_worker[i] = st.per_worker.get(i, 0) + 1
                if issued:
                    st.latencies.append(time.monotonic() - issued)
                if self._farm.ordered:
                    self._reorder[tag] = payload
                    while self._next_out in self._reorder:
                        self._collect(self._reorder.pop(self._next_out))
                        self._next_out += 1
                else:
                    self._collect(payload)
        return moved

    def _caller_done(self) -> bool:
        self._drain()
        return self._worker_eos >= len(self._out_rings)

    def _network_dead(self) -> bool:
        """A vertex raised (failure Event) or silently died (liveness
        probe): the caller's push loops must stop blocking on rings no
        process will ever drain."""
        if self._g.failed_event.is_set():
            return True
        self._g._check_liveness()
        return bool(self._g.failed)

    # -- public surface ------------------------------------------------------
    @property
    def results(self) -> List[Any]:
        return self._g.results

    def offload(self, task: Any) -> None:
        assert not self._closed, "accelerator already EOS'd"
        if self._farm is None:
            spins = 0
            while not self._in.push(task):
                self._g.poll_results()
                if self._network_dead():
                    self._g.wait(timeout=5.0)  # raises the vertex error
                    raise RuntimeError("accelerator network failed")
                spins += 1
                if spins > 64:
                    time.sleep(_POLL)
            return
        tag = self._next_tag
        issued = time.monotonic() if tag & _LAT_SAMPLE == 0 else 0.0
        tok = (tag, issued, task)
        self._next_tag += 1
        ring = self._in_rings[self._sched.pick()]
        while not ring.push(tok):
            if self._drain():
                self._drain_backoff.reset()
                continue
            if self._network_dead():
                self._g._wait_until(self._caller_done, 5.0)  # raises
                raise RuntimeError("accelerator network failed")
            self._drain_backoff.idle()
        self._stats.tasks_emitted += 1

    def eos(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._farm is None:
            spins = 0
            while not self._in.push(EOS):
                self._g.poll_results()
                if self._network_dead():
                    return  # wait() will surface the vertex error
                spins += 1
                if spins > 64:
                    time.sleep(_POLL)
            return
        for q in self._in_rings:
            # keep draining while pushing: a full out-ring must not wedge
            # the caller against a full in-ring (the caller is both
            # arbiters — it cannot block on itself).  A dead vertex never
            # drains its ring: bail and let wait() raise its error.
            while not q.push(EOS):
                if self._drain():
                    self._drain_backoff.reset()
                    continue
                if self._network_dead():
                    return
                self._drain_backoff.idle()

    def wait(self, timeout: Optional[float] = None) -> List[Any]:
        self.eos()
        if self._farm is None:
            return self._g.wait(timeout)
        try:
            return self._g._wait_until(self._caller_done, timeout)
        finally:
            # flush reorder residue + surface the merged FarmStats onto
            # the IR node, as the graph path's stats ring would have
            for t in sorted(self._reorder):
                self._collect(self._reorder.pop(t))
            _fold_stats(self._farm.stats, self._stats)
