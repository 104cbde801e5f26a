"""Pluggable scheduling policies for the threads backend.

The paper's headline numbers on fine-grain streams (Sec. 6: 35-226% over
OpenMP/Cilk/TBB on Smith-Waterman) come from two knobs working together:
cheap lock-free hand-offs *and* smart task placement.  The hand-offs live
in ``spsc.py``; this module is the placement knob, extracted out of the
dispatch arbiter (``graph.DispatchVertex``) into a policy hierarchy so
``lower(skel, "threads", ...)`` / ``Farm(scheduling=...)`` can pick — or a
user can subclass — without touching the runtime:

``RoundRobin``    the paper's default emitter policy (Fig. 1-2);
``OnDemand``      FastFlow's on-demand mode: shortest worker ring wins
                  (reading ``len()`` of a peer SPSC ring from the arbiter
                  thread is heuristically stale but safe);
``WorkStealing``  idle workers steal from the deepest peer backlog via a
                  steal side-channel.  SPSC discipline makes literal
                  ring-revocation impossible (one consumer per ring), so
                  the policy keeps each worker ring shallow (``ring_fill``)
                  and holds the depth in arbiter-side per-worker backlogs;
                  an idle worker posts its index on its idle ring (SPSC,
                  worker → arbiter) and the arbiter migrates the oldest
                  task from the deepest backlog to the thief.  Tags ride
                  the tokens untouched, so tagged-token ordering and
                  straggler re-issue interact correctly with steals (the
                  merge arbiter reorders/dedups by tag no matter which
                  worker serviced the token).
``CostModel``     adaptive placement fed by the per-worker service-time
                  EWMA that ``FarmStats`` collects: a task goes to the
                  worker with the least expected completion time,
                  ``(queued + 1) × ewma_service``, so a worker pinned by a
                  slow task (e.g. a long decode sequence in the serving
                  farm) stops accumulating queue behind it.

Policies are per-build mutable state: :func:`make_scheduler` always
returns a **fresh** instance (``Scheduler.fresh``), so one ``Farm`` IR
node — pure data — can be lowered or run many times without policies
leaking counters between graphs.

This module also owns the fusion threshold calibration
(:func:`calibrate_handoff_us`): the same measurement
``benchmarks/skeleton_parity.py`` reports (per-item hand-off cost vs the
fused lowering), in-library and cached, so ``lower(..., fuse="auto")`` can
calibrate itself.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from .spsc import SPSCQueue

__all__ = [
    "Scheduler", "RoundRobin", "OnDemand", "WorkStealing", "CostModel",
    "KeyAffinity", "BudgetBackpressure",
    "SCHEDULERS", "make_scheduler", "calibrate_handoff_us",
    "clear_handoff_cache", "spread_cpus",
]

_EMPTY = SPSCQueue._EMPTY


def spread_cpus(index: int, nworkers: int) -> Optional[Tuple[int, ...]]:
    """Partition the process's allowed CPUs round-robin over ``nworkers``
    and return worker ``index``'s share (``None`` where the platform has
    no affinity API).  With more workers than CPUs the shares wrap, so
    every worker still gets a non-empty set."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover - non-Linux
        return None
    if not cpus or nworkers <= 0:  # pragma: no cover - defensive
        return None
    share = tuple(cpus[index % len(cpus)::nworkers]) if nworkers <= len(cpus) \
        else (cpus[index % len(cpus)],)
    return share or (cpus[index % len(cpus)],)


class Scheduler:
    """Base class: decides which worker ring each task token lands on.

    Lifecycle (all calls happen in the dispatch arbiter's thread, which is
    what keeps the single-writer SPSC discipline intact):

    * ``worker_channel(i, channel)`` — at graph-build time, once per
      worker: return an SPSC side-channel (worker → arbiter) or ``None``;
    * ``bind(outs, stats)`` — at arbiter start, with the worker rings and
      the farm's :class:`~repro_torch.core.skeleton.FarmStats`;
    * ``place(tok, emit)`` — one token: default is ``emit(pick(), tok)``
      (a blocking push that keeps the wrap-around ring drained);
    * ``pump()`` — called every arbiter iteration: flush any policy-held
      backlog, service steal requests; returns True on progress;
    * ``pending()`` — tokens still held inside the policy (the arbiter
      refuses to EOS until this reaches zero).
    """

    name = "scheduler"
    # set True by policies that read FarmStats.service_ewma: workers only
    # pay the per-task timing when some policy actually consumes it
    needs_service_stats = False
    # policies that hold tokens (pending() > 0) set this in bind(): the
    # dispatch arbiter blocks new intake while pending() exceeds it, so a
    # policy backlog cannot buffer an unbounded stream (ring-capacity
    # backpressure, re-established one level up)
    high_water: Optional[int] = None
    # opt-in placement hint: when True, ``worker_cpus`` spreads the farm's
    # workers over the allowed CPUs and the procs backend pins each worker
    # process (best-effort ``sched_setaffinity``; the spawn pool undoes
    # the pin when it re-arms a process for the next graph)
    pin_cpus = False

    def __init__(self) -> None:
        self.outs: List[Any] = []
        self.stats: Any = None
        self._rr = 0

    def fresh(self) -> "Scheduler":
        """A new instance with the same configuration, no shared state."""
        return type(self)()

    def worker_channel(self, index: int, channel: Callable[[int], Any]):
        return None

    def worker_cpus(self, index: int,
                    nworkers: int) -> Optional[Tuple[int, ...]]:
        """Placement hint: CPUs worker ``index`` should be pinned to, or
        ``None`` for no pin.  Consumed at build time by the procs backend
        (``ProcVertex.cpus``); the threads backend ignores it (one
        process, the OS balances threads)."""
        if not self.pin_cpus:
            return None
        return spread_cpus(index, nworkers)

    def bind(self, outs: List[Any], stats: Any) -> None:
        self.outs = outs
        self.stats = stats

    def pick(self) -> int:
        raise NotImplementedError

    def route(self, payload: Any) -> Optional[int]:
        """Payload-dependent routing hook for single-token fan-out (Stage
        routes, the all-to-all scatter): return a worker index computed
        *from the payload*, or ``None`` (the default) to defer to
        ``pick()``.  Unlike ``place``, a policy implementing ``route``
        never holds tokens, so it stays usable wherever only pick()-based
        policies are allowed."""
        return None

    def place(self, tok: Any, emit: Callable[[int, Any], None]) -> None:
        emit(self.pick(), tok)

    def pump(self) -> bool:
        return False

    def pending(self) -> int:
        return 0

    def observe_service(self, index: int, ewma: float) -> None:
        """Fold one worker's service-time EWMA into the policy's stats.

        On the threads backend workers write ``FarmStats.service_ewma``
        directly (single writer per key).  The procs backend has no shared
        ``FarmStats`` object, so workers stream their EWMA over a
        worker→arbiter SPSC ring and the dispatch arbiter feeds it in
        here — arbiter-side state stays in the arbiter's process, and
        policies like :class:`CostModel` read the same dict either way."""
        if self.stats is not None:
            self.stats.service_ewma[index] = ewma


class RoundRobin(Scheduler):
    """The paper's default emitter policy: worker ``i mod N`` (Fig. 1-2)."""

    name = "rr"

    def pick(self) -> int:
        w = self._rr % len(self.outs)
        self._rr += 1
        return w


class OnDemand(Scheduler):
    """FastFlow's on-demand mode: shortest worker ring wins.  Reading a
    peer ring's ``len()`` from the arbiter thread is heuristically stale
    but safe (the consumer can only shrink it)."""

    name = "ondemand"

    def pick(self) -> int:
        return min(range(len(self.outs)), key=lambda w: len(self.outs[w]))


class WorkStealing(Scheduler):
    """Arbiter-mediated work stealing over the steal side-channel.

    Placement is round-robin into per-worker **backlogs** held by the
    arbiter; each worker ring is kept at most ``ring_fill`` deep, so queue
    depth stays where it can still be re-balanced (a token already pushed
    onto an SPSC ring has exactly one legal consumer and cannot be
    revoked).  An idle worker posts its index on its idle ring; ``pump``
    answers by migrating the *oldest* task from the *deepest* backlog to
    the thief — oldest-first keeps the ordered farm's reorder buffer
    shallow, deepest-victim is the classic steal heuristic.  Straggler
    re-issue duplicates bypass the backlog (``pick`` = shortest ring) and
    the merge arbiter dedups by tag, exactly as with the other policies.
    A dead-but-survivable worker's backlog is rescued the same way: the
    moment any live worker goes idle it steals the corpse's queue.
    """

    name = "worksteal"

    def __init__(self, ring_fill: int = 8, idle_capacity: int = 8) -> None:
        super().__init__()
        self.ring_fill = ring_fill
        self.idle_capacity = idle_capacity
        self.idle_rings: List[Any] = []
        self.backlogs: List[deque] = []

    def fresh(self) -> "WorkStealing":
        return WorkStealing(self.ring_fill, self.idle_capacity)

    def worker_channel(self, index: int, channel: Callable[[int], Any]):
        ring = channel(self.idle_capacity)
        self.idle_rings.append(ring)
        return ring

    def bind(self, outs: List[Any], stats: Any) -> None:
        super().bind(outs, stats)
        self.backlogs = [deque() for _ in outs]
        # total backlog the arbiter may hold before it stops taking input:
        # a few refill windows per worker, so stealing has depth to work
        # with but an unbounded stream cannot buffer in memory
        self.high_water = max(64, 8 * self.ring_fill * len(outs))

    def pick(self) -> int:  # duplicates from straggler re-issue only
        return min(range(len(self.outs)), key=lambda w: len(self.outs[w]))

    def place(self, tok: Any, emit: Callable[[int, Any], None]) -> None:
        # O(1) hot path: append to the round-robin backlog and top up that
        # ring only; steal servicing runs in the arbiter's per-iteration
        # pump(), not per token
        w = self._rr % len(self.outs)
        self._rr += 1
        bl = self.backlogs[w]
        bl.append(tok)
        out = self.outs[w]
        while bl and len(out) < self.ring_fill and out.push(bl[0]):
            bl.popleft()

    def pending(self) -> int:
        return sum(len(b) for b in self.backlogs)

    def pump(self) -> bool:
        progress = False
        outs, backlogs = self.outs, self.backlogs
        # 1. keep every ring primed up to ring_fill from its own backlog
        for w, bl in enumerate(backlogs):
            while bl and len(outs[w]) < self.ring_fill and outs[w].push(bl[0]):
                bl.popleft()
                progress = True
        # 2. answer steal requests: the thief batch-refills from the
        #    deepest peer backlogs, oldest task first (signals are
        #    advisory — a stale one is dropped).  Batching matters: the
        #    arbiter only gets scheduled every so often (GIL quantum), so
        #    one-task steals would cap the whole farm at the arbiter's
        #    wake-up rate.
        for ring in self.idle_rings:
            while True:
                w = ring.pop()
                if w is _EMPTY:
                    break
                if backlogs[w] or not outs[w].empty():
                    continue  # got work since signalling
                while len(outs[w]) < self.ring_fill:
                    victim = max(range(len(backlogs)),
                                 key=lambda v: len(backlogs[v]))
                    if victim == w or not backlogs[victim]:
                        break
                    tok = backlogs[victim].popleft()
                    if outs[w].push(tok):
                        progress = True
                        if self.stats is not None:
                            self.stats.steals += 1
                    else:
                        backlogs[w].appendleft(tok)
                        break
        return progress


class CostModel(Scheduler):
    """Adaptive placement off the per-worker service-time EWMA in
    ``FarmStats`` (each worker writes only its own key — single-writer).

    Expected completion on worker ``w`` is ``(len(ring_w) + 1) × ewma_w``:
    the new task waits behind the queue, then pays that worker's observed
    service time.  Until a worker has a sample it is costed at the mean of
    the known workers (with no samples at all this degrades to shortest
    queue).  Ties rotate round-robin so an idle farm doesn't pile onto
    worker 0."""

    name = "costmodel"
    needs_service_stats = True

    def pick(self) -> int:
        outs = self.outs
        n = len(outs)
        ewma: Dict[int, float] = (self.stats.service_ewma
                                  if self.stats is not None else {})
        if not ewma:
            return min(range(n), key=lambda w: len(outs[w]))
        default = sum(ewma.values()) / len(ewma)
        start = self._rr % n
        self._rr += 1
        return min(range(n),
                   key=lambda w: ((len(outs[w]) + 1) * ewma.get(w, default),
                                  (w - start) % n))


class KeyAffinity(Scheduler):
    """Key-affinity placement — the all-to-all routing rule as a farm
    policy: tasks whose keys are equal always land on the *same* worker
    (``stable_hash(by(payload)) % nworkers``, the deterministic hash every
    keyed shuffle uses on its left→right edge matrix).  This is the policy
    surface a plain ``Farm`` needs to host per-key state — stateful fold
    workers, per-key caches, sticky sessions — without building a full
    shuffle network.

    ``by`` extracts the key from the payload (default: the payload itself)
    and must be picklable for the procs backend (module-level function).
    Placement is payload-dependent: the policy implements ``route`` (so
    ``Stage`` fan-out and the all-to-all scatter can use it — it never
    holds tokens) and ``place`` on top of it for the farm arbiters; only
    the caller-side ``ProcAccelerator`` fast path falls back to the full
    arbiter graph.  ``pick`` (used only by straggler re-issue duplicates)
    degrades to shortest-ring — a duplicate may run off-key, which is
    safe: affinity is a placement preference, and the merge arbiter
    dedups by tag regardless of who serviced it.  Speculation plus
    *stateful* per-key workers is the caller's contract to avoid, exactly
    as with ``WorkStealing``."""

    name = "keyaffinity"

    def __init__(self, by: Optional[Callable[[Any], Any]] = None) -> None:
        super().__init__()
        self.by = by
        # bound once, off the per-item path (import is safe here: sched is
        # fully loaded before any policy can be instantiated)
        from .a2a import stable_hash
        self._hash = stable_hash

    def fresh(self) -> "KeyAffinity":
        return KeyAffinity(self.by)

    def pick(self) -> int:  # duplicates from straggler re-issue only
        return min(range(len(self.outs)), key=lambda w: len(self.outs[w]))

    def route(self, payload: Any) -> int:
        key = payload if self.by is None else self.by(payload)
        return self._hash(key) % len(self.outs)

    def place(self, tok: Any, emit: Callable[[int, Any], None]) -> None:
        # tok is graph.Token (threads), a (tag, issued, payload) tuple
        # (procs wire format), or a raw payload (caller-side arbitration)
        payload = tok.payload if hasattr(tok, "payload") else (
            tok[2] if isinstance(tok, tuple) and len(tok) == 3 else tok)
        emit(self.route(payload), tok)


class BudgetBackpressure(RoundRobin):
    """Bounded-memory intake throttle for keyed reductions — the scatter
    policy a budgeted ``reduce_by_key`` installs by default.

    The policy holds the reduction's :class:`~repro_torch.core.oocore.
    MemoryBudget`; before each placement it checks whether the hot fold
    state across all partitions is over the *global* budget
    (``limit × nparts``) and, if so, counts one backpressure stall and
    briefly stops taking input (bounded wait, so a wedged reduction can
    never deadlock the scatter — the partitions relieve pressure by
    draining their inbound rings, spilling as they fold, which drops
    their held bytes below the line).  While the scatter stalls, its
    inbound ring fills and ring-capacity backpressure propagates
    upstream — the usual FastFlow mechanism, now driven by a byte budget
    instead of slot counts.

    The wait has hysteresis: partitions spill *on ingest*, so once their
    rings are drained the held bytes cannot fall further without new
    input — a stall that times out still over the line would then repeat
    for every placement while the partitions hover in the over-high-water
    band (each costing the full bounded wait: a ~1000× slowdown, not
    backpressure).  After a timed-out stall the policy places freely and
    re-arms only when the aggregate first dips back below the line, so
    one stall is paid per spill cycle instead of one per item.

    Works identically on both host backends: on threads the budget's
    counters are plain shared-object state; on procs the scatter process
    reads the same :class:`~repro_torch.core.shm.ShmCounters` board the
    partition processes write (single writer per counter, any reader).
    Placement itself is round-robin over the left row.  Constructed
    bare (registry name ``"budget"``) it has no budget and degrades to
    plain round-robin."""

    name = "budget"

    def __init__(self, budget: Any = None, *,
                 max_stall_s: float = 0.02) -> None:
        super().__init__()
        self.budget = budget
        self.max_stall_s = max_stall_s
        self._exhausted = False  # last stall timed out still over the line

    def fresh(self) -> "BudgetBackpressure":
        # the budget is configuration, not run state: clones keep it (its
        # counters are cumulative across runs by design)
        return BudgetBackpressure(self.budget, max_stall_s=self.max_stall_s)

    def pick(self) -> int:
        b = self.budget
        if b is not None:
            over = b.over_total()
            if not over:
                self._exhausted = False  # below the line again: re-arm
            elif not self._exhausted:
                b.stalled()
                deadline = time.monotonic() + self.max_stall_s
                while b.over_total() and time.monotonic() < deadline:
                    time.sleep(0.0005)
                self._exhausted = b.over_total()
        return super().pick()


SCHEDULERS: Dict[str, Type[Scheduler]] = {
    "rr": RoundRobin,
    "ondemand": OnDemand,
    "worksteal": WorkStealing,
    "costmodel": CostModel,
    "keyaffinity": KeyAffinity,
    "budget": BudgetBackpressure,
}


def make_scheduler(spec: Any) -> Scheduler:
    """Resolve a scheduling spec — a registry name, a policy class, or a
    policy instance (cloned via ``fresh()`` so IR nodes stay pure data) —
    into a fresh :class:`Scheduler`.  Raises :class:`ValueError` on an
    unknown spec, which is also how ``Farm(scheduling=...)`` validates."""
    if isinstance(spec, Scheduler):
        return spec.fresh()
    if isinstance(spec, type) and issubclass(spec, Scheduler):
        return spec()
    if isinstance(spec, str):
        try:
            return SCHEDULERS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown scheduling policy {spec!r} "
                f"(have {sorted(SCHEDULERS)}, or pass a Scheduler)") from None
    raise ValueError(
        f"scheduling must be a policy name, Scheduler subclass or instance, "
        f"got {spec!r}")


# ---------------------------------------------------------------------------
# fusion-threshold calibration (the skeleton_parity measurement, in-library)
# ---------------------------------------------------------------------------
_HANDOFF_CACHE: Optional[float] = None


def clear_handoff_cache() -> None:
    """Drop the process-wide hand-off calibration so the next
    ``calibrate_handoff_us()`` re-measures.  Autotune pilots and tests
    call this when the cached value may describe a different load regime
    (e.g. a measurement taken while an earlier benchmark saturated the
    cores)."""
    global _HANDOFF_CACHE
    _HANDOFF_CACHE = None


def calibrate_handoff_us(ntasks: int = 2000, repeats: int = 2,
                         force: bool = False, *,
                         recalibrate: bool = False) -> float:
    """Measured per-item cost (µs) of ONE vertex hand-off on this machine:
    the same stream through ``Pipeline(Stage(a), Stage(b))`` (one SPSC
    hand-off) vs the pre-fused single ``Stage(b∘a)``, best of ``repeats``
    — the measurement ``benchmarks/skeleton_parity.py`` makes against the
    mesh backend, reused as the auto threshold for ``fuse(skel)``: a stage
    declaring ``grain=`` below this is cheaper to fuse than to stream.
    Cached per process; ``force=True`` / ``recalibrate=True`` re-measure
    (and refresh the cache), ``clear_handoff_cache()`` just invalidates."""
    global _HANDOFF_CACHE
    if _HANDOFF_CACHE is not None and not (force or recalibrate):
        return _HANDOFF_CACHE
    from .skeleton import Pipeline, Stage, lower

    def _a(x):
        return x + 1

    def _b(x):
        return x * 2

    def _ab(x):
        return (x + 1) * 2

    xs = list(range(ntasks))
    want = [_ab(x) for x in xs]
    split = lower(Pipeline(Stage(_a), Stage(_b)), "threads", fuse=False)
    whole = lower(Stage(_ab), "threads", fuse=False)

    def best(prog):
        dts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = prog(xs)
            dts.append(time.perf_counter() - t0)
            assert out == want, "calibration program output mismatch"
        return min(dts)

    _HANDOFF_CACHE = max((best(split) - best(whole)) / ntasks * 1e6, 0.05)
    return _HANDOFF_CACHE
