"""Profile-guided re-lowering — the self-tuning half of the runtime.

The port's copy of ``repro.core.autotune``; its mesh planner counts the
port's devices (torch's CUDA cards) instead of the reference's.

The static knobs (`grain=`, ring `capacity=`, the fusion threshold) are
all declared at `lower()` time, and the porting literature around the
source paper shows exactly how they fail: a grain mis-declared by 100×
turns the farm speedup curve flat.  This module closes the loop the
ROADMAP calls "profile, re-lower, repeat":

1. **Profile** — :func:`profile` runs a bounded *pilot* slice of the
   stream through an instrumented threads lowering of the skeleton and
   records, per IR position: the measured per-item service time (mean +
   EWMA, the same 0.8/0.2 smoothing `FarmStats.service_ewma` uses),
   the outbound-queue high-water mark (sampled by the caller through
   :meth:`~repro_torch.core.graph.Graph.sample_high_water`), and the machine's
   calibrated per-hand-off cost (:func:`~repro_torch.core.sched.
   calibrate_handoff_us`).  The result is a JSON-serializable
   :class:`Profile` that can be saved, diffed, and replayed.

2. **Retune** — :func:`retune` is a *pure IR rewrite*: it re-declares
   each stage's ``grain=`` as its measured service time, re-runs
   :func:`~repro_torch.core.skeleton.fuse` with the measured hand-off cost as
   the threshold (which now also merges ``Farm∘Farm`` pairs and absorbs
   stateless post-shuffle stages into a2a right rows), sizes each
   Stage/Source outbound ring from the producer/consumer service-rate
   ratio (:func:`ring_capacity`), and micro-batches the survivors whose
   hand-off cost still dominates (:func:`auto_batch`, riding the
   existing :class:`~repro_torch.core.skeleton.KeyBatch` wire format).  The
   rewrite never changes results — that is pinned by three-backend
   parity tests.

3. **Replay** — ``lower(skel, backend, tune=True)`` wraps both phases
   in a :class:`TunedProgram`: the first call profiles a pilot slice,
   retunes, and runs the remainder through the tuned program; later
   calls go straight to the tuned program.  ``profile=`` (a
   :class:`Profile` or a path) skips the pilot entirely.

The mesh backend is different in kind: its ``grain`` is a microbatch
*row count* and its tuning axis is the ``(stage, worker)`` mesh
factorization, so :func:`retune` leaves the IR alone and
:func:`plan_mesh` instead derives program options from the bubble model
(:func:`~repro_torch.core.dpipeline.best_factorization` /
``pipeline_utilisation``).

Plain Python, like the rest of ``repro_torch.core``: a spawned vertex
pays no torch import.  :func:`plan_mesh` imports torch (through
:mod:`.dfarm`), lazily, only to count the cards when it is not told the
device count.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterable, List, Optional

from .skeleton import (GO_ON, AllToAll, EmitMany, Farm, Feedback, FnNode,
                       FusedNode, KeyBatch, Pipeline, Skeleton, Source, Stage,
                       _stateless, as_skeleton, ff_node, fuse, lower)

__all__ = ["Profile", "StageProfile", "profile", "retune", "plan_mesh",
           "auto_batch", "ring_capacity", "TunedProgram", "DEFAULT_PILOT"]

DEFAULT_PILOT = 512          # pilot slice length when tune=True gives none
_EWMA_OLD, _EWMA_NEW = 0.8, 0.2   # FarmStats.service_ewma's smoothing


# ---------------------------------------------------------------------------
# the profile: measured signals, serializable
# ---------------------------------------------------------------------------
@dataclass
class StageProfile:
    """Measured signals for one IR position.

    ``path`` is the position in the (flattened) top-level pipeline:
    ``"1"`` is stage index 1, ``"2.left"``/``"2.right"`` are an
    all-to-all's rows.  ``width`` is the row's parallel width (a farm's
    ``nworkers``), so a consumer's *effective* per-item service rate is
    ``service_us / width``.  ``queue_high_water`` is the deepest the
    position's outbound ring got during the pilot (0 when the tap cannot
    see it — farm-internal rings are not sampled)."""

    path: str
    kind: str                      # stage|source|farm|feedback|a2a-left|...
    name: str
    service_us: float              # mean per-item service time
    service_ewma_us: float         # EWMA, same smoothing as FarmStats
    items: int                     # items measured (0 = no signal)
    width: int = 1
    queue_high_water: int = 0


@dataclass
class Profile:
    """A pilot run's measurements, ready to re-lower from (or save)."""

    handoff_us: float              # calibrated per-hand-off cost
    pilot_items: int               # stream slice length that was measured
    stages: List[StageProfile] = field(default_factory=list)
    schema: str = "autotune-profile/1"

    def stage(self, path: str) -> Optional[StageProfile]:
        for sp in self.stages:
            if sp.path == path:
                return sp
        return None

    # -- serialization -------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"schema": self.schema, "handoff_us": self.handoff_us,
                "pilot_items": self.pilot_items,
                "stages": [asdict(sp) for sp in self.stages]}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Profile":
        if d.get("schema") != "autotune-profile/1":
            raise ValueError(f"not an autotune profile: {d.get('schema')!r}")
        return cls(handoff_us=float(d["handoff_us"]),
                   pilot_items=int(d["pilot_items"]),
                   stages=[StageProfile(**sp) for sp in d["stages"]])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Profile":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def diff(self, other: "Profile") -> Dict[str, Dict[str, Any]]:
        """Per-position deltas vs another profile of the same skeleton —
        what changed between two pilot runs (drifted service times,
        deeper queues).  Positions missing on either side are reported
        with ``None`` on that side."""
        mine = {sp.path: sp for sp in self.stages}
        theirs = {sp.path: sp for sp in other.stages}
        out: Dict[str, Dict[str, Any]] = {}
        for p in sorted(set(mine) | set(theirs)):
            a, b = mine.get(p), theirs.get(p)
            out[p] = {
                "service_us": ((a.service_us if a else None),
                               (b.service_us if b else None)),
                "queue_high_water": ((a.queue_high_water if a else None),
                                     (b.queue_high_water if b else None)),
            }
        return out


# ---------------------------------------------------------------------------
# instrumentation: a structural copy with timed nodes
# ---------------------------------------------------------------------------
class _StageAcc:
    """Service-time accumulator shared by one IR position's wrappers.

    Counter updates are plain ``+=`` — a farm row's workers share one
    accumulator, so concurrent updates can race and drop an increment.
    That is deliberate: a lock on the nanosecond path would distort the
    very quantity being measured, and a profile tolerates ~1% undercount
    where it would not tolerate +100ns per item."""

    __slots__ = ("count", "total", "ewma")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.ewma: Optional[float] = None

    def add(self, dt_us: float) -> None:
        self.count += 1
        self.total += dt_us
        self.ewma = (dt_us if self.ewma is None
                     else _EWMA_OLD * self.ewma + _EWMA_NEW * dt_us)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class _TimedNode(ff_node):
    """Transparent timing wrapper: forwards the whole ``ff_node`` protocol
    to ``inner`` and records each ``svc`` call's duration into ``acc``.
    The inner node instance is shared with the original skeleton, so any
    state it builds during the pilot (and flushes at EOS) behaves exactly
    as an untimed run's would."""

    def __init__(self, inner: ff_node, acc: _StageAcc):
        self.inner = inner
        self.acc = acc
        # duck-typed markers the builders probe with getattr — a wrapper
        # must not hide them (batch-aware folds, budget boards)
        self.accepts_batches = getattr(inner, "accepts_batches", False)
        self.budget = getattr(inner, "budget", None)

    def svc_init(self) -> None:
        self.inner.svc_init()

    def svc_end(self) -> None:
        self.inner.svc_end()

    def svc(self, task: Any) -> Any:
        t0 = time.perf_counter()
        r = self.inner.svc(task)
        self.acc.add((time.perf_counter() - t0) * 1e6)
        return r

    def svc_eos(self) -> Any:
        return self.inner.svc_eos()


def _wrap_row(nodes: List[ff_node], acc: _StageAcc) -> List[ff_node]:
    """Wrap a farm/a2a row, one wrapper per slot (each runs in exactly
    one vertex thread).  Nodes carrying builder-probed markers that a
    wrapper cannot fully reproduce cross-process are left untimed."""
    out: List[ff_node] = []
    for n in nodes:
        if getattr(n, "accepts_batches", False) \
                or getattr(n, "budget", None) is not None:
            out.append(n)          # e.g. SpillFold: leave the real node
        else:
            out.append(_TimedNode(n, acc))
    return out


def _instrument(skel: Skeleton, accs: Dict[str, Any]):
    """Structural copy of ``skel`` with per-position timing.  ``accs``
    maps path -> (kind, name, width, acc)."""
    stages = skel.stages if isinstance(skel, Pipeline) else [skel]
    out: List[Skeleton] = []
    for i, s in enumerate(stages):
        p = str(i)
        if isinstance(s, Source):
            acc = _StageAcc()
            accs[p] = ("source", s.name, 1, acc)
            out.append(Source(_TimedNode(s.node, acc), name=s.name,
                              grain=s.grain, capacity=s.capacity))
        elif isinstance(s, Stage):
            acc = _StageAcc()
            accs[p] = ("stage", s.name, 1, acc)
            out.append(Stage(_TimedNode(s.node, acc), name=s.name,
                             grain=s.grain, capacity=s.capacity))
        elif isinstance(s, Farm):
            acc = _StageAcc()
            accs[p] = ("farm", "ff-farm", s.nworkers, acc)
            out.append(Farm(
                _wrap_row(s.worker_nodes, acc), s.nworkers,
                emitter=s.emitter, collector=s.collector, ordered=s.ordered,
                grain=s.grain, scheduling=s.scheduling,
                speculative=s.speculative,
                straggler_factor=s.straggler_factor,
                min_straggler_age=s.min_straggler_age, feedback=s.feedback,
                feedback_capacity=s.feedback_capacity,
                queue_class=s.queue_class, capacity=s.capacity))
        elif isinstance(s, AllToAll):
            la, ra = _StageAcc(), _StageAcc()
            accs[f"{p}.left"] = ("a2a-left", s.name, s.nleft, la)
            accs[f"{p}.right"] = ("a2a-right", s.name, s.nright, ra)
            out.append(AllToAll(
                _wrap_row(s.left_nodes, la), _wrap_row(s.right_nodes, ra),
                by=s.by, nleft=s.nleft, nright=s.nright, ordered=s.ordered,
                scheduling=s.scheduling, reduce=s.reduce, grain=s.grain,
                name=s.name, queue_class=s.queue_class,
                capacity=s.capacity))
        elif isinstance(s, Feedback):
            acc = _StageAcc()
            accs[p] = ("feedback", s.name, s.nworkers, acc)
            out.append(Feedback(_TimedNode(s.node, acc), s.loop_while,
                                nworkers=s.nworkers, max_trips=s.max_trips,
                                scheduling=s.scheduling, grain=s.grain,
                                name=s.name))
        else:
            out.append(s)          # unknown composite: run untimed
    return Pipeline(*out) if len(out) > 1 else out[0]


def _profiled_run(skel: Skeleton, xs: List[Any], *,
                  recalibrate: bool = False):
    """Run ``xs`` through an instrumented threads lowering; return
    ``(Profile, outputs)``.  The caller thread samples queue depths
    while the pilot drains (the profile tap)."""
    from .sched import calibrate_handoff_us
    handoff = calibrate_handoff_us(recalibrate=recalibrate)
    accs: Dict[str, Any] = {}
    instr = _instrument(skel, accs)
    g = lower(instr, "threads", fuse=False).to_graph(list(xs))
    hw: Dict[str, int] = {}
    # the drain sampler runs once inside wait(), after the vertex threads
    # join but before teardown — a pilot short enough to finish before the
    # first poll below still lands every edge key exactly once
    g.drain_samplers.append(lambda: g.sample_high_water(hw))
    g.run()
    while any(t.is_alive() for t in g._threads):
        g.sample_high_water(hw)
        time.sleep(0.0002)
    out = g.wait()
    stages = []
    for path in sorted(accs, key=lambda p: [int(x) if x.isdigit() else x
                                            for x in p.split(".")]):
        kind, name, width, acc = accs[path]
        stages.append(StageProfile(
            path=path, kind=kind, name=name, service_us=acc.mean(),
            service_ewma_us=acc.ewma or 0.0, items=acc.count, width=width,
            queue_high_water=hw.get(f"{name}@{path}", 0)))
    return Profile(handoff_us=handoff, pilot_items=len(xs),
                   stages=stages), out


def profile(skel: Any, items: Iterable[Any], *,
            recalibrate: bool = False) -> Profile:
    """Measure ``skel`` on a pilot stream: per-position service times,
    queue high-water marks, and the machine's hand-off cost.  Runs on
    the threads backend (in-process, no spawn cost) — service times are
    a property of the node functions, so the same profile retunes the
    procs lowering too.  ``recalibrate=True`` re-measures the hand-off
    cost instead of trusting the process-wide cache."""
    prof, _ = _profiled_run(as_skeleton(skel), list(items),
                            recalibrate=recalibrate)
    return prof


# ---------------------------------------------------------------------------
# the tuning models
# ---------------------------------------------------------------------------
def auto_batch(service_us: float, handoff_us: float, *,
               frac: float = 0.10, cap: int = 256) -> int:
    """Auto-grain: the emit-batch size that amortizes the per-item
    hand-off cost below ``frac`` (~10%) of the measured service time.
    1 means the hand-off is already cheap enough to pay per item."""
    svc = max(service_us, 0.05)
    if handoff_us <= frac * svc:
        return 1
    return min(cap, max(2, math.ceil(handoff_us / (frac * svc))))


def ring_capacity(prod_us: float, cons_us: float, high_water: int = 0, *,
                  base: int = 64, lo: int = 16, hi: int = 8192) -> int:
    """Size an SPSC ring from the producer/consumer service-rate ratio:
    a slow consumer (``cons/prod > 1``) earns a deeper ring so bursts
    queue instead of stalling the producer; a slow producer needs almost
    none.  The pilot's observed high-water mark sets a floor (×2 for
    headroom), and the result is a power of two in ``[lo, hi]``."""
    ratio = 1.0 if prod_us <= 0 or cons_us <= 0 else cons_us / prod_us
    ratio = min(8.0, max(0.125, ratio))
    need = max(int(base * ratio), 2 * high_water, lo)
    return min(hi, 1 << (need - 1).bit_length())


# ---------------------------------------------------------------------------
# micro-batching rewrite: KeyBatch emission for surviving fine hand-offs
# ---------------------------------------------------------------------------
class _RebatchNode(ff_node):
    """Buffer a stage's outputs and emit them ``batch`` at a time as ONE
    :class:`KeyBatch` wire message — one ring slot (and on procs one
    pickle) per batch instead of per item.

    Transparent by construction: every consumer-side vertex unpacks
    ``KeyBatch`` back into items before its node's ``svc`` (and the
    terminal result drain does the same), so downstream nodes never see
    the batching.  The wrapper only ever wraps *stateless* mid-pipeline
    stages whose successor is a Stage / AllToAll / Feedback / the caller
    — never a Farm, whose dispatch arbiter routes payloads whole."""

    def __init__(self, inner: ff_node, batch: int):
        self.inner = inner
        self.batch = max(2, int(batch))
        self._buf: List[Any] = []

    def svc_init(self) -> None:
        self.inner.svc_init()

    def svc_end(self) -> None:
        self.inner.svc_end()

    def _flush(self) -> KeyBatch:
        out = KeyBatch(self._buf)
        self._buf = []
        return out

    def svc(self, task: Any) -> Any:
        r = self.inner.svc(task)
        if r is None or r is GO_ON:
            # mid-pipeline None filters one item, exactly like the
            # unwrapped vertex (this node is never placed in source
            # position, where None would instead mean EOS)
            return GO_ON
        if isinstance(r, EmitMany):
            self._buf.extend(r)
        else:
            self._buf.append(r)
        return self._flush() if len(self._buf) >= self.batch else GO_ON

    def svc_eos(self) -> Any:
        r = self.inner.svc_eos()
        if r is not None and r is not GO_ON:
            self._buf.extend(r if isinstance(r, EmitMany) else [r])
        return self._flush() if self._buf else None


def _rebatch_ok_after(nxt: Optional[Skeleton]) -> bool:
    # KeyBatch unpacking happens in StageVertex/ProcStageVertex inbound
    # loops, the a2a scatter, and the caller-side result drain.  A farm's
    # DispatchVertex routes payloads whole — never batch into one.
    return nxt is None or isinstance(nxt, (Stage, AllToAll, Feedback))


# ---------------------------------------------------------------------------
# retune: the pure IR rewrite
# ---------------------------------------------------------------------------
def _effective_cons_us(sp: Optional[StageProfile]) -> float:
    if sp is None or not sp.items:
        return 0.0
    return sp.service_us / max(1, sp.width)


def _consumer_profile(prof: Profile, i: int) -> Optional[StageProfile]:
    """The profile entry that consumes position ``i``'s output: the next
    top-level position, or its left row if that is an all-to-all."""
    return prof.stage(str(i + 1)) or prof.stage(f"{i + 1}.left")


def _retune_one(s: Skeleton, sp: Optional[StageProfile],
                cons: Optional[StageProfile], terminal: bool) -> Skeleton:
    if sp is None or not sp.items:
        return s
    grain = int(round(sp.service_us))
    cap = s.capacity if terminal else ring_capacity(
        sp.service_us, _effective_cons_us(cons), sp.queue_high_water)
    if isinstance(s, Source):
        return Source(s.node, name=s.name, grain=s.grain, capacity=cap)
    if isinstance(s, Stage):
        return Stage(s.node, name=s.name, grain=grain, capacity=cap)
    if isinstance(s, Farm):
        return Farm(s.worker_nodes, s.nworkers, emitter=s.emitter,
                    collector=s.collector, ordered=s.ordered, grain=grain,
                    scheduling=s.scheduling, speculative=s.speculative,
                    straggler_factor=s.straggler_factor,
                    min_straggler_age=s.min_straggler_age,
                    feedback=s.feedback,
                    feedback_capacity=s.feedback_capacity,
                    queue_class=s.queue_class, capacity=s.capacity,
                    stats=s.stats)
    return s                      # AllToAll / Feedback: leave untouched


def retune(skel: Any, prof: Profile, *, backend: str = "threads"):
    """Re-lower ``skel`` from a measured :class:`Profile` — a pure IR
    rewrite that never changes results.

    Host backends (threads / procs): each Stage/Source/Farm gets its
    measured service time as ``grain=`` and a ring capacity from the
    producer/consumer rate ratio; :func:`~repro_torch.core.skeleton.fuse` then
    collapses every hand-off cheaper than the measured hand-off cost
    (including ``Farm∘Farm`` merges and a2a right-row absorption); and
    surviving fine-grain stateless stages get :class:`_RebatchNode`
    micro-batching.  The mesh backend tunes *program options*, not IR —
    its grain is a row count and its axis is the mesh factorization —
    so ``backend="mesh"`` returns the skeleton unchanged (see
    :func:`plan_mesh`)."""
    skel = as_skeleton(skel)
    if backend == "mesh":
        return skel
    stages = skel.stages if isinstance(skel, Pipeline) else [skel]
    rebuilt = [
        _retune_one(s, prof.stage(str(i)) or prof.stage(f"{i}.right"),
                    _consumer_profile(prof, i),
                    terminal=(i == len(stages) - 1))
        for i, s in enumerate(stages)
    ]
    tuned = fuse(Pipeline(*rebuilt) if len(rebuilt) > 1 else rebuilt[0],
                 threshold_us=prof.handoff_us)
    # micro-batch what fusion could not absorb
    out_stages = list(tuned.stages) if isinstance(tuned, Pipeline) \
        else [tuned]
    final: List[Skeleton] = []
    for i, s in enumerate(out_stages):
        nxt = out_stages[i + 1] if i + 1 < len(out_stages) else None
        if isinstance(s, Stage) and _stateless(s.node) \
                and s.grain is not None and _rebatch_ok_after(nxt):
            b = auto_batch(float(s.grain), prof.handoff_us)
            if b > 1:
                s = Stage(_RebatchNode(s.node, b), name=s.name,
                          grain=s.grain, capacity=s.capacity)
        final.append(s)
    return Pipeline(*final) if len(final) > 1 else final[0]


# ---------------------------------------------------------------------------
# mesh planning: factorization + microbatch grain from the bubble model
# ---------------------------------------------------------------------------
def plan_mesh(prof: Profile, skel: Any,
              devices: Optional[int] = None) -> Dict[str, Any]:
    """Mesh program options from a profile: the ``(stage, worker)``
    factorization with the higher modelled throughput
    (:func:`~repro_torch.core.dpipeline.best_factorization` over the measured
    per-stage costs) and, when the pipelined factorization wins, a
    microbatch ``grain`` sized so the fill/drain bubble stays under ~10%
    (``M ≥ 9·(S-1)`` microbatches ⇒ ``pipeline_utilisation ≥ 0.9``).
    ``devices=None`` counts the CUDA cards (``torch.cuda.device_count()``,
    through :mod:`.dfarm`, which imports torch)."""
    from . import dpipeline
    skel = as_skeleton(skel)
    stages = skel.stages if isinstance(skel, Pipeline) else [skel]
    if any(isinstance(s, AllToAll) for s in stages):
        return {}                 # the a2a mesh program has no stage axis
    costs = []
    for i, s in enumerate(stages):
        sp = prof.stage(str(i))
        costs.append(sp.service_us if sp and sp.items else 1.0)
    if devices is None:
        from .dfarm import device_count
        devices = device_count()
    ndev = devices
    fact = dpipeline.best_factorization(len(costs), ndev, stage_costs=costs,
                                        n_micro=9 * max(1, len(costs) - 1))
    plan: Dict[str, Any] = {"factorization": fact}
    n_stage = fact[0]
    if n_stage > 1:
        plan["grain"] = max(1, prof.pilot_items // (9 * (n_stage - 1)))
    return plan


# ---------------------------------------------------------------------------
# the two-phase program
# ---------------------------------------------------------------------------
class TunedProgram:
    """``lower(skel, backend, tune=True)``: profile a pilot slice, retune,
    replay.

    The first call takes ``pilot`` items off the front of the stream,
    runs them through an instrumented **threads** lowering (in-process —
    the pilot's outputs are real outputs and are returned with the
    rest), builds the :class:`Profile`, retunes the IR, and lowers the
    tuned skeleton on the target backend for the remainder.  Later calls
    go straight to the tuned program.  Passing ``profile=`` (a
    :class:`Profile` or a JSON path) skips the pilot entirely — the
    saved-profile replay path.

    Attributes after tuning: ``profile`` (the measurements), ``tuned``
    (the lowered tuned program), ``tuned_skeleton`` (the rewritten IR,
    host backends only)."""

    def __init__(self, skeleton: Skeleton, backend: str, *,
                 pilot: Optional[int] = None, profile: Any = None,
                 opts: Optional[Dict[str, Any]] = None):
        self.skeleton = as_skeleton(skeleton)
        self.backend = backend
        self.pilot = DEFAULT_PILOT if pilot is None else max(1, int(pilot))
        self.opts = dict(opts or {})
        self.profile: Optional[Profile] = (
            Profile.load(profile) if isinstance(profile, str)
            else profile)
        self.recalibrate = bool(self.opts.pop("recalibrate", False))
        self.tuned: Any = None
        self.tuned_skeleton: Optional[Skeleton] = None
        if self.profile is not None:
            self._build(self.profile)

    def _build(self, prof: Profile) -> None:
        self.profile = prof
        if self.backend == "mesh":
            # plan for the devices the mesh program will span (devices=,
            # else the cards for the default device); transport= and the
            # other options pass through to it
            from .skeleton import _mesh_devices
            plan = plan_mesh(prof, self.skeleton, _mesh_devices(
                self.opts.get("devices"), self.opts.get("device")))
            merged = {**plan, **self.opts}
            self.tuned = lower(self.skeleton, "mesh", **merged)
            self.tuned_skeleton = self.skeleton
        else:
            self.tuned_skeleton = retune(self.skeleton, prof,
                                         backend=self.backend)
            o = dict(self.opts)
            o.setdefault("fuse", False)   # retune already fused
            self.tuned = lower(self.tuned_skeleton, self.backend, **o)

    def __call__(self, items: Iterable[Any]) -> List[Any]:
        xs = list(items)
        if self.tuned is None:
            n = min(len(xs), self.pilot)
            prof, head = _profiled_run(self.skeleton, xs[:n],
                                       recalibrate=self.recalibrate)
            self._build(prof)
            if n == len(xs):
                return head
            return head + self.tuned(xs[n:])
        return self.tuned(xs)
