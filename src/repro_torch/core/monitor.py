"""Live monitoring — continuous in-run telemetry, drift detection, and
bottleneck attribution.

The port's copy of ``repro.core.monitor``: the same frames, reports and
JSON schemas, so a timeline or a profile written by either package reads
in the other.

The observability layer (:mod:`repro_torch.core.obs`) records spans and
folds stats into a :class:`~repro_torch.core.obs.RunReport` — but only at EOS.
Nothing can be observed *while* a stream runs, which is exactly when the
paper's fine-grain pathologies (a stalled SPSC edge, a mis-grained farm
— TR-09-12 Sec. 6) actually bite.  This module is the live half:

:class:`Monitor`
    A background sampler thread attached to a running
    :class:`~repro_torch.core.graph.Graph` or
    :class:`~repro_torch.core.procgraph.ProcGraph` through
    ``lower(skel, backend, monitor=...)``.  Every ``interval_s`` it
    snapshots live queue depths (the caller-side ``sample_depths()``
    tap — ``len()`` on a ring is a racy-but-benign read of the
    head/tail indices, cross-process included), per-farm service EWMAs
    and task counters (threads: the live ``FarmStats`` boards; procs:
    single-writer :class:`~repro_torch.core.shm.ShmCounters` boards, no ring
    traffic), throughput (caller-side ``results`` length), and
    spill/stall counters (:class:`~repro_torch.core.oocore.MemoryBudget`
    boards) into a :class:`Timeline`.  The mesh backend has no host
    vertices, so its program pushes one program-level frame per call
    (:meth:`Monitor.program_frame`).

:class:`Timeline`
    A bounded ring of timestamped frames (schema ``timeline/1``),
    JSON round-trippable, exportable as Perfetto **counter tracks**
    (``"ph": "C"``) that merge straight into
    :meth:`~repro_torch.core.obs.Trace.to_chrome_json` output via its
    ``timeline=`` argument.

:func:`analyze` / :class:`BottleneckReport`
    Queueing attribution over a timeline (or busy-time attribution over
    a :class:`~repro_torch.core.obs.Trace`): a stage is the bottleneck when
    its *inbound* pressure is high while its *outbound* queue runs dry
    — the classic upstream-full/downstream-empty signature — scored as
    ``pressure − outbound`` so the saturation cascade upstream of the
    slow stage does not steal the blame.  Recommendations are keyed to
    the autotune knobs (``grain``, ``capacity``, ``nworkers``,
    ``batch``) so the report plugs into ``retune()``'s vocabulary.

:class:`DriftWatcher`
    Diffs live service EWMAs against a saved autotune
    :class:`~repro_torch.core.autotune.Profile` (via ``Profile.diff``) and
    fires :meth:`~repro_torch.core.obs.MetricsRegistry.watch` callbacks when
    the relative drift crosses a threshold — the trigger half of the
    ROADMAP's online re-tuning arc.  A per-path latch fires exactly
    once per excursion and re-arms below half the threshold.

:class:`SLOMonitor`
    p99-latency / goodput thresholds over the serving engine's existing
    ``serve.request_latency_us`` histogram, with ``alert`` instants
    recorded into the trace.

``python -m repro_torch.core.monitor report.json`` renders a one-shot
top-like terminal summary of a saved timeline (or run report).

Everything here is stdlib-only — no torch, no numpy.  With
``monitor=None`` (the default) programs never enter this module at all:
``repro_torch.core`` resolves its names on first touch, so a program
lowered without a monitor never imports it (``tests/test_torch_monitor.py``).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .autotune import Profile, StageProfile
from .obs import MetricsRegistry, Trace
from .skeleton import (AllToAll, Farm, Feedback, Pipeline, Skeleton, Source,
                       Stage, walk_stats)

__all__ = ["Timeline", "Monitor", "DriftWatcher", "SLOMonitor",
           "BottleneckReport", "analyze", "KNOBS", "main"]

#: the tuning vocabulary recommendations are keyed to — the same knobs
#: ``retune()`` / ``plan_mesh()`` turn (see repro_torch.core.autotune)
KNOBS = ("grain", "capacity", "nworkers", "batch")

#: vertex names that mark a position as a farm (threads and procs use
#: the same arbiter names, so attribution is backend-neutral)
_FARM_INTERNAL = ("ff-emitter", "ff-worker")
_FARM_OUT = "ff-collector"

_monotonic = time.monotonic


# ---------------------------------------------------------------------------
# the timeline: a bounded ring of timestamped frames
# ---------------------------------------------------------------------------
class Timeline:
    """Time-series storage for monitor frames — a bounded ring, so a
    long-lived stream cannot eat the heap: once ``capacity`` frames are
    held, the oldest is overwritten and ``dropped`` counts what fell
    off.  A frame is a plain dict::

        {"t": <monotonic seconds>,
         "depths":   {qualname: int},      # instantaneous queue depths
         "ewma_us":  {qualname: float},    # per-farm service EWMA, µs
         "counters": {name: int|float}}    # monotone counters

    JSON round-trips through :meth:`to_json` / :meth:`from_json`
    (schema ``timeline/1``); :meth:`chrome_events` renders the frames
    as Chrome trace-event counter tracks (``"ph": "C"``) that
    :meth:`repro_torch.core.obs.Trace.to_chrome_json` merges via its
    ``timeline=`` argument."""

    schema = "timeline/1"

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._buf: List[dict] = []
        self._n = 0              # frames ever appended
        self._base_dropped = 0   # dropped count carried through from_json

    def append(self, frame: dict) -> None:
        if len(self._buf) < self.capacity:
            self._buf.append(frame)
        else:
            self._buf[self._n % self.capacity] = frame
        self._n += 1

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        return self._base_dropped + max(0, self._n - self.capacity)

    def frames(self) -> List[dict]:
        """The held frames, oldest first (ring order reconstructed)."""
        if self._n <= self.capacity:
            return list(self._buf)
        cut = self._n % self.capacity
        return self._buf[cut:] + self._buf[:cut]

    def span_s(self) -> float:
        fs = self.frames()
        if len(fs) < 2:
            return 0.0
        return max(0.0, fs[-1]["t"] - fs[0]["t"])

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict:
        return {"schema": self.schema, "capacity": self.capacity,
                "dropped": self.dropped, "frames": self.frames()}

    @classmethod
    def from_json(cls, d: dict) -> "Timeline":
        if d.get("schema") != cls.schema:
            raise ValueError(f"not a timeline: {d.get('schema')!r}")
        tl = cls(capacity=int(d.get("capacity", 4096)))
        for f in d.get("frames", []):
            tl.append(f)
        tl._base_dropped = int(d.get("dropped", 0))
        return tl

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str) -> "Timeline":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- Perfetto export -----------------------------------------------------
    def chrome_events(self, pid: int = 0) -> List[dict]:
        """The frames as Chrome trace-event **counter** records: one
        ``"C"`` event per (frame, series) under a dedicated
        ``ff-monitor`` process, so Perfetto draws queue depths, service
        EWMAs and counters as value tracks right above the span lanes
        the :class:`~repro_torch.core.obs.Trace` exports."""
        evs: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": "ff-monitor"}}]

        def counter(name: str, ts: float, value: Any) -> dict:
            return {"name": name, "ph": "C", "pid": pid, "tid": 0,
                    "ts": ts, "args": {"value": value}}

        for f in self.frames():
            ts = f.get("t", 0.0) * 1e6
            for qual, v in sorted(f.get("depths", {}).items()):
                evs.append(counter(f"depth:{qual}", ts, v))
            for qual, v in sorted(f.get("ewma_us", {}).items()):
                evs.append(counter(f"svc_us:{qual}", ts, v))
            for k, v in sorted(f.get("counters", {}).items()):
                evs.append(counter(k, ts, v))
        return evs


# ---------------------------------------------------------------------------
# skeleton walks: live telemetry boards the sampler reads
# ---------------------------------------------------------------------------
def _walk_budgets(skel: Skeleton, path: str = "") -> Iterable[Tuple[str, Any]]:
    """Yield ``(qualname, MemoryBudget)`` for every budget-carrying node
    in the IR tree (spill-to-disk folds), deduplicated — one a2a row
    shares one budget across its partitions."""
    seen: set = set()

    def walk(s: Skeleton, p: str) -> Iterable[Tuple[str, Any]]:
        if isinstance(s, Pipeline):
            for i, sub in enumerate(s.stages):
                yield from walk(sub, f"{p}.{i}" if p else str(i))
            return
        if isinstance(s, Farm):
            nodes, name = list(s.worker_nodes), "ff-farm"
        elif isinstance(s, AllToAll):
            nodes, name = list(s.left_nodes) + list(s.right_nodes), s.name
        elif isinstance(s, (Stage, Source, Feedback)):
            nodes, name = [s.node], s.name
        else:
            return
        for n in nodes:
            b = getattr(n, "budget", None)
            if b is not None and id(b) not in seen:
                seen.add(id(b))
                yield (f"{name}@{p}" if p else name), b

    yield from walk(skel, path)


# ---------------------------------------------------------------------------
# the monitor: a background sampler thread
# ---------------------------------------------------------------------------
class Monitor:
    """Continuous in-run telemetry: a daemon thread sampling a running
    graph into a :class:`Timeline` every ``interval_s``.

    Wire it through lowering — ``lower(skel, "threads", monitor=True)``
    (or a shared ``Monitor`` instance; ``"procs"`` likewise, ``"mesh"``
    gets one program-level frame per call) — or drive it by hand with
    :meth:`attach` / :meth:`detach` around ``graph.run()``.

    The sampler is an outside observer: every read is a racy-but-benign
    snapshot of single-writer state (ring head/tail indices, FarmStats
    fields, ShmCounters slots), so it costs the stream nothing but
    cache traffic.  Teardown races (a procs ring unlinked mid-sample)
    are absorbed, counted in ``errors``, never raised.

    ``profile=`` (an autotune :class:`Profile` or a path) arms a
    :class:`DriftWatcher` over the live service EWMAs;
    ``registry=`` routes drift events through
    :meth:`~repro_torch.core.obs.MetricsRegistry.watch` callbacks;
    ``on_frame=`` is called with every completed frame (the seam an
    elastic-farm controller hangs off)."""

    def __init__(self, *, interval_s: float = 0.002, capacity: int = 4096,
                 profile: Any = None, drift_threshold: float = 0.5,
                 registry: Optional[MetricsRegistry] = None,
                 on_frame: Optional[Callable[[dict], None]] = None):
        self.interval_s = float(interval_s)
        self.timeline = Timeline(capacity)
        self.registry = registry
        self.on_frame = on_frame
        self.drift: Optional[DriftWatcher] = None
        if profile is not None:
            self.drift = DriftWatcher(profile, threshold=drift_threshold,
                                      registry=registry)
        self.backend: Optional[str] = None
        self.errors = 0           # absorbed sampling failures (teardown races)
        self._target: Any = None
        self._stats: List[Tuple[str, Any]] = []
        self._budgets: List[Tuple[str, Any]] = []
        self._boards: Dict[str, Any] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def attach(self, target: Any, skeleton: Optional[Skeleton] = None,
               backend: Optional[str] = None) -> "Monitor":
        """Start sampling ``target`` (a :class:`~repro_torch.core.graph.Graph`
        or :class:`~repro_torch.core.procgraph.ProcGraph`).  ``skeleton``
        supplies the stats/budget boards to read alongside the queue
        depths.  Reattaching after :meth:`detach` appends to the same
        timeline (frames carry monotonic stamps, so runs concatenate)."""
        if self._thread is not None:
            raise RuntimeError("monitor already attached; detach() first")
        self._target = target
        self._boards = dict(getattr(target, "live_boards", None) or {})
        self.backend = backend or ("procs" if hasattr(target, "live_boards")
                                   else "threads")
        self._stats = list(walk_stats(skeleton)) if skeleton is not None \
            else []
        self._budgets = list(_walk_budgets(skeleton)) \
            if skeleton is not None else []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="ff-monitor",
                                        daemon=True)
        self._thread.start()
        return self

    def detach(self) -> Timeline:
        """Stop the sampler, take one final drain-time frame (the procs
        backend has folded its FarmStats home by now, so this frame
        carries the run's final EWMAs), drop every target reference."""
        th = self._thread
        if th is not None:
            self._stop.set()
            th.join(timeout=5.0)
            self._thread = None
            self.sample()
        self._target = None
        self._stats = []
        self._budgets = []
        self._boards = {}
        return self.timeline

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()

    # -- sampling ------------------------------------------------------------
    def sample(self) -> Optional[dict]:
        """Take one frame now (the thread calls this; callers may too,
        e.g. for deterministic tests).  Never raises: a sampler must not
        be able to kill the stream it watches."""
        try:
            frame = self._frame()
        except Exception:
            self.errors += 1
            return None
        self.timeline.append(frame)
        if self.drift is not None and frame["ewma_us"]:
            try:
                self.drift.check(frame["ewma_us"])
            except Exception:
                self.errors += 1
        if self.on_frame is not None:
            try:
                self.on_frame(frame)
            except Exception:
                self.errors += 1
        return frame

    def _frame(self) -> dict:
        target = self._target
        depths: Dict[str, int] = {}
        if target is not None:
            try:
                target.sample_depths(depths)
            except Exception:
                self.errors += 1
        ewma: Dict[str, float] = {}
        counters: Dict[str, Any] = {}
        results = getattr(target, "results", None)
        if results is not None:
            counters["items_out"] = len(results)
        # threads: the FarmStats boards are live shared objects; procs
        # fills them only at EOS (the detach-time frame picks those up)
        for qual, st in self._stats:
            try:
                d = st.service_ewma
                if d:
                    ewma[qual] = sum(d.values()) / len(d) * 1e6
                counters[f"{qual}.emitted"] = st.tasks_emitted
                counters[f"{qual}.collected"] = st.tasks_collected
            except Exception:
                self.errors += 1
        # procs: live single-writer counter boards, read caller-side —
        # no ring traffic, no arbiter involvement (overwrites the stale
        # FarmStats zeros above while the run is in flight)
        for qual, board in self._boards.items():
            vals = board.peek()
            if vals is not None:
                counters[f"{qual}.emitted"] = int(vals[0])
                counters[f"{qual}.collected"] = int(vals[1])
        for qual, budget in self._budgets:
            try:
                counters[f"{qual}.spills"] = budget.spills()
                counters[f"{qual}.stalls"] = budget.stalls()
            except Exception:
                pass    # board mid-teardown: keep the frame
        return {"t": _monotonic(), "depths": depths, "ewma_us": ewma,
                "counters": counters}

    def program_frame(self, counters: Dict[str, Any]) -> dict:
        """Mesh tap: the program has no host vertices to sample, so it
        pushes one program-level counter frame per call."""
        frame = {"t": _monotonic(), "depths": {}, "ewma_us": {},
                 "counters": dict(counters)}
        self.timeline.append(frame)
        if self.on_frame is not None:
            try:
                self.on_frame(frame)
            except Exception:
                self.errors += 1
        return frame


# ---------------------------------------------------------------------------
# the drift watcher: live EWMAs vs a saved pilot profile
# ---------------------------------------------------------------------------
class DriftWatcher:
    """The trigger half of online re-tuning: compare live service EWMAs
    against a saved autotune :class:`Profile` (through ``Profile.diff``
    — the ROADMAP's designated seam) and fire when the relative drift
    crosses ``threshold``.

    Each IR path carries a latch: one firing per excursion, re-armed
    only once the drift falls back under ``threshold / 2`` — so a
    stage sitting *at* the threshold cannot machine-gun callbacks.
    Firings append to ``events`` and, when a ``registry`` is given,
    run through ``registry.finalize(registry.report(meta=event))`` so
    every ``registry.watch()`` callback sees them."""

    def __init__(self, saved: Any, *, threshold: float = 0.5,
                 registry: Optional[MetricsRegistry] = None):
        self.saved: Profile = Profile.load(saved) if isinstance(saved, str) \
            else saved
        self.threshold = float(threshold)
        self.registry = registry
        self.events: List[dict] = []
        self._armed: Dict[str, bool] = {}

    def check(self, live_ewma_us: Dict[str, float]) -> List[dict]:
        """One comparison pass over ``{qualname: live EWMA µs}``;
        returns the events fired by this pass (also kept in
        ``events``)."""
        stages = []
        for qual, us in sorted(live_ewma_us.items()):
            name, _, path = qual.rpartition("@") if "@" in qual \
                else (qual, "", "")
            stages.append(StageProfile(path=path, kind="live", name=name,
                                       service_us=float(us),
                                       service_ewma_us=float(us), items=1))
        live = Profile(handoff_us=self.saved.handoff_us, pilot_items=0,
                       stages=stages)
        fired: List[dict] = []
        for path, d in live.diff(self.saved).items():
            mine, theirs = d["service_us"]
            if mine is None or theirs is None or theirs <= 0:
                continue
            rel = abs(mine - theirs) / theirs
            armed = self._armed.get(path, True)
            if rel > self.threshold and armed:
                self._armed[path] = False
                ev = {"event": "drift", "path": path, "live_us": mine,
                      "saved_us": theirs, "rel": rel,
                      "threshold": self.threshold}
                self.events.append(ev)
                fired.append(ev)
                reg = self.registry
                if reg is not None:
                    reg.counter("monitor.drift_alerts").inc()
                    reg.finalize(reg.report(meta=ev))
            elif rel < self.threshold / 2 and not armed:
                self._armed[path] = True
        return fired


# ---------------------------------------------------------------------------
# the SLO monitor: latency/goodput thresholds for the serving engine
# ---------------------------------------------------------------------------
class SLOMonitor:
    """Service-level thresholds over live serving telemetry: fire when
    the request-latency p99 exceeds ``p99_us`` or goodput falls under
    ``min_goodput`` (tokens/s — any rate the caller supplies).

    Same latch discipline as :class:`DriftWatcher` (one alert per
    excursion, re-armed when the signal recovers).  Alerts append to
    ``events``; :meth:`bind` a :class:`~repro_torch.core.obs.Tracer` to also
    record each alert as an ``alert`` instant on an ``slo-monitor``
    lane, so the trace shows *when* the SLO broke relative to the
    decode spans; a ``registry`` routes alerts through its ``watch()``
    callbacks and counts them in ``slo.alerts``."""

    def __init__(self, *, p99_us: Optional[float] = None,
                 min_goodput: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.p99_us = p99_us
        self.min_goodput = min_goodput
        self.registry = registry
        self.events: List[dict] = []
        self._lane = None
        self._armed = {"latency": True, "goodput": True}

    def bind(self, tracer: Any) -> "SLOMonitor":
        self._lane = tracer.vertex("slo-monitor")
        return self

    def _fire(self, kind: str, ev: dict) -> None:
        self._armed[kind] = False
        self.events.append(ev)
        if self._lane is not None:
            self._lane.instant("alert", ev)
        reg = self.registry
        if reg is not None:
            reg.counter("slo.alerts").inc()
            reg.finalize(reg.report(meta=ev))

    def check(self, hist: Any = None,
              goodput: Optional[float] = None) -> List[dict]:
        """One evaluation pass: ``hist`` is a latency
        :class:`~repro_torch.core.obs.Histogram` (µs), ``goodput`` a rate.
        Returns the alerts fired by this pass."""
        before = len(self.events)
        if self.p99_us is not None and hist is not None \
                and getattr(hist, "count", 0):
            p99 = hist.p99
            if p99 > self.p99_us and self._armed["latency"]:
                self._fire("latency", {
                    "event": "slo", "signal": "p99_latency_us",
                    "value": p99, "threshold": self.p99_us})
            elif p99 <= self.p99_us:
                self._armed["latency"] = True
        if self.min_goodput is not None and goodput is not None:
            if goodput < self.min_goodput and self._armed["goodput"]:
                self._fire("goodput", {
                    "event": "slo", "signal": "goodput",
                    "value": goodput, "threshold": self.min_goodput})
            elif goodput >= self.min_goodput:
                self._armed["goodput"] = True
        return self.events[before:]


# ---------------------------------------------------------------------------
# the bottleneck analyzer
# ---------------------------------------------------------------------------
class BottleneckReport:
    """Structured verdict from :func:`analyze`.

    ``stage`` names the dominant bottleneck (``None`` when the network
    is balanced), ``edge`` the producer vertex whose outbound ring
    carries the pressure, ``verdict`` is ``queue-bound`` /
    ``compute-bound`` / ``balanced``.  ``utilization`` is per-stage
    (fraction of frames with work queued inbound, or busy-time fraction
    from a trace); ``attribution`` shares out the blame (positive
    scores, normalised); ``recommendations`` are keyed to the autotune
    knobs (:data:`KNOBS`)."""

    schema = "bottleneck-report/1"

    def __init__(self, *, stage: Optional[str], edge: Optional[str],
                 verdict: str, utilization: Dict[str, float],
                 attribution: Dict[str, float],
                 recommendations: List[Dict[str, str]],
                 mean_depths: Optional[Dict[str, float]] = None,
                 frames: int = 0, throughput: Optional[float] = None):
        self.stage = stage
        self.edge = edge
        self.verdict = verdict
        self.utilization = utilization
        self.attribution = attribution
        self.recommendations = recommendations
        self.mean_depths = dict(mean_depths or {})
        self.frames = frames
        self.throughput = throughput

    def to_json(self) -> dict:
        return {"schema": self.schema, "stage": self.stage,
                "edge": self.edge, "verdict": self.verdict,
                "utilization": self.utilization,
                "attribution": self.attribution,
                "recommendations": self.recommendations,
                "mean_depths": self.mean_depths, "frames": self.frames,
                "throughput": self.throughput}

    def render(self) -> str:
        lines = [f"bottleneck: {self.stage or '(none)'}  [{self.verdict}]"]
        if self.edge:
            lines.append(f"  hottest edge: {self.edge} -> {self.stage}")
        if self.throughput is not None:
            lines.append(f"  throughput: {self.throughput:.1f} items/s")
        if self.utilization:
            lines.append(f"  {'stage':<28}{'util':>7}{'share':>8}")
            for label in sorted(self.utilization):
                util = self.utilization[label]
                share = self.attribution.get(label, 0.0)
                lines.append(f"  {label:<28}{util:>6.0%}{share:>7.0%}")
        for rec in self.recommendations:
            lines.append(f"  -> {rec['knob']}: {rec['action']}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"BottleneckReport(stage={self.stage!r}, "
                f"verdict={self.verdict!r}, "
                f"recommend={[r['knob'] for r in self.recommendations]})")


def _split_qual(qual: str) -> Tuple[str, str]:
    if "@" in qual:
        name, _, path = qual.rpartition("@")
        return name, path
    return qual, ""


def _pos_key(pos: str) -> Tuple[int, Any]:
    if pos == "in":
        return (-1, "")
    head = pos.split(".", 1)[0]
    return (int(head), pos) if head.isdigit() else (10**9, pos)


def analyze(source: Any, *, min_depth: float = 0.5) -> BottleneckReport:
    """Attribute the bottleneck in a :class:`Timeline` (or its
    ``timeline/1`` JSON dict), or — busy-time flavour — in a
    :class:`~repro_torch.core.obs.Trace`.

    Queueing attribution has to beat the saturation cascade: when one
    stage runs 10× slow, *every* queue upstream of it fills (the source
    stalls against stage 0, stage 0 against stage 1, …), so naive
    argmax-over-depth blames the frontmost edge.  The score here is
    ``pressure − outbound``: the slow stage is the one whose inbound
    (or farm-internal) queues are deep while its own outbound queue is
    drained by an idle consumer.  ``min_depth`` is the mean-depth floor
    under which the network is called balanced."""
    if isinstance(source, Trace):
        return _analyze_trace(source)
    if isinstance(source, Timeline):
        frames = source.frames()
    elif isinstance(source, dict):
        if source.get("schema") != Timeline.schema:
            raise ValueError(
                f"analyze() wants timeline/1 JSON, got "
                f"{source.get('schema')!r}")
        frames = list(source.get("frames", []))
    else:
        raise TypeError(f"cannot analyze {type(source).__name__}")
    return _analyze_frames(frames, min_depth)


def _analyze_frames(frames: List[dict], min_depth: float) -> BottleneckReport:
    n = len(frames)
    sums: Dict[str, float] = {}
    nonzero: Dict[str, int] = {}
    for f in frames:
        for qual, v in f.get("depths", {}).items():
            sums[qual] = sums.get(qual, 0.0) + v
            if v > 0:
                nonzero[qual] = nonzero.get(qual, 0) + 1
    means = {q: s / max(1, n) for q, s in sums.items()}
    busy = {q: nonzero.get(q, 0) / max(1, n) for q in sums}

    # group vertices by top-level IR position ("in" = the driving source)
    groups: Dict[str, List[str]] = {}
    for qual in means:
        _, path = _split_qual(qual)
        pos = path.split(".", 1)[0] if path else ""
        groups.setdefault(pos, []).append(qual)
    order = sorted(groups, key=_pos_key)

    # per position: the outbound tap, the farm-internal taps, a label
    info: Dict[str, dict] = {}
    for pos, members in groups.items():
        internal = [q for q in members
                    if _split_qual(q)[0].startswith(_FARM_INTERNAL)]
        out_q = next((q for q in members
                      if _split_qual(q)[0].startswith(_FARM_OUT)), None)
        if internal or out_q:
            label = f"ff-farm@{pos}"
        else:
            label = max(members, key=lambda q: means[q])
        if out_q is None:
            out_q = label if label in means else members[0]
        info[pos] = {"label": label, "out": out_q, "internal": internal}

    # score: pressure (inbound or farm-internal depth) minus outbound
    scored: List[dict] = []
    prev_out: Optional[str] = None
    for pos in order:
        d = info[pos]
        inbound = means.get(prev_out, 0.0) if prev_out is not None else 0.0
        inbound_q = prev_out
        internal = max((means[q] for q in d["internal"]), default=0.0)
        internal_q = max(d["internal"], key=lambda q: means[q]) \
            if d["internal"] else None
        out = means.get(d["out"], 0.0)
        if inbound >= internal:
            pressure, pressure_q = inbound, inbound_q
        else:
            pressure, pressure_q = internal, internal_q
        if pos != "in":      # the driving source has no inbound edge
            scored.append({
                "pos": pos, "label": d["label"], "pressure": pressure,
                "edge": pressure_q, "out": out,
                "score": pressure - out,
                "util": busy.get(pressure_q, 0.0) if pressure_q else 0.0,
                "is_farm": bool(d["internal"])})
        prev_out = d["out"]

    throughput = _throughput(frames)
    utilization = {s["label"]: s["util"] for s in scored}
    positive = {s["label"]: s["score"] for s in scored if s["score"] > 0}
    total = sum(positive.values())
    attribution = {k: v / total for k, v in positive.items()} if total else {}

    if not scored:
        return BottleneckReport(stage=None, edge=None, verdict="balanced",
                                utilization={}, attribution={},
                                recommendations=[], mean_depths=means,
                                frames=n, throughput=throughput)
    top = max(scored, key=lambda s: s["score"])
    if top["pressure"] < min_depth:
        return BottleneckReport(
            stage=None, edge=None, verdict="balanced",
            utilization=utilization, attribution={}, recommendations=[],
            mean_depths=means, frames=n, throughput=throughput)
    recs = _recommend(top)
    return BottleneckReport(
        stage=top["label"], edge=top["edge"], verdict="queue-bound",
        utilization=utilization, attribution=attribution,
        recommendations=recs, mean_depths=means, frames=n,
        throughput=throughput)


def _throughput(frames: List[dict]) -> Optional[float]:
    pts = [(f["t"], f["counters"]["items_out"]) for f in frames
           if "items_out" in f.get("counters", {})]
    if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
        return None
    return (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])


def _recommend(top: dict) -> List[Dict[str, str]]:
    """Knob-keyed recommendations (the autotune vocabulary, so the
    report plugs into ``retune()``'s levers)."""
    label = top["label"]
    if top["is_farm"]:
        recs = [{"knob": "nworkers", "target": label,
                 "action": f"widen {label}: workers are saturated "
                           f"(pressure depth {top['pressure']:.1f} vs "
                           f"outbound {top['out']:.1f})"}]
        if top["pressure"] > 4 * max(top["out"], 0.25):
            recs.append({"knob": "capacity", "target": label,
                         "action": f"deepen the inbound ring of {label} "
                                   f"only if the imbalance is bursty; "
                                   f"sustained imbalance needs width"})
        return recs
    return [{"knob": "nworkers", "target": label,
             "action": f"parallelise {label}: wrap it in a Farm "
                       f"(inbound queue depth {top['pressure']:.1f}, "
                       f"outbound {top['out']:.1f})"},
            {"knob": "grain", "target": label,
             "action": f"declare the measured grain on {label} so "
                       f"retune() can size rings and micro-batch "
                       f"around it"}]


def _analyze_trace(trace: Trace) -> BottleneckReport:
    """Busy-time attribution from span lanes: the stage whose vertices
    spend the largest fraction of the RUN in ``svc`` is the critical
    path.  The denominator is the common run window, not each lane's
    own lifetime — a fast stage's lane dies early, so dividing by its
    short life would score it as busy as the stage everyone waits on
    (and sampled spans scale every lane's numerator equally, so the
    window-relative ranking survives sampling)."""
    t_lo, t_hi = None, None
    svc_by_qual: Dict[str, float] = {}
    for vt in trace.lanes:
        for e in vt.events:
            if e[1] is not None:
                t_lo = e[1] if t_lo is None else min(t_lo, e[1])
            if len(e) > 2 and isinstance(e[2], (int, float)):
                t_hi = e[2] if t_hi is None else max(t_hi, e[2])
        svc = sum(e[2] - e[1] for e in vt.events
                  if e[0] == "svc" and e[2] is not None)
        if svc > 0:
            svc_by_qual[vt.qualname] = svc
    window = (t_hi - t_lo) if t_lo is not None and t_hi is not None else 0.0
    util: Dict[str, float] = {}
    if window > 0:
        util = {q: min(1.0, s / window) for q, s in svc_by_qual.items()}
    if not util:
        return BottleneckReport(stage=None, edge=None, verdict="balanced",
                                utilization={}, attribution={},
                                recommendations=[], frames=0)
    top = max(util, key=lambda q: util[q])
    total = sum(util.values())
    attribution = {q: v / total for q, v in util.items()}
    name, path = _split_qual(top)
    is_farm = name.startswith(_FARM_INTERNAL + (_FARM_OUT,))
    label = f"ff-farm@{path.split('.', 1)[0]}" if is_farm and path else top
    fake = {"label": label, "pressure": util[top], "out": 0.0,
            "is_farm": is_farm}
    return BottleneckReport(
        stage=label, edge=None, verdict="compute-bound",
        utilization=util, attribution=attribution,
        recommendations=_recommend(fake), frames=len(trace.lanes))


# ---------------------------------------------------------------------------
# the CLI: one-shot top-like summary of a saved timeline / run report
# ---------------------------------------------------------------------------
def _render_timeline(tl: Timeline) -> str:
    frames = tl.frames()
    lines = [f"ff-monitor: {len(frames)} frames over {tl.span_s():.3f}s"
             f" ({tl.dropped} dropped)"]
    sums: Dict[str, float] = {}
    maxes: Dict[str, int] = {}
    nonzero: Dict[str, int] = {}
    for f in frames:
        for q, v in f.get("depths", {}).items():
            sums[q] = sums.get(q, 0.0) + v
            maxes[q] = max(maxes.get(q, 0), v)
            if v > 0:
                nonzero[q] = nonzero.get(q, 0) + 1
    if sums:
        lines.append(f"  {'queue (producer vertex)':<28}"
                     f"{'mean':>7}{'max':>6}{'busy':>6}")
        for q in sorted(sums, key=lambda x: -sums[x]):
            mean = sums[q] / max(1, len(frames))
            busy = nonzero.get(q, 0) / max(1, len(frames))
            lines.append(f"  {q:<28}{mean:>7.1f}{maxes[q]:>6}{busy:>6.0%}")
    if frames:
        last = frames[-1].get("counters", {})
        if last:
            kv = " ".join(f"{k}={last[k]}" for k in sorted(last))
            lines.append(f"  counters: {kv}")
        ewma = frames[-1].get("ewma_us", {})
        for q in sorted(ewma):
            lines.append(f"  svc ewma {q}: {ewma[q]:.1f}us")
    return "\n".join(lines)


def _render_run_report(doc: dict) -> str:
    lines = ["run-report/1 summary"]
    meta = doc.get("meta", {})
    if meta:
        kv = " ".join(f"{k}={meta[k]}" for k in sorted(meta))
        lines.append(f"  meta: {kv}")
    for k in sorted(doc.get("counters", {})):
        lines.append(f"  counter {k} = {doc['counters'][k]}")
    for k in sorted(doc.get("hists", {})):
        h = doc["hists"][k]
        lines.append(f"  hist {k}: count={h.get('count', 0)} "
                     f"p50={h.get('p50', 0.0):.1f} "
                     f"p99={h.get('p99', 0.0):.1f}")
    queues = doc.get("queues", {})
    if queues:
        deepest = sorted(queues, key=lambda q: -queues[q])[:8]
        for q in deepest:
            lines.append(f"  queue high-water {q} = {queues[q]}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.monitor",
        description="One-shot top-like summary of a saved timeline/1 "
                    "(with bottleneck attribution) or run-report/1 JSON.")
    ap.add_argument("report", help="path to a timeline/1 or run-report/1 "
                                   "JSON file")
    args = ap.parse_args(argv)
    with open(args.report) as f:
        doc = json.load(f)
    schema = doc.get("schema")
    if schema == Timeline.schema:
        tl = Timeline.from_json(doc)
        print(_render_timeline(tl))
        print(analyze(tl).render())
        return 0
    if schema == "run-report/1":
        print(_render_run_report(doc))
        return 0
    print(f"unrecognised schema {schema!r} "
          f"(want {Timeline.schema!r} or 'run-report/1')", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
