"""Unified runtime observability — vertex tracing and metrics.

FastFlow's whole argument (TR-09-12) lives at the microsecond scale: a
farm hand-off costs a few hundred nanoseconds, so any instrumentation
that costs more than a few of those when idle destroys the property
being measured.  This module is the one observability substrate every
lowering shares, built around that constraint:

:class:`Tracer` / :class:`VertexTracer`
    Typed span/instant events (``svc`` begin/end, ``stall`` push-waits,
    ``life``, a farm's ``run``; ``steal``, ``spill``, ``eos``, ``loop``
    tokens) recorded into bounded per-vertex buffers.  Spans are sampled
    1-in-N with the same mask trick the ordered-farm latency sampling
    uses (``n & mask``), so the hot path pays ~two clock reads on a
    sampled-in event, one counter increment otherwise — and **nothing at
    all** when tracing is off, because vertices then carry
    ``tracer = None`` and never enter this module (pinned by the
    tracer-off allocation test).  Every buffer has one writer — its
    vertex — so the single-writer discipline of the runtime survives;
    procs vertices ship their buffers back over the existing
    control-ring machinery at EOS, and the clock is ``time.monotonic()``
    (CLOCK_MONOTONIC — system-wide on Linux), so lanes from different
    processes share one timeline.  A Tracer handed to successive runs
    gives the k-th vertex of a qualname in each run the same lane (the
    previous run's vertex has joined, so the lane still has one writer),
    and numbers each traced run: a
    farm worker's ``svc`` span carries that run id and the task's tag,
    and ``TaskFarm`` adds one ``run`` span a run.

:class:`Trace`
    The merged snapshot: one lane per vertex (qualified by IR path, so
    two same-named stages cannot collide), exported via
    :meth:`Trace.to_chrome_json` in Chrome trace-event format — any run
    opens in Perfetto / ``chrome://tracing`` with one named lane per
    vertex/process.

:class:`MetricsRegistry`
    Counters, gauges and reservoir histograms (p50/p95/p99), plus
    :func:`farm_stats_snapshot`, the plain-dict form of a ``FarmStats``.

:class:`RunReport`
    One snapshot per program run (``MetricsRegistry.report``), merged
    across runs; ``ServeEngine.run`` and ``lower(.., metrics=True)``
    programs leave one on ``last_report``.  ``watch()`` callbacks fire on
    every finalized report, and :meth:`RunReport.to_profile` rebuilds an
    autotune ``Profile`` so ``Profile.diff`` can compare a live run
    against a saved pilot.

Everything here is stdlib-only: no torch, no numpy.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Tracer", "VertexTracer", "Trace", "MetricsRegistry", "Counter",
    "Gauge", "Histogram", "qualname", "farm_stats_snapshot", "RunReport",
]

_monotonic = time.monotonic


def qualname(name: str, path: str = "") -> str:
    """The collision-free key for one vertex: ``name@path`` where
    ``path`` is the vertex's IR path (empty for direct graph users, who
    get the bare name back).  Two farms — or two stages sharing a
    user-visible name — land at different IR paths, so their stats and
    lanes cannot merge."""
    return f"{name}@{path}" if path else name


def _pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


class VertexTracer:
    """One vertex's private event buffer — single writer, bounded, cheap.

    ``begin()``/``end()`` bracket a span with 1-in-``sample`` sampling:
    the off-sample path is one counter increment and a constant ``0.0``
    return (``end`` then no-ops), the on-sample path is two
    ``monotonic()`` reads and one tuple append.  ``instant()`` records
    rare events (steal/spill/eos) unsampled; ``tick()`` is the sampled
    instant for high-frequency ones (loop tokens).  The buffer is a
    plain list capped at ``capacity`` — overflow increments ``dropped``
    instead of growing, so a runaway vertex cannot eat the heap.

    Events are plain tuples ``(kind, t0, t1)`` (``t1 is None`` for an
    instant, optionally ``(kind, t0, t1, args)``), picklable as-is for
    the procs EOS ship-back.  ``rewind()`` makes the next ``begin()``
    sampled in, so a run's first span is recorded whatever the sample.
    """

    __slots__ = ("name", "path", "pid", "capacity", "events", "dropped",
                 "_n", "_mask")

    def __init__(self, name: str, path: str = "", *, sample: int = 16,
                 capacity: int = 2048, pid: Optional[int] = None):
        self.name = name
        self.path = path
        self.pid = os.getpid() if pid is None else pid
        self.capacity = int(capacity)
        self.events: List[tuple] = []
        self.dropped = 0
        self._n = 0
        self._mask = _pow2(sample) - 1

    @property
    def qualname(self) -> str:
        return qualname(self.name, self.path)

    # -- the hot path --------------------------------------------------------
    def begin(self) -> float:
        """Start a sampled span; returns the start stamp, or ``0.0`` when
        this occurrence is sampled out (``end`` then no-ops)."""
        n = self._n
        self._n = n + 1
        if n & self._mask:
            return 0.0
        return _monotonic()

    def end(self, t0: float, kind: str, args: Optional[dict] = None) -> None:
        """Close the span opened by the matching :meth:`begin`."""
        if not t0:
            return
        if len(self.events) < self.capacity:
            if args is None:
                self.events.append((kind, t0, _monotonic()))
            else:
                self.events.append((kind, t0, _monotonic(), args))
        else:
            self.dropped += 1

    def rewind(self) -> None:
        """Sample the next :meth:`begin` in (a run's first task)."""
        self._n = 0

    def tick(self, kind: str) -> None:
        """Sampled instant — for per-item-frequency events (loop tokens);
        shares the span counter, so one 1-in-N stream covers both."""
        n = self._n
        self._n = n + 1
        if n & self._mask:
            return
        if len(self.events) < self.capacity:
            self.events.append((kind, _monotonic(), None))
        else:
            self.dropped += 1

    # -- the rare path -------------------------------------------------------
    def instant(self, kind: str, args: Optional[dict] = None) -> None:
        """Unsampled instant — for rare events (steal, spill, EOS)."""
        if len(self.events) < self.capacity:
            if args is None:
                self.events.append((kind, _monotonic(), None))
            else:
                self.events.append((kind, _monotonic(), None, args))
        else:
            self.dropped += 1

    def span(self, kind: str, t0: float, t1: float,
             args: Optional[dict] = None) -> None:
        """Unsampled span with caller-supplied stamps — program-level
        events (mesh compile/call walls) and already-timed stalls."""
        if len(self.events) < self.capacity:
            if args is None:
                self.events.append((kind, t0, t1))
            else:
                self.events.append((kind, t0, t1, args))
        else:
            self.dropped += 1


class Tracer:
    """The per-run collector: hands each vertex its private
    :class:`VertexTracer` lane, absorbs procs lanes shipped back at EOS,
    and snapshots everything into a :class:`Trace`.

    ``sample`` is rounded up to a power of two (the mask trick needs
    it); ``capacity`` bounds every lane independently.  Construction and
    lane registration happen at lowering/start time, never on the data
    path.  Hand a Tracer to one run at a time: successive runs share its
    lanes."""

    def __init__(self, *, sample: int = 16, capacity: int = 2048):
        self.sample = _pow2(sample)
        self.capacity = int(capacity)
        self._lanes: List[VertexTracer] = []
        self._by_qual: Dict[str, List[VertexTracer]] = {}
        self._taken: Dict[str, int] = {}    # lanes handed out this run
        self._runs = 0

    def vertex(self, name: str, path: str = "") -> VertexTracer:
        """The lane of the k-th vertex of ``name@path`` in this run (in
        this process): the one the k-th vertex of an earlier run wrote, or
        a new one."""
        qual = qualname(name, path)
        lanes = self._by_qual.setdefault(qual, [])
        k = self._taken.get(qual, 0)
        self._taken[qual] = k + 1
        if k == len(lanes):
            lanes.append(VertexTracer(name, path, sample=self.sample,
                                      capacity=self.capacity))
            self._lanes.append(lanes[k])
        return lanes[k]

    def next_run(self) -> int:
        """Start a run: a new run id (0, 1, ...), the identifier one run's
        spans share, and its vertices take the lanes from the first again."""
        self._taken.clear()
        self._runs += 1
        return self._runs - 1

    def absorb(self, name: str, path: str, pid: int, events: List[tuple],
               dropped: int = 0) -> None:
        """Adopt a lane recorded in another process (the procs EOS
        ship-back): the child's buffer becomes a lane here verbatim —
        monotonic stamps are system-wide, so no clock translation."""
        vt = VertexTracer(name, path, sample=self.sample,
                          capacity=self.capacity, pid=pid)
        vt.events = list(events)
        vt.dropped = int(dropped)
        self._lanes.append(vt)

    def trace(self) -> "Trace":
        return Trace(list(self._lanes))


class Trace:
    """An immutable snapshot of every lane a run recorded."""

    def __init__(self, lanes: List[VertexTracer]):
        self.lanes = lanes

    def lane(self, qual: str) -> Optional[VertexTracer]:
        for vt in self.lanes:
            if vt.qualname == qual:
                return vt
        return None

    def qualnames(self) -> List[str]:
        return sorted(vt.qualname for vt in self.lanes)

    def events(self, kind: Optional[str] = None) -> List[tuple]:
        out = []
        for vt in self.lanes:
            for e in vt.events:
                if kind is None or e[0] == kind:
                    out.append(e)
        return out

    def to_chrome_json(self, path: Optional[str] = None, *,
                       timeline: Any = None) -> dict:
        """Export in Chrome trace-event format (the JSON-object form:
        ``{"traceEvents": [...]}``), one named lane per vertex —
        ``pid`` is the recording process, ``tid`` a per-lane id with a
        ``thread_name`` metadata event carrying the vertex qualname, so
        Perfetto / ``chrome://tracing`` renders the run as labelled
        swim-lanes.  Spans are ``"X"`` complete events, instants ``"i"``
        (thread scope); timestamps are microseconds on the shared
        monotonic clock.  ``timeline=`` (a
        :class:`~repro.core.monitor.Timeline`) merges the live monitor's
        frames in as ``"C"`` counter tracks — queue depths and service
        EWMAs render as value graphs above the span lanes, on the same
        clock.  Returns the document; also writes it to ``path`` when
        given."""
        evs: List[dict] = []
        for tid, vt in enumerate(self.lanes, start=1):
            evs.append({"name": "thread_name", "ph": "M", "pid": vt.pid,
                        "tid": tid, "args": {"name": vt.qualname}})
            for e in vt.events:
                kind, t0, t1 = e[0], e[1], e[2]
                d: Dict[str, Any] = {"name": kind, "pid": vt.pid,
                                     "tid": tid, "ts": t0 * 1e6}
                if t1 is None:
                    d["ph"] = "i"
                    d["s"] = "t"
                else:
                    d["ph"] = "X"
                    d["dur"] = max(0.0, (t1 - t0) * 1e6)
                if len(e) > 3:
                    d["args"] = e[3]
                evs.append(d)
            if vt.dropped:
                evs.append({"name": "dropped", "ph": "i", "s": "t",
                            "pid": vt.pid, "tid": tid,
                            "ts": (vt.events[-1][1] if vt.events else 0.0)
                            * 1e6,
                            "args": {"count": vt.dropped}})
        if timeline is not None:
            evs.extend(timeline.chrome_events())
        doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded-reservoir histogram with a proper percentile surface —
    the same keep-the-last-``cap`` discipline as ``LatencyReservoir``
    (lifetime ``count``/``total`` stay exact; percentiles come from the
    most recent ``cap`` observations, which is the regime a stream
    cares about)."""

    __slots__ = ("name", "cap", "count", "total", "vmax", "_buf")

    def __init__(self, name: str, cap: int = 2048):
        self.name = name
        self.cap = int(cap)
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0
        self._buf: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        if len(self._buf) < self.cap:
            self._buf.append(v)
        else:
            self._buf[self.count % self.cap] = v
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, p: float) -> float:
        if not self._buf:
            return 0.0
        s = sorted(self._buf)
        i = min(len(s) - 1, max(0, int(p / 100.0 * len(s))))
        return s[i]

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> None:
        self.count += other.count
        self.total += other.total
        self.vmax = max(self.vmax, other.vmax)
        room = self.cap - len(self._buf)
        if room > 0:
            self._buf.extend(other._buf[:room])

    def snapshot(self) -> dict:
        return {"count": self.count, "mean": self.mean, "max": self.vmax,
                "p50": self.p50, "p95": self.p95, "p99": self.p99,
                "cap": self.cap, "samples": list(self._buf)}


def _percentile_sorted(s: List[float], p: float) -> float:
    if not s:
        return 0.0
    return s[min(len(s) - 1, max(0, int(p / 100.0 * len(s))))]


def _merge_hist_snapshots(a: dict, b: dict) -> dict:
    """Commutative merge of two histogram snapshots.  When both carry
    reservoir samples, concatenate them (sorted, evenly subsampled back
    to the window cap when over it) and recompute the percentiles over
    the union — cross-run p95/p99 then cover both runs' observations.
    Sorting before the deterministic even-spaced subsample makes the
    result order-independent, so ``a.merge(b) == b.merge(a)`` (pinned by
    the commutativity test).  Snapshots from before samples shipped fall
    back to the old count-weighted average."""
    n1, n2 = a.get("count", 0), b.get("count", 0)
    n = n1 + n2
    merged = {"count": n, "max": max(a.get("max", 0.0), b.get("max", 0.0))}
    s1, s2 = a.get("samples"), b.get("samples")
    if s1 is not None and s2 is not None:
        cap = int(a.get("cap") or b.get("cap") or 2048)
        samples = sorted(list(s1) + list(s2))
        if len(samples) > cap:
            samples = [samples[i * len(samples) // cap] for i in range(cap)]
        merged["cap"] = cap
        merged["samples"] = samples
        merged["mean"] = (a.get("mean", 0.0) * n1 +
                          b.get("mean", 0.0) * n2) / n if n else 0.0
        for p, key in ((50, "p50"), (95, "p95"), (99, "p99")):
            merged[key] = _percentile_sorted(samples, p)
    else:
        for key in ("mean", "p50", "p95", "p99"):
            x, y = a.get(key, 0.0), b.get(key, 0.0)
            merged[key] = (x * n1 + y * n2) / n if n else 0.0
    return merged


class MetricsRegistry:
    """Named counters/gauges/histograms plus the ``watch()`` hook.

    One registry per program (or shared across programs — names are the
    namespace).  ``report()`` snapshots everything into a
    :class:`RunReport`; ``finalize(report)`` fires every watcher with it."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._watchers: List[Callable[["RunReport"], None]] = []

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, cap: int = 2048) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, cap)
        return h

    def watch(self, fn: Callable[["RunReport"], None]) -> None:
        self._watchers.append(fn)

    def report(self, *, farms: Optional[Dict[str, dict]] = None,
               queues: Optional[Dict[str, int]] = None,
               pool: Optional[dict] = None,
               meta: Optional[dict] = None) -> "RunReport":
        return RunReport(
            counters={k: c.value for k, c in self._counters.items()},
            gauges={k: g.value for k, g in self._gauges.items()},
            hists={k: h.snapshot() for k, h in self._hists.items()},
            farms=dict(farms or {}), queues=dict(queues or {}),
            pool=dict(pool or {}), meta=dict(meta or {}))

    def finalize(self, report: "RunReport") -> "RunReport":
        for fn in self._watchers:
            fn(report)
        return report


def farm_stats_snapshot(stats: Any) -> dict:
    """One ``FarmStats`` as a plain dict (the run-report wire form):
    every counter the board carries plus the latency percentiles."""
    lat = getattr(stats, "latencies", None)
    d = {
        "tasks_emitted": stats.tasks_emitted,
        "tasks_collected": stats.tasks_collected,
        "duplicates_issued": stats.duplicates_issued,
        "duplicates_dropped": stats.duplicates_dropped,
        "steals": stats.steals,
        "spills": stats.spills,
        "spill_bytes": stats.spill_bytes,
        "backpressure_stalls": stats.backpressure_stalls,
        "service_ewma": dict(stats.service_ewma),
        "worker_failures": len(stats.worker_failures),
    }
    if lat is not None and len(lat):
        vals = sorted(lat)

        def pct(p: float) -> float:
            return vals[min(len(vals) - 1, max(0, int(p / 100 * len(vals))))]

        d["latency"] = {"count": lat.count, "p50": pct(50), "p95": pct(95),
                        "p99": pct(99)}
    return d


class RunReport:
    """The single snapshot attached to every program run: registry
    metrics + absorbed ``FarmStats`` (keyed by IR-path qualname, so two
    farms never collide), queue high-water marks, spawn-pool stats, and
    free-form meta (vertex/edge topology, wall time, item count).

    ``merge`` folds another report in (counters add, gauges last-write,
    queue high-waters max) — the procs collector uses it to merge the
    per-run child telemetry, and callers can fold many runs into one
    trend point.  ``to_profile`` rebuilds an autotune ``Profile`` so
    ``Profile.diff`` compares a live run against a saved pilot — the
    online re-tuning seam."""

    schema = "run-report/1"

    def __init__(self, counters: Optional[Dict[str, int]] = None,
                 gauges: Optional[Dict[str, float]] = None,
                 hists: Optional[Dict[str, dict]] = None,
                 farms: Optional[Dict[str, dict]] = None,
                 queues: Optional[Dict[str, int]] = None,
                 pool: Optional[dict] = None,
                 meta: Optional[dict] = None):
        self.counters = dict(counters or {})
        self.gauges = dict(gauges or {})
        self.hists = dict(hists or {})
        self.farms = dict(farms or {})
        self.queues = dict(queues or {})
        self.pool = dict(pool or {})
        self.meta = dict(meta or {})

    def merge(self, other: "RunReport") -> "RunReport":
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        self.gauges.update(other.gauges)
        for k, h in other.hists.items():
            mine = self.hists.get(k)
            if mine is None:
                self.hists[k] = dict(h)
            else:
                self.hists[k] = _merge_hist_snapshots(mine, h)
        self.farms.update(other.farms)
        for k, v in other.queues.items():
            if v > self.queues.get(k, -1):
                self.queues[k] = v
        self.pool.update(other.pool)
        self.meta.update(other.meta)
        return self

    def to_json(self) -> dict:
        return {"schema": self.schema, "counters": self.counters,
                "gauges": self.gauges, "hists": self.hists,
                "farms": self.farms, "queues": self.queues,
                "pool": self.pool, "meta": self.meta}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    def to_profile(self, handoff_us: Optional[float] = None) -> Any:
        """Rebuild an autotune ``Profile`` from this report, so
        ``report.to_profile().diff(saved_profile)`` answers "has the
        live run drifted from the pilot?" — the hook online re-tuning
        hangs off.  Farm rows become farm-kind stage profiles (service
        from the worker EWMA mean, items from ``tasks_collected``,
        queue high-water from the matching dispatch lane)."""
        from .autotune import Profile, StageProfile

        stages = []
        items = 0
        for qual, fs in sorted(self.farms.items()):
            name, _, path = qual.partition("@")
            ewma = fs.get("service_ewma") or {}
            svc = (sum(ewma.values()) / len(ewma) * 1e6) if ewma else 0.0
            n = int(fs.get("tasks_collected", 0))
            items = max(items, n)
            hw = 0
            for q, v in self.queues.items():
                if q.endswith(f"@{path}") or (not path and "@" not in q):
                    hw = max(hw, v)
            stages.append(StageProfile(
                path=path, kind="farm", name=name, service_us=svc,
                service_ewma_us=svc, items=n, width=len(ewma) or 1,
                queue_high_water=hw))
        h = handoff_us if handoff_us is not None \
            else float(self.gauges.get("handoff_us", 1.0))
        return Profile(handoff_us=h, pilot_items=items, stages=stages)

    def __repr__(self) -> str:
        return (f"RunReport(counters={len(self.counters)}, "
                f"hists={sorted(self.hists)}, farms={sorted(self.farms)}, "
                f"queues={len(self.queues)})")
