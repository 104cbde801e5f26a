"""Unified runtime observability — vertex tracing and metrics.

FastFlow's whole argument (TR-09-12) lives at the microsecond scale: a
farm hand-off costs a few hundred nanoseconds, so any instrumentation
that costs more than a few of those when idle destroys the property
being measured.  This module is the one observability substrate every
lowering shares, built around that constraint:

:class:`Tracer` / :class:`VertexTracer`
    Typed span/instant events (``svc`` begin/end, ``stall`` push-waits,
    ``steal``, ``spill``, ``eos``, ``loop`` tokens) recorded into
    bounded per-vertex buffers.  Spans are sampled 1-in-N with the same
    mask trick the ordered-farm latency sampling uses (``n & mask``), so
    the hot path pays ~two clock reads on a sampled-in event, one
    counter increment otherwise — and **nothing at all** when tracing is
    off, because vertices then carry ``tracer = None`` and never enter
    this module (pinned by the tracer-off allocation test).  Every
    buffer has one writer — its vertex — so the single-writer discipline
    of the runtime survives; procs vertices ship their buffers back over
    the existing control-ring machinery at EOS, and the clock is
    ``time.monotonic()`` (CLOCK_MONOTONIC — system-wide on Linux), so
    lanes from different processes share one timeline.

:class:`Trace`
    The merged snapshot: one lane per vertex (qualified by IR path, so
    two same-named stages cannot collide), exported via
    :meth:`Trace.to_chrome_json` in Chrome trace-event format — any run
    opens in Perfetto / ``chrome://tracing`` with one named lane per
    vertex/process.

:class:`MetricsRegistry`
    Counters, gauges and reservoir histograms (p50/p95/p99), plus
    :func:`farm_stats_snapshot`, the plain-dict form of a ``FarmStats``.
    The reference's ``RunReport`` (one snapshot per program run, merged
    across runs) belongs to a later slice of this port.

Everything here is stdlib-only: no torch, no numpy.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Tracer", "VertexTracer", "Trace", "MetricsRegistry", "Counter",
    "Gauge", "Histogram", "qualname", "farm_stats_snapshot",
]

#: event-kind vocabulary (the typed part of "typed events"); spans and
#: instants share one namespace so a lane reads as one story
SPAN_KINDS = ("svc", "stall", "compile", "call", "life")
INSTANT_KINDS = ("steal", "spill", "eos", "loop", "devices",
                 "alert", "drift")

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
    the procs EOS ship-back.
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

    def end(self, t0: float, kind: str) -> None:
        """Close the span opened by the matching :meth:`begin`."""
        if not t0:
            return
        if len(self.events) < self.capacity:
            self.events.append((kind, t0, _monotonic()))
        else:
            self.dropped += 1

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
    path."""

    def __init__(self, *, sample: int = 16, capacity: int = 2048):
        self.sample = _pow2(sample)
        self.capacity = int(capacity)
        self._lanes: List[VertexTracer] = []

    def vertex(self, name: str, path: str = "") -> VertexTracer:
        vt = VertexTracer(name, path, sample=self.sample,
                          capacity=self.capacity)
        self._lanes.append(vt)
        return vt

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


class MetricsRegistry:
    """Named counters/gauges/histograms.

    One registry per program (or shared across programs — names are the
    namespace)."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

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
