"""The traced run's reading: ``torch.profiler`` over the runner's traced
window, reduced to what the per-layer metrics read.

``Tracer.start()``/``stop()`` bracket the traced window; ``result()``
gives a :class:`Trace`: the device's kernels (name, start, end), the
program's ``record_function`` ranges with the device time of the kernels
launched under each, the window's length on the host clock, and the
runner's counters (work done in the window, counted from its inputs).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

BREAKDOWN_ROWS = 10


class NoTracer:
    """The untraced run's tracer: does nothing."""

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class Tracer:
    def __init__(self, device) -> None:
        self.device = device
        self._prof = None
        self._t0 = self._t1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def result(self, counters: Dict[str, Any]) -> "Trace":
        if self._prof is None:
            raise RuntimeError("the runner never started the tracer")
        return Trace.from_profile(self._prof, self._t1 - self._t0, counters)


def _kernels_under(ev):
    """(name, us) of every kernel launched inside a profiled CPU range."""
    for k in ev.kernels:
        yield k.name, k.duration
    for ch in ev.cpu_children:
        yield from _kernels_under(ch)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """The reduced trace.  Times in seconds; the profiler's clock in µs."""

    def __init__(self, kernels, cpu_events, window_s, counters):
        self.kernels: List[Tuple[str, float, float]] = kernels   # name, start µs, end µs
        self._cpu = cpu_events                    # the profiler's host events
        self.window_s: float = window_s
        self.counters: Dict[str, Any] = counters
        self._busy = _union([(a, b) for _, a, b in kernels])
        self.busy_s: float = sum(b - a for a, b in self._busy) / 1e6

    @classmethod
    def from_profile(cls, prof, window_s: float, counters: Dict[str, Any]) -> "Trace":
        from torch.autograd import DeviceType
        events = prof.events()
        cpu = [ev for ev in events if ev.device_type == DeviceType.CPU]
        # the device mirrors each record_function range as an annotation
        # under the range's name: that is no kernel
        host_names = {ev.name for ev in cpu}
        kernels = [(ev.name, ev.time_range.start, ev.time_range.end)
                   for ev in events if ev.device_type == DeviceType.CUDA
                   and ev.name not in host_names]
        return cls(kernels, cpu, window_s, counters)

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the kernels whose name ``match``es."""
        return sum(b - a for n, a, b in self.kernels if match(n)) / 1e6

    def span_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched under the program's
        ``record_function(name)`` ranges (the outermost of nested ones), or
        None where no such range ran."""
        found, total = False, 0.0
        for ev in self._cpu:
            if ev.name != name:
                continue
            found = True
            up = ev.cpu_parent
            while up is not None and up.name != name:
                up = up.cpu_parent
            if up is None:
                total += sum(us for _, us in _kernels_under(ev)) / 1e6
        return total if found else None

    def idle_pct(self) -> Optional[float]:
        """The share of the traced window in which no kernel ran, in %, or
        None where the trace holds no kernel."""
        if not self.busy_s:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        """The device operations that took most time, and the longest idle
        gaps of the device named by the host operation that was running
        (the innermost one) where each began."""
        by_op: Dict[str, float] = defaultdict(float)
        for n, a, b in self.kernels:
            by_op[n] += (b - a) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]
        gaps = sorted(((nxt - end, end) for (_, end), (nxt, _) in
                       zip(self._busy, self._busy[1:])), reverse=True)[:200]
        starts = sorted((ev.time_range.start, -ev.time_range.end, ev.name)
                        for ev in self._cpu)
        keys = [s[0] for s in starts]
        by_host: Dict[str, float] = defaultdict(float)
        # the innermost host operation open at the gap's start, looked for
        # among the last few thousand that began before it
        for width, at in gaps:
            name, best = "no host operation", None
            for a, nb, n in starts[max(0, bisect.bisect_right(keys, at) - 4000):
                                   bisect.bisect_right(keys, at)]:
                if -nb >= at and (best is None or -nb - a < best):
                    name, best = n, -nb - a
            by_host[name] += width / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}
