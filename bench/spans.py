"""Device time under the program's ``record_function`` ranges, each kernel
counted once.

The profiler attaches a kernel to every host event that carries the id of
the operation that launched it.  When the device's launch queue is full,
CUPTI records a "Command Buffer Full" event inside that operation under
the operation's id, so the kernel hangs under both, and a walk over the
range's events counts it twice (a traced Zamba2 step at full width: about
a sixth of the kernels).  Here the kernels of one id count once.
"""
from __future__ import annotations

from typing import Optional


def span_s(trace, name: str) -> Optional[float]:
    """Device seconds of the kernels launched under the outermost ranges
    ``name`` of ``trace`` (a ``bench.trace.Trace``), each host event id's
    kernels once, or None where no such range ran."""
    found, by_id = False, {}
    for ev in trace._cpu:
        if ev.name != name:
            continue
        found = True
        up = ev.cpu_parent
        while up is not None and up.name != name:
            up = up.cpu_parent
        if up is not None:
            continue
        todo = [ev]
        while todo:
            e = todo.pop()
            if e.kernels:
                by_id.setdefault(e.id, sum(k.duration for k in e.kernels))
            todo.extend(e.cpu_children)
    return sum(by_id.values()) / 1e6 if found else None
