"""Macro data-flow executor over the farm (paper Sec. 5).

The port's copy of ``repro.core.mdf``.  The paper closes by proposing
FastFlow as "a fast macro data-flow executor (actually wrapping around the
order preserving farm) ... including dynamic programming".  This module is
that executor, a facade over the skeleton IR's wrap-around machinery
(:class:`Farm` with ``feedback=``, lowered on the threads backend):
completed-task events flow from the merge arbiter back to the dispatch
arbiter over the wrap-around SPSC ring, so the network is cyclic.

    Emitter (releases ready tasks) ──> Workers ──> Collector
        ^                                              │
        └────────── wrap-around SPSC (graph.py) ───────┘

Tasks whose dependencies are all satisfied are fed in as the initial
stream; each completion releases its newly ready successors back around
the loop.  Termination is the graph layer's loop-quiescence protocol (no
tokens in flight, wrap-around ring drained): no task counting here.

Blocked Smith-Waterman as a wavefront dynamic program is the workload
class the paper names; ``tests/test_torch_mdf.py`` runs one.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence, Tuple

from .skeleton import Farm, FnNode, Pipeline, Source

__all__ = ["MDFTask", "MDFExecutor"]


@dataclass
class MDFTask:
    tag: Any
    fn: Callable[..., Any]
    deps: Tuple[Any, ...] = ()
    extra_args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)


class MDFExecutor:
    """Execute a static task DAG with tagged-token matching.  ``fn`` of a
    task is called with its dependencies' results, in ``deps`` order,
    followed by ``extra_args`` and ``kwargs``."""

    def __init__(self, nworkers: int = 4, capacity: int = 1024):
        self.nworkers = nworkers
        self.capacity = capacity
        self.results: Dict[Any, Any] = {}

    def run(self, tasks: Sequence[MDFTask]) -> Dict[Any, Any]:
        by_tag = {t.tag: t for t in tasks}
        if len(by_tag) != len(tasks):
            raise ValueError("duplicate tags")
        indeg = {t.tag: len(t.deps) for t in tasks}
        succs: Dict[Any, List[Any]] = {t.tag: [] for t in tasks}
        for t in tasks:
            for d in t.deps:
                if d not in by_tag:
                    raise ValueError(f"unknown dep {d!r} of {t.tag!r}")
                succs[d].append(t.tag)

        results = self.results
        total = len(tasks)

        def work(task: MDFTask) -> Tuple[Any, Any]:
            # dep results were stored by the collector BEFORE the task was
            # released around the loop, so these reads are safe
            args = tuple(results[d] for d in task.deps) + tuple(task.extra_args)
            return (task.tag, task.fn(*args, **task.kwargs))

        def release(item: Tuple[Any, Any]):
            tag, value = item
            results[tag] = value              # store BEFORE releasing successors
            ready = []
            for s in succs[tag]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(by_tag[s])
            return None, ready                # nothing leaves the loop early

        initial = [by_tag[t] for t, d in indeg.items() if d == 0]
        farm = Farm(FnNode(work), self.nworkers, feedback=release,
                    feedback_capacity=max(self.capacity, total + 1))
        Pipeline(Source(initial), farm).run_and_wait(capacity=self.capacity)
        if len(results) != total:
            raise RuntimeError(f"deadlock or lost tokens: {len(results)}/{total}")
        return results
