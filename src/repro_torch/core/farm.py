"""The farm skeleton (paper Sec. 3.1, Figs. 1-2), host-thread flavour.

Topology (all edges are lock-free SPSC rings — never a shared MPMC):

    Emitter --spsc--> Worker_0 --spsc--\
            --spsc--> Worker_1 --spsc---> Collector
            --spsc--> ...      --spsc--/

As of the skeleton-IR redesign this module is a thin facade twice over:
``TaskFarm`` is the seed's original API bound to a one-farm
:class:`repro_torch.core.skeleton.Farm` IR node lowered on the threads backend
(:mod:`.graph`), where the Emitter and Collector arbiters, tagged-token
ordering, straggler re-issue and the EOS protocol live as reusable
machinery shared by every skeleton.  New code should build the declarative
IR directly — ``skeleton.Farm`` / ``Pipeline`` / ``compose`` — and pick a
runtime with ``lower(skel, backend="threads")`` (the port's only
backend so far).

Features reproduced from the paper:
  * ``ff_node`` API with ``svc`` / ``svc_init`` / ``svc_end`` (Fig. 2);
  * round-robin and on-demand (shortest-queue) scheduling policies;
  * optional **order-preserving** farm via tagged tokens (Fig. 1, right) —
    the collector reorders by tag, as in tagged-token macro data-flow;
  * EOS protocol: emitter returning ``None`` ends the stream.

Beyond-paper (scale features required for a production runtime):
  * **straggler mitigation** — the emitter speculatively re-issues tasks
    whose age exceeds ``straggler_factor × p95`` of completed latencies; the
    collector deduplicates by tag, so duplicates are harmless (exactly-once
    delivery at the collector).
  * **worker-failure tolerance** — a worker thread that dies mid-task simply
    stops draining its queue; its outstanding tags age out and are re-issued
    to live workers by the same speculation path.

The queue class is pluggable (``SPSCQueue`` vs ``LockQueue``) so the
benchmarks can compare the paper's design against the lock-based baseline
over an otherwise identical farm.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence, Type

from .graph import Graph, WorkerVertex
from .sched import make_scheduler
from .skeleton import (Farm, FarmStats, FnNode, _coerce_tracer, _SeqNode,
                       ff_node)
from .spsc import SPSCQueue

__all__ = ["ff_node", "FnNode", "TaskFarm", "FarmStats"]


class TaskFarm:
    """Emitter → N workers → Collector over SPSC rings (graph-backed).

    Parameters
    ----------
    nworkers: worker-pool width.
    queue_class: ``SPSCQueue`` (paper) or ``LockQueue`` (baseline).
    capacity: per-ring capacity.
    preserve_order: emit collector output in emission (tag) order.
    scheduling: policy name (``"rr"`` | ``"ondemand"`` | ``"worksteal"`` |
        ``"costmodel"``) or a ``repro_torch.core.sched.Scheduler``.
    speculative: enable straggler re-dispatch.
    straggler_factor: age threshold multiplier over p95 latency.
    trace: ``True`` or an :class:`~repro_torch.core.obs.Tracer`: every
        vertex records into its lane (the lanes of earlier runs of the
        same Tracer), each worker's first task of a run and 1 in
        ``sample`` after it as ``svc`` spans with ``{"run", "tag"}``, and
        each run one ``run`` span on the ``ff-farm`` lane, from ``run()``
        to ``wait()``'s return, with ``{"run", "tasks", "first_svc"}``
        (the first task's start).  ``None`` (the default): no clock read
        and no allocation in the farm.
    """

    def __init__(
        self,
        nworkers: int,
        *,
        queue_class: Type = SPSCQueue,
        capacity: int = 512,
        preserve_order: bool = False,
        scheduling: Any = "rr",
        speculative: bool = False,
        straggler_factor: float = 4.0,
        min_straggler_age: float = 0.05,
        trace: Any = None,
    ):
        assert nworkers >= 1
        make_scheduler(scheduling)  # raises ValueError on an unknown policy
        self.nworkers = nworkers
        self.queue_class = queue_class
        self.capacity = capacity
        self.preserve_order = preserve_order
        self.scheduling = scheduling
        self.speculative = speculative
        self.straggler_factor = straggler_factor
        self.min_straggler_age = min_straggler_age
        self._emitter: Optional[ff_node] = None
        self._workers: List[ff_node] = []
        self._collector: Optional[ff_node] = None
        self._graph: Optional[Graph] = None
        self.results: List[Any] = []
        self.stats = FarmStats()
        self.tracer = _coerce_tracer(trace)
        self._t_run = 0.0
        self._emitted = 0

    # -- wiring (paper Fig. 2 API) -----------------------------------------
    def add_emitter(self, node: ff_node) -> "TaskFarm":
        self._emitter = node
        return self

    def add_worker(self, node: ff_node) -> "TaskFarm":
        self._workers.append(node)
        return self

    def add_collector(self, node: ff_node) -> "TaskFarm":
        self._collector = node
        return self

    def add_stream(self, items: Sequence[Any]) -> "TaskFarm":
        """Convenience: emitter that replays a finite sequence."""
        return self.add_emitter(_SeqNode(items))

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> "TaskFarm":
        if self.tracer is not None:
            self._t_run = time.monotonic()
            self._emitted = self.stats.tasks_emitted
        assert self._emitter is not None, "farm needs an emitter"
        if len(self._workers) == 1 and self.nworkers > 1:
            self._workers = self._workers * self.nworkers
        assert len(self._workers) == self.nworkers
        net = Farm(
            list(self._workers),
            emitter=self._emitter,
            collector=self._collector,
            ordered=self.preserve_order,
            scheduling=self.scheduling,
            speculative=self.speculative,
            straggler_factor=self.straggler_factor,
            min_straggler_age=self.min_straggler_age,
            stats=self.stats,
        )
        self._graph = net.to_graph(queue_class=self.queue_class,
                                   capacity=self.capacity)
        self._graph.results = self.results  # alias the pre-exposed sink
        self._graph.tracer = self.tracer
        self._graph.run()
        return self

    def wait(self, timeout: Optional[float] = None) -> List[Any]:
        assert self._graph is not None, "call run() first"
        out = self._graph.wait(timeout)
        if self.tracer is not None:
            g = self._graph
            firsts = [v.t_first for v in g.vertices
                      if isinstance(v, WorkerVertex) and v.t_first]
            self.tracer.vertex("ff-farm").span(
                "run", self._t_run, time.monotonic(),
                {"run": g.run_id,
                 "tasks": self.stats.tasks_emitted - self._emitted,
                 "first_svc": min(firsts) if firsts else None})
        return out

    def run_and_wait(self) -> List[Any]:
        return self.run().wait()
