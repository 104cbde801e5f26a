# The port's copy of the FastFlow streaming layer (``repro.core``), cut to
# the host threads backend that the Smith-Waterman search runs on: the
# lock-free SPSC ring, the lock-based baseline queue, the skeleton IR with
# its threads lowering, the scheduling policies and the vertex tracer.
# Plain Python: it imports neither torch nor anything of ``repro``.  The
# reference's procs, mesh and all-to-all backends, out-of-core folds,
# autotune and live monitor belong to later slices of the port.
from .spsc import EOS, Backoff, SPSCQueue
from .lockq import LockQueue
from .sched import (SCHEDULERS, CostModel, OnDemand, RoundRobin, Scheduler,
                    WorkStealing, calibrate_handoff_us, clear_handoff_cache,
                    make_scheduler, spread_cpus)
from .obs import (Counter, Gauge, Histogram, MetricsRegistry, Trace, Tracer,
                  VertexTracer, farm_stats_snapshot)
from .skeleton import (BACKENDS, GO_ON, AllToAll, EmitMany, Farm, FarmStats,
                       Feedback, FnNode, FusedNode, KeyBatch,
                       LatencyReservoir, LoweringError, Pipeline, Skeleton,
                       Source, Stage, ThreadProgram, as_skeleton, compose,
                       ff_node, fuse, lower, walk_stats)
from .graph import Accelerator, Graph, Net, Token, build
from .farm import TaskFarm

__all__ = [
    "EOS", "Backoff", "SPSCQueue", "LockQueue",
    "SCHEDULERS", "Scheduler", "RoundRobin", "OnDemand", "WorkStealing",
    "CostModel", "make_scheduler", "calibrate_handoff_us",
    "clear_handoff_cache", "spread_cpus",
    "Tracer", "VertexTracer", "Trace", "MetricsRegistry", "Counter", "Gauge",
    "Histogram", "farm_stats_snapshot",
    "BACKENDS", "GO_ON", "EmitMany", "KeyBatch", "ff_node", "FnNode",
    "FusedNode", "FarmStats", "LatencyReservoir", "Skeleton", "Stage",
    "Source", "Pipeline", "Farm", "Feedback", "AllToAll", "compose",
    "as_skeleton", "fuse", "walk_stats", "LoweringError", "lower",
    "ThreadProgram",
    "Accelerator", "Graph", "Net", "Token", "build",
    "TaskFarm",
]
