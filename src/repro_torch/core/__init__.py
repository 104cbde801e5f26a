# The port's copy of the FastFlow streaming layer (``repro.core``): the
# lock-free SPSC ring, the lock-based baseline queue, the skeleton IR with
# its three lowerings — threads (``graph``), spawned processes over
# shared-memory SPSC rings (``procgraph``, ``shm``) and one device program
# (``"mesh"``: ``MeshProgram``, ``A2AMeshProgram``, over ``dfarm``) — the
# keyed shuffle (``a2a``) with its streaming operators (``stream_ops``)
# and out-of-core folds (``oocore``), the self-tuning compile
# (``autotune``), the live monitor (``monitor``), the scheduling policies
# and the vertex tracer.  Plain Python: it imports neither torch nor
# anything of ``repro``, so a spawned vertex process pays neither.  The
# device farm (``dfarm``, torch) and the monitor are resolved on first
# touch (PEP 562), so ``monitor=None`` programs never import the monitor.
# The SPMC page pool (``allocator``) backs the serving engine's batch
# slots, and the macro data-flow executor (``mdf``, paper Sec. 5) wraps
# the farm.
from .spsc import EOS, Backoff, SPSCQueue
from .lockq import LockQueue
from .shm import ShmCounters, ShmFlag, ShmRing
from .sched import (SCHEDULERS, BudgetBackpressure, CostModel, KeyAffinity,
                    OnDemand, RoundRobin, Scheduler, WorkStealing,
                    calibrate_handoff_us, clear_handoff_cache, make_scheduler,
                    spread_cpus)
from .obs import (Counter, Gauge, Histogram, MetricsRegistry, RunReport,
                  Trace, Tracer, VertexTracer, farm_stats_snapshot)
from .skeleton import (BACKENDS, GO_ON, AllToAll, EmitMany, Farm, FarmStats,
                       Feedback, FnNode, FusedNode, KeyBatch,
                       LatencyReservoir, LoweringError, MeshProgram, Pipeline,
                       Skeleton, Source, Stage, ThreadProgram, as_skeleton,
                       compose, ff_node, fuse, lower, walk_stats)
from .graph import Accelerator, Graph, Net, Token, build
from .procgraph import (ProcAccelerator, ProcGraph, ProcProgram,
                        pool_shutdown, pool_stats)
from .a2a import A2AMeshProgram, stable_hash
from .stream_ops import (FOLDS, Fold, KeyedReduce, partition_by,
                         reduce_by_key, window)
from .oocore import (CombiningReader, MemoryBudget, ShardReader, SpillFold,
                     rekey_reduce, shard_reduce, shard_source)
from .autotune import (Profile, StageProfile, TunedProgram, auto_batch,
                       plan_mesh, profile, retune, ring_capacity)
from .farm import TaskFarm
from .allocator import PagePool, PoolExhausted
from .mdf import MDFExecutor, MDFTask

# names resolved on first touch (see the comment at the top)
_LAZY = {
    "BottleneckReport": ".monitor", "DriftWatcher": ".monitor",
    "Monitor": ".monitor", "SLOMonitor": ".monitor", "Timeline": ".monitor",
    "analyze": ".monitor",
    "combine": ".dfarm", "dispatch": ".dfarm", "farm_map": ".dfarm",
    "farm_until": ".dfarm", "roundrobin_dest": ".dfarm",
    "best_factorization": ".dpipeline",
    "negotiate_stage_axis": ".dpipeline", "pipeline_apply": ".dpipeline",
    "pipeline_utilisation": ".dpipeline",
}

__all__ = [
    "EOS", "Backoff", "SPSCQueue", "LockQueue", "ShmRing", "ShmCounters",
    "ShmFlag",
    "SCHEDULERS", "Scheduler", "RoundRobin", "OnDemand", "WorkStealing",
    "CostModel", "KeyAffinity", "BudgetBackpressure", "make_scheduler",
    "calibrate_handoff_us", "clear_handoff_cache", "spread_cpus",
    "Tracer", "VertexTracer", "Trace", "MetricsRegistry", "Counter", "Gauge",
    "Histogram", "farm_stats_snapshot", "RunReport", "PagePool",
    "PoolExhausted",
    "BACKENDS", "GO_ON", "EmitMany", "KeyBatch", "ff_node", "FnNode",
    "FusedNode", "FarmStats", "LatencyReservoir", "Skeleton", "Stage",
    "Source", "Pipeline", "Farm", "Feedback", "AllToAll", "compose",
    "as_skeleton", "fuse", "walk_stats", "LoweringError", "lower",
    "ThreadProgram", "MeshProgram",
    "Accelerator", "Graph", "Net", "Token", "build",
    "ProcAccelerator", "ProcGraph", "ProcProgram", "pool_stats",
    "pool_shutdown",
    "stable_hash", "A2AMeshProgram",
    "FOLDS", "Fold", "KeyedReduce", "partition_by", "reduce_by_key",
    "window",
    "MemoryBudget", "SpillFold", "ShardReader", "CombiningReader",
    "shard_source", "shard_reduce", "rekey_reduce",
    "Profile", "StageProfile", "TunedProgram", "profile", "retune",
    "plan_mesh", "auto_batch", "ring_capacity",
    "TaskFarm", "MDFExecutor", "MDFTask",
] + sorted(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target, __name__), name)
    globals()[name] = value  # cache: next access skips this hook
    return value
