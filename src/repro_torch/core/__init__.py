# The port's copy of the FastFlow streaming layer (``repro.core``): the
# lock-free SPSC ring, the lock-based baseline queue, the skeleton IR with
# its two host lowerings — threads (``graph``) and spawned processes over
# shared-memory SPSC rings (``procgraph``, ``shm``) — the keyed shuffle
# (``a2a``) with its streaming operators (``stream_ops``) and out-of-core
# folds (``oocore``), the scheduling policies and the vertex tracer.
# Plain Python: it imports neither torch nor anything of ``repro``, so a
# spawned vertex process pays neither.  The reference's mesh backend,
# autotune and live monitor belong to later slices of the port.  The SPMC
# page pool (``allocator``) backs the serving engine's batch slots, and the
# macro data-flow executor (``mdf``, paper Sec. 5) wraps the farm.
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
                       LatencyReservoir, LoweringError, Pipeline, Skeleton,
                       Source, Stage, ThreadProgram, as_skeleton, compose,
                       ff_node, fuse, lower, walk_stats)
from .graph import Accelerator, Graph, Net, Token, build
from .procgraph import (ProcAccelerator, ProcGraph, ProcProgram,
                        pool_shutdown, pool_stats)
from .a2a import stable_hash
from .stream_ops import (FOLDS, Fold, KeyedReduce, partition_by,
                         reduce_by_key, window)
from .oocore import (CombiningReader, MemoryBudget, ShardReader, SpillFold,
                     rekey_reduce, shard_reduce, shard_source)
from .farm import TaskFarm
from .allocator import PagePool, PoolExhausted
from .mdf import MDFExecutor, MDFTask

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
    "ThreadProgram",
    "Accelerator", "Graph", "Net", "Token", "build",
    "ProcAccelerator", "ProcGraph", "ProcProgram", "pool_stats",
    "pool_shutdown",
    "stable_hash",
    "FOLDS", "Fold", "KeyedReduce", "partition_by", "reduce_by_key",
    "window",
    "MemoryBudget", "SpillFold", "ShardReader", "CombiningReader",
    "shard_source", "shard_reduce", "rekey_reduce",
    "TaskFarm", "MDFExecutor", "MDFTask",
]
