"""Pipeline skeleton on a mesh axis — the planning half.

FastFlow's pipeline is a chain of nodes connected by SPSC queues.  On a
mesh each *stage* is a device group along the ``stage`` axis and each edge
a collective-permute; microbatches stream through the chain, and with S
stages and M microbatches the utilisation is M / (M + S - 1).

The port's copy of ``repro.core.dpipeline``: the pure helpers, which the
mesh lowering (:class:`~repro_torch.core.skeleton.MeshProgram`) and the
autotuner's planner (:func:`~repro_torch.core.autotune.plan_mesh`) read,
and :func:`pipeline_apply`, which streams microbatches between the rank
processes of a stage group.  This module stays plain Python: the tensor
body of :func:`pipeline_apply` lives in :mod:`.dchannel`, imported when
it is first called.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["pipeline_apply", "pipeline_utilisation", "negotiate_stage_axis",
           "best_factorization"]


def pipeline_utilisation(n_stages: int, n_micro: int) -> float:
    return n_micro / (n_micro + n_stages - 1)


def best_factorization(n_stages: int, n_devices: int,
                       stage_costs=None, n_micro=None):
    """Pick the ``(stage, worker)`` mesh factorization with the higher
    modelled throughput — the autotuner's mesh counterpart of auto-grain.

    Only two factorizations are expressible (the pipelined schedule
    requires the stage axis to equal the stage count): ``(1, n_devices)``
    runs the stage chain sequentially inside one program with all devices
    on the worker axis; ``(n_stages, n_devices / n_stages)`` streams
    microbatches through the chain.  With measured per-stage costs (µs,
    e.g. from an autotune pilot) the model scores sequential as
    ``n_devices / sum(costs)`` and pipelined as ``workers *
    pipeline_utilisation(S, M) / max(costs)`` — the pipeline clocks at its
    slowest stage but overlaps stages, minus the fill/drain bubble.
    Returns the winning ``(n_stage, n_worker)``."""
    seq = (1, max(1, n_devices))
    if n_stages <= 1 or n_devices < n_stages or n_devices % n_stages:
        return seq
    piped = (n_stages, n_devices // n_stages)
    costs = list(stage_costs) if stage_costs else [1.0] * n_stages
    if len(costs) != n_stages or min(costs) <= 0:
        costs = [1.0] * n_stages
    m = n_micro if n_micro and n_micro > 0 else 4 * n_stages
    seq_score = n_devices / sum(costs)
    piped_score = (piped[1] * pipeline_utilisation(n_stages, m)
                   / max(costs))
    return piped if piped_score > seq_score else seq


def negotiate_stage_axis(n_stages: int, n_devices: int):
    """Factor ``n_devices`` into a ``(stage, worker)`` mesh for a skeleton
    with ``n_stages`` pipeline stages.

    When the device count divides evenly, each stage owns a row of
    ``n_devices / n_stages`` workers and microbatches stream through the
    stages; otherwise the stage axis collapses to 1 and the stage chain
    runs sequentially inside the same program (still one program — the
    stages are fused, not round-tripped through the host)."""
    if n_stages > 1 and n_devices >= n_stages and n_devices % n_stages == 0:
        return n_stages, n_devices // n_stages
    return 1, max(1, n_devices)


def pipeline_apply(stage_fn: Callable[[Any, Any], Any], stage_params: Any,
                   microbatches: Any, *, group: Any,
                   collect: str = "psum") -> Any:
    """Stream ``microbatches`` through the stage chain.

    Must be called inside a rank job, with ``group`` the stage
    :class:`~repro_torch.core.ranks.Group` (the reference's ``axis_name``)
    and ``stage_params`` this rank's own stage's parameters.

    Args:
      stage_fn: ``y = stage_fn(params_local, x)`` — one stage's compute.
      stage_params: this stage's parameter shard.
      microbatches: ``(M, mb, ...)`` tensor, the same on every stage;
        stage 0 reads microbatch t at tick t, later stages ignore it and
        consume their inbound SPSC slot (a ``chain_send`` edge) instead.
      collect: ``"psum"`` (default) sums the last stage's emit over the
        stage group (inactive stages contribute zeros), so every stage
        holds the result; ``"local"`` returns each stage's raw emit.

    Returns ``(M, mb, ...)``: the outputs of the last stage in microbatch
    order.  Differentiable: the edges send the cotangent back up the
    chain, and the ``psum`` passes it through as the transpose of the
    reference's replicated output does.  Without grad mode a stage skips
    its inactive ticks (every rank of a stage row skips alike)."""
    if collect not in ("psum", "local"):
        raise ValueError(f"collect must be 'psum' or 'local', got {collect!r}")
    from .dchannel import _pipeline
    return _pipeline(stage_fn, stage_params, microbatches, group, collect)
