"""The port's procs backend (``repro_torch.core.procgraph``): spawned vertex
processes over shared-memory SPSC rings.  Each case lowers one skeleton in
both packages, the port's on ``"procs"`` and the reference's on
``"threads"`` (the reference's own tests hold its procs backend to its
threads backend), and the outputs must be equal: ordered output, GO_ON
filtering, emitter/collector nodes, feedback loops, every scheduling
policy, the accelerator, pooled and direct spawns, batched emit; then the
failure semantics (a raising worker fails the run, a hung child hits the
timeout), the run report and live monitor (``metrics=``, ``monitor=``),
a mesh over two devices that stays refused, tracing, tensors through a farm,
and no leaked ``/dev/shm`` segment.  One case per behaviour: every run
spawns processes.  Plain nodes come from ``tests/_procs_nodes.py``, nodes
that return the port's sentinels or take tensors from
``tests/_torch_procs_nodes.py``."""
import glob
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import _procs_nodes as N
import _torch_procs_nodes as T
import repro.core as jcore
import repro_torch.core as tcore
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import (Farm, Feedback, LoweringError, Pipeline,
                              ProcAccelerator, ProcProgram, Source, Stage,
                              lower, pool_shutdown, pool_stats)
from repro_torch.core.shm import SEG_PREFIX


def _segments():
    return set(glob.glob(f"/dev/shm/{SEG_PREFIX}{os.getpid()}_*"))


@pytest.fixture(autouse=True)
def no_leaked_segments():
    """Every test unlinks every segment this process made."""
    before = _segments()
    yield
    assert _segments() - before == set(), "leaked SharedMemory segments"


@pytest.fixture(autouse=True, scope="module")
def retire_pool():
    yield
    pool_shutdown()


def _ref(build, xs):
    """The reference's threads output for the same skeleton."""
    return jcore.lower(build(jcore), "threads")(xs)


def test_lower_returns_proc_program():
    prog = lower(Farm(N.f, 2), "procs")
    assert isinstance(prog, ProcProgram) and prog.backend == "procs"
    assert tcore.BACKENDS["procs"] is ProcProgram


def test_ordered_farm_matches_reference():
    xs = list(range(60))
    build = lambda c: c.Farm(N.f, 2, ordered=True)  # noqa: E731
    assert lower(build(tcore), "procs")(xs) == _ref(build, xs) \
        == [N.f(x) for x in xs]


def test_unordered_farm_is_a_permutation():
    xs = list(range(40))
    out = lower(Farm(N.f, 2), "procs")(xs)
    assert sorted(out) == sorted(_ref(lambda c: c.Farm(N.f, 2), xs))


def test_pipeline_of_farms_and_stage_matches_reference():
    xs = list(range(-15, 15))
    build = lambda c: c.Pipeline(c.Farm(N.f, 2, ordered=True),  # noqa: E731
                                 c.Farm(N.g, 2, ordered=True), c.Stage(N.sq))
    assert lower(build(tcore), "procs")(xs) == _ref(build, xs) \
        == [N.sq(N.g(N.f(x))) for x in xs]


PIPE = Pipeline(Farm(N.f, 4, ordered=True), Farm(N.g, 4, ordered=True))
PIPE_P = lower(PIPE, "procs")
PIPE_J = jcore.lower(jcore.Pipeline(jcore.Farm(N.f, 4, ordered=True),
                                    jcore.Farm(N.g, 4, ordered=True)),
                     "threads")


# Few examples: each one spawns a 13-vertex process network.
@given(st.lists(st.integers(-1000, 1000), max_size=16))
@settings(max_examples=3, deadline=None)
def test_parity_procs_pipeline_of_farms(xs):
    assert PIPE_P(xs) == PIPE_J(xs) == [N.g(N.f(x)) for x in xs]


def test_go_on_filters_and_terminates():
    out = lower(Farm(T.drop_odd, 2, ordered=True), "procs")(range(20))
    assert out == [x for x in range(20) if x % 2 == 0]


def test_emitter_and_collector_nodes_run_in_arbiters():
    build = lambda c: c.Farm(N.f, 2, ordered=True,  # noqa: E731
                             emitter=N.AddTagEmitter(),
                             collector=N.NegateCollector())
    assert lower(build(tcore), "procs")(range(10)) == _ref(build, range(10)) \
        == [-N.f(x + 100) for x in range(10)]


def test_empty_stream_spawns_nothing():
    before = pool_stats()
    assert lower(Farm(N.f, 2, ordered=True), "procs")([]) == []
    assert pool_stats() == before


@pytest.mark.parametrize("policy", ["rr", "ondemand", "worksteal",
                                    "costmodel"])
def test_scheduling_policies_preserve_ordered_output(policy):
    xs = list(range(48))
    skel = Farm(N.f, 3, ordered=True, scheduling=policy)
    assert lower(skel, "procs")(xs) == [N.f(x) for x in xs]
    st = skel.stats
    assert st.tasks_emitted == st.tasks_collected == len(xs)
    assert sum(st.per_worker.values()) == len(xs)
    if policy == "costmodel":
        assert st.service_ewma  # the workers' EWMAs crossed back over rings


def test_feedback_loop_and_max_trips_match_reference():
    xs = list(range(0, 30, 3))
    for trips in (None, 1):
        build = lambda c: c.Feedback(N.fb_step, N.fb_pred,  # noqa: E731
                                     nworkers=2, max_trips=trips)
        assert lower(build(tcore), "procs")(xs) == _ref(build, xs)
    assert _ref(build, xs) == [N.fb_step(x) for x in xs]


def test_oversized_payloads_stream_through_the_farm():
    xs = list(range(12))
    out = lower(Farm(N.big_payload, 2, ordered=True), "procs",
                slot_size=64)(xs)
    assert out == [N.big_payload(x) for x in xs]


# -- failure semantics --------------------------------------------------------
def test_worker_exception_propagates_and_cleans_up():
    with pytest.raises(ValueError, match="boom at 7"):
        lower(Farm(N.boom_on_seven, 2, ordered=True), "procs")(range(20))


def test_hung_child_hits_the_run_timeout():
    with pytest.raises(TimeoutError, match="procs graph"):
        lower(Farm(N.sleepy, 2), "procs", timeout=3.0)(range(4))


def test_unpicklable_node_is_a_lowering_error():
    with pytest.raises(LoweringError, match="picklable"):
        lower(Farm(lambda x: x, 2), "procs")([1, 2, 3])


def test_speculative_is_threads_only():
    with pytest.raises(LoweringError, match="threads-only"):
        lower(Farm(N.f, 2, speculative=True), "procs")([1])


@pytest.mark.parametrize("opt", ["metrics", "monitor"])
def test_run_report_and_monitor_on_procs(opt):
    """metrics= merges the children's telemetry into one RunReport whose
    farm rows and meta equal the threads backend's; monitor= samples the
    live counter boards, monotone up to the stream's length."""
    xs = list(range(50))
    want = [N.g(N.f(x)) for x in xs]
    build = lambda: Pipeline(Farm(N.f, 2, ordered=True),  # noqa: E731
                             Farm(N.g, 2, ordered=True))
    prog = lower(build(), "procs", **{opt: True})
    assert prog(xs) == want
    if opt == "metrics":
        rep, trep = prog.last_report, None
        threads = lower(build(), "threads", metrics=True)
        assert threads(xs) == want
        trep = threads.last_report
        assert sorted(rep.farms) == sorted(trep.farms) == \
            ["ff-farm@0", "ff-farm@1"]
        for q in rep.farms:
            assert rep.farms[q]["tasks_collected"] == \
                trep.farms[q]["tasks_collected"] == len(xs)
        assert rep.meta["items_out"] == trep.meta["items_out"] == len(xs)
        assert rep.meta["backend"] == "procs" and rep.queues
    else:
        tl = prog.monitor.timeline
        assert prog.monitor.errors == 0 and tl.frames()
        for key in ("items_out", "ff-farm@0.emitted", "ff-farm@1.collected"):
            vals = [f["counters"][key] for f in tl.frames()
                    if key in f["counters"]]
            assert vals == sorted(vals) and vals[-1] == len(xs), (key, vals)


def test_mesh_over_two_cpu_ranks_needs_gloo():
    """The mesh program over two devices runs in rank processes, and on
    the CPU it needs the transport named (tests/test_torch_mesh_ranks.py)."""
    with pytest.raises(LoweringError, match='transport="gloo"'):
        lower(Farm(N.f, 2), "mesh", device="cpu", devices=2)


# -- the self-offloading accelerator ------------------------------------------
def test_accelerator_caller_side_farm():
    skel = Farm(N.sq, 2, ordered=True)
    acc = ProcAccelerator(skel)
    assert acc._farm is not None  # caller-side arbitration engaged
    for x in range(40):
        acc.offload(x)
    assert acc.wait(60) == [N.sq(x) for x in range(40)]
    st = skel.stats
    assert st.tasks_emitted == st.tasks_collected == 40


@pytest.mark.parametrize("shape", ["worksteal", "composition"])
def test_accelerator_falls_back_to_the_graph(shape):
    skel = (Farm(N.sq, 2, ordered=True, scheduling="worksteal")
            if shape == "worksteal"
            else Farm(N.f, 2, ordered=True) >> Stage(N.g))
    acc = ProcAccelerator(skel)
    assert acc._farm is None  # an arbiter process is needed
    for x in range(30):
        acc.offload(x)
    want = [N.sq(x) if shape == "worksteal" else N.g(N.f(x))
            for x in range(30)]
    assert acc.wait(60) == want


def test_accelerator_dead_worker_full_ring_fails_fast():
    acc = ProcAccelerator(Farm(N.boom_on_seven, 1, ordered=True),
                          capacity=16)
    with pytest.raises((ValueError, RuntimeError)):
        for x in range(500):
            acc.offload(x)
        acc.wait(30)


# -- spawn pool, lowering options ---------------------------------------------
def test_spawn_pool_reuses_processes_and_opt_out_spawns():
    want = [N.f(x) for x in range(30)]
    prog = lower(Farm(N.f, 2, ordered=True), "procs")
    assert prog(range(30)) == want
    before = pool_stats()
    assert prog(range(30)) == want
    after = pool_stats()

    def total(stats, key):
        return sum(v[key] for v in stats.values())

    # disp + merge + 2 workers + the source: all from the pool
    assert total(after, "spawned") == total(before, "spawned")
    assert total(after, "reused") >= total(before, "reused") + 4
    assert lower(Farm(N.f, 2, ordered=True), "procs", pool=False)(
        range(30)) == want
    assert pool_stats() == after  # direct spawns leave the pool alone


def test_batched_emit_and_grain_batches_match_reference():
    xs = list(range(80))
    build = lambda c: c.Pipeline(c.Stage(N.f), c.Stage(N.g))  # noqa: E731
    want = _ref(build, xs)
    assert lower(build(tcore), "procs", batch=16)(xs) == want
    skel = Pipeline(Source(xs), Stage(N.f, grain=8), Stage(N.g, grain=8))
    prog = lower(skel, "procs", batch="grain", fuse=False)
    assert prog.to_graph().run_and_wait(60) == want


def test_numpy_payloads_through_zero_copy_farm():
    xs = [np.full((32,), float(i), dtype=np.float32) for i in range(24)]
    out = lower(Farm(N.np_double, 2, ordered=True), "procs", batch=4)(xs)
    assert len(out) == len(xs)
    for got, x in zip(out, xs):
        assert got.dtype == np.float32 and np.array_equal(got, x * 2.0)


def test_trace_lanes_come_home_from_every_vertex():
    prog = lower(Farm(N.f, 2, ordered=True), "procs", trace=True)
    assert prog(range(20)) == [N.f(x) for x in range(20)]
    tr = prog.last_trace
    names = {v.name for v in tr.lanes}
    assert {"ff-emitter", "ff-collector", "ff-worker-0",
            "ff-worker-1"} <= names
    pids = {v.pid for v in tr.lanes}
    assert len(pids) == len(tr.lanes) and os.getpid() not in pids


# -- tensors through a process farm -------------------------------------------
def _offload(skel, xs):
    acc = ProcAccelerator(skel)
    for x in xs:
        acc.offload(x)
    return acc.wait(60)


def test_tensors_round_trip_through_a_process_farm():
    """f32, int32, bool and bf16 tensors reach the workers as tensors and
    come back with their dtype, shape and values: inside the farm's tokens
    (their host view) and bare on a stage edge (the TENSOR slot kind).
    Through the accelerator, so that only the workers import torch."""
    xs = [torch.arange(12, dtype=torch.float32).reshape(3, 4),
          torch.tensor([5, -6, 7], dtype=torch.int32),
          torch.tensor([True, False]),
          torch.linspace(-2, 2, 9).to(torch.bfloat16)]
    for skel in (Farm(T.describe, 2, ordered=True), Stage(T.describe)):
        out = _offload(skel, xs)
        assert len(out) == len(xs)
        for (kind, dtype, shape, device, t), x in zip(out, xs):
            assert (kind, dtype, shape, device) == \
                ("Tensor", str(x.dtype), tuple(x.shape), "cpu")
            assert type(t) is torch.Tensor and torch.equal(t, x)


def test_tensors_outside_the_slot_kind_arrive_equal():
    xs = [torch.arange(12.0).reshape(3, 4).t(),        # non-contiguous
          torch.randn(4, requires_grad=True)]
    out = _offload(Stage(T.describe), xs)
    for (_, _, _, _, got), x in zip(out, xs):
        assert got.requires_grad == x.requires_grad
        assert got.stride() == x.stride()
        assert torch.equal(got.detach(), x.detach())
