"""The port's streaming runtime (``repro_torch.core``) against the
reference's (``repro.core``), and the Smith-Waterman search end to end.

Deterministic cases of ``tests/test_farm.py`` and ``tests/test_graph.py``
run on the port's copy of the threads backend; where a case makes sense on
both, the two runtimes get the same stream and must give the same output.
No case is timed by ``sleep``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jcore
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import (GO_ON, Farm, Feedback, FnNode,
                              LockQueue, LoweringError, Pipeline, SPSCQueue,
                              Stage, TaskFarm, compose, ff_node, lower,
                              make_scheduler)
from repro_torch.kernels import ops, ref


def _f(x):
    return x * 3 + 1


def _g(x):
    return x * x - 2


def _busy(x):
    """Variable per-item latency without sleeping: work grows with x % 7."""
    acc = 0
    for i in range((x % 7) * 400):
        acc ^= i
    return x * x


# -- farm semantics (tests/test_farm.py) -------------------------------------
@pytest.mark.parametrize("nworkers", [1, 3, 8])
@pytest.mark.parametrize("qcls", [SPSCQueue, LockQueue])
def test_farm_completeness(nworkers, qcls):
    farm = TaskFarm(nworkers, queue_class=qcls)
    farm.add_stream(range(200))
    farm.add_worker(FnNode(lambda x: x * 3))
    out = farm.run_and_wait()
    assert sorted(out) == [x * 3 for x in range(200)]
    assert farm.stats.tasks_collected == 200


@pytest.mark.parametrize("scheduling", ["rr", "ondemand", "worksteal",
                                        "costmodel"])
def test_order_preserving_farm(scheduling):
    """Tagged-token collector (paper Fig. 1 right): output == input order
    under variable task latency, whatever the placement policy."""
    farm = TaskFarm(4, preserve_order=True, scheduling=scheduling)
    farm.add_stream(range(120))
    farm.add_worker(FnNode(_busy))
    assert farm.run_and_wait() == [_busy(x) for x in range(120)]


def test_ondemand_picks_the_shortest_ring():
    """On-demand placement (FastFlow's on-demand mode) sends each task to
    the worker whose ring is shortest, in both runtimes."""
    rings = [[0, 0, 0], [0], [0, 0]]
    for sched in (make_scheduler("ondemand"), jcore.make_scheduler("ondemand")):
        sched.bind(rings, None)
        assert sched.pick() == 1
    farm = TaskFarm(3, scheduling="ondemand", capacity=2)
    farm.add_stream(range(40))
    farm.add_worker(FnNode(_busy))
    assert sorted(farm.run_and_wait()) == sorted(_busy(x) for x in range(40))


@given(st.integers(1, 6), st.integers(0, 120))
@settings(max_examples=20, deadline=None)
def test_farm_property_any_size(nworkers, n):
    farm = TaskFarm(nworkers, preserve_order=True)
    farm.add_stream(range(n))
    farm.add_worker(FnNode(lambda x: x + 7))
    assert farm.run_and_wait() == [x + 7 for x in range(n)]


# -- composition (tests/test_graph.py) ---------------------------------------
def test_pipeline_of_farms_matches_sequential_and_reference():
    """Pipeline(Farm(f), Farm(g)) == g(f(x)) over a 10k stream, and the
    reference runtime gives the same list."""
    n = 10_000
    out = Pipeline(Farm(_f, 4, ordered=True),
                   Farm(_g, 4, ordered=True)).run_and_wait(range(n))
    want = jcore.Pipeline(jcore.Farm(_f, 4, ordered=True),
                          jcore.Farm(_g, 4, ordered=True)).run_and_wait(range(n))
    assert out == want == [_g(_f(x)) for x in range(n)]


def test_pipeline_of_farms_unordered_same_multiset():
    out = Pipeline(Farm(_f, 3), Farm(_g, 3)).run_and_wait(range(2_000))
    assert sorted(out) == sorted(_g(_f(x)) for x in range(2_000))


def test_compose_mixes_stages_and_farms():
    net = compose(lambda x: x + 1, Farm(_f, 3, ordered=True), lambda x: x - 1)
    want = jcore.compose(lambda x: x + 1, jcore.Farm(_f, 3, ordered=True),
                         lambda x: x - 1).run_and_wait(range(500))
    assert net.run_and_wait(range(500)) == want == \
        [_f(x + 1) - 1 for x in range(500)]


def test_stage_filtering_go_on():
    """A stage returning GO_ON filters the item."""
    def keep_even(x):
        return x if x % 2 == 0 else GO_ON
    out = Pipeline(Stage(FnNode(keep_even)), Stage(FnNode(lambda x: x // 2))
                   ).run_and_wait(range(100))
    assert out == [x // 2 for x in range(0, 100, 2)]


def test_farm_worker_go_on_filters():
    keep_even = lambda x: x if x % 2 == 0 else GO_ON
    assert Farm(keep_even, 2, ordered=True).run_and_wait(range(10)) == \
        [0, 2, 4, 6, 8]
    out = Pipeline(Farm(keep_even, 2, ordered=True),
                   Farm(lambda x: x * 10, 2, ordered=True)).run_and_wait(range(10))
    assert out == [0, 20, 40, 60, 80]


def test_lock_queue_substrate():
    out = Pipeline(Farm(_f, 2, ordered=True), Farm(_g, 2, ordered=True)
                   ).run_and_wait(range(300), queue_class=LockQueue)
    assert out == [_g(_f(x)) for x in range(300)]


@given(st.integers(1, 5), st.integers(1, 5), st.integers(0, 300))
@settings(max_examples=12, deadline=None)
def test_ordered_composition_preserves_order(nw1, nw2, n):
    out = Pipeline(Farm(_f, nw1, ordered=True),
                   Farm(_g, nw2, ordered=True)).run_and_wait(range(n))
    assert out == [_g(_f(x)) for x in range(n)]


@given(st.integers(1, 6), st.lists(st.integers(-1000, 1000), max_size=150),
       st.booleans())
@settings(max_examples=15, deadline=None)
def test_taskfarm_matches_reference_semantics(nworkers, stream, ordered):
    farm = TaskFarm(nworkers, preserve_order=ordered)
    farm.add_stream(list(stream))
    farm.add_worker(FnNode(_f))
    out = farm.run_and_wait()
    want = [_f(x) for x in stream]
    assert (out == want) if ordered else (sorted(out) == sorted(want))
    assert farm.stats.tasks_collected == len(stream)


def test_feedback_divide_and_conquer_sum():
    """Recursive range-splitting through the wrap-around edge."""
    def worker(task):
        lo, hi = task
        if hi - lo <= 8:
            return ("leaf", sum(range(lo, hi)))
        mid = (lo + hi) // 2
        return ("split", (lo, mid), (mid, hi))

    def route(res):
        return (res[1], []) if res[0] == "leaf" else (None, [res[1], res[2]])

    parts = Farm(worker, 4, feedback=route).run_and_wait([(0, 1_000)])
    assert sum(parts) == sum(range(1_000))


def test_feedback_skeleton_preserves_order():
    out = lower(Feedback(lambda x: x // 2, lambda x: x > 3, nworkers=3),
                "threads")(range(200))
    want = jcore.lower(jcore.Feedback(lambda x: x // 2, lambda x: x > 3,
                                      nworkers=3), "threads")(range(200))
    assert out == want


def test_dead_worker_full_ring_raises_not_hangs():
    def die(x):
        raise RuntimeError("worker died immediately")

    with pytest.raises(RuntimeError, match="worker died immediately"):
        Farm(die, 1).run_and_wait(range(5_000), capacity=8)


# -- a mesh over more than one device: rank processes, explicit transport ----
@pytest.mark.parametrize("backend", ["mesh"])
def test_mesh_over_cpu_ranks_needs_gloo(backend):
    """More than one device runs in rank processes; CPU ranks need an
    explicit ``transport="gloo"`` (tests/test_torch_mesh_ranks.py)."""
    with pytest.raises(LoweringError, match='transport="gloo"'):
        lower(Farm(_f, 2), backend, device="cpu", devices=2)


@pytest.mark.parametrize("opts", [{"tune": True}, {"metrics": True},
                                  {"monitor": True}])
def test_later_options_raise_lowering_error(opts):
    """The options work on one device, and over two CPU ranks still need
    the transport named (the tuned program plans its mesh after the
    pilot, at its first call)."""
    with pytest.raises(LoweringError, match='transport="gloo"'):
        lower(Farm(_f, 2), "mesh", device="cpu", devices=2, **opts)(range(8))


# -- the slice end to end (tests/test_system.py) -----------------------------
def test_sw_database_search_via_farm_matches_reference():
    """The same query and 12 subjects through the reference's farm + Pallas
    kernel and through the port's farm + smith_waterman: equal ordered
    score lists, equal to the port's sequential oracle."""
    rng = np.random.default_rng(0)
    query = rng.integers(0, 20, 24).astype(np.int32)
    db = [rng.integers(0, 20, int(rng.integers(10, 60))).astype(np.int32)
          for _ in range(12)]

    jfarm = jcore.TaskFarm(3, preserve_order=True)
    jfarm.add_stream([jnp.asarray(s) for s in db])
    jq = jnp.asarray(query)
    jfarm.add_worker(jcore.FnNode(lambda s: float(jops.smith_waterman(
        jq, s, gap_open=10.0, gap_extend=2.0, tile=64))))
    want = jfarm.run_and_wait()

    tq = torch.from_numpy(query)
    farm = TaskFarm(3, preserve_order=True)
    farm.add_stream([torch.from_numpy(s) for s in db])
    farm.add_worker(FnNode(lambda s: float(ops.smith_waterman(
        tq, s, gap_open=10.0, gap_extend=2.0, tile=64, device="cpu"))))
    got = farm.run_and_wait()
    assert got == want

    prof, _ = convert.profile_from_numpy(
        np.asarray(jops.build_profile(jq)[0]), len(query), device="cpu")
    assert got == [float(ref.sw_ref(prof, torch.from_numpy(s), 10.0, 2.0))
                   for s in db]


def test_sw_search_pipeline_as_the_example_runs_it():
    """Pipeline(Farm(align, 2, ordered=True), Stage(round)), as
    examples/smith_waterman_search.py wires it."""
    rng = np.random.default_rng(7)
    query = torch.from_numpy(rng.integers(0, 20, 30).astype(np.int32))
    db = [torch.from_numpy(rng.integers(0, 20, n).astype(np.int32))
          for n in (5, 80, 33, 140, 2)]
    align = lambda s: float(ops.smith_waterman(query, s, tile=64, device="cpu"))
    out = Pipeline(Farm(align, 2, ordered=True),
                   Stage(lambda s: round(s, 1))).run_and_wait(db)
    assert out == [round(align(s), 1) for s in db]
