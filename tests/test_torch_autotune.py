"""The port's self-tuning compile (``repro_torch.core.autotune``) against
the reference's (``repro.core.autotune``).

A profile is a measurement, so the two packages' pilots never agree to the
microsecond.  What must agree is everything that follows from a profile:
``Profile`` JSON that either package writes and the other reads, its
``diff``, the tuning models (``auto_batch``, ``ring_capacity``), the IR
that ``retune`` rewrites from one fixed profile (stage kinds, grains,
capacities, batch sizes: a ``Farm∘Farm`` merge, a2a absorption, a
collapsed and rebatched chain, a feedback barrier), the mesh planner
(``plan_mesh``, ``best_factorization``, ``pipeline_utilisation``,
``negotiate_stage_axis``) and ``RunReport.to_profile``.  Outputs of tuned
programs (threads, procs, and ``"mesh"`` on ``device="cpu"``) equal the
reference's, exactly (integer streams).

No case here asserts what a live pilot measured (which stage fused, which
batch size it chose): that is one run's verdict, and the reference's tests
that do so are timing-dependent (ROADMAP §3).  The rewrite itself is pinned
on fixed profiles instead."""
import json

import pytest
from hypothesis import given, settings, strategies as st

import _procs_nodes as N
import _torch_procs_nodes as T
import repro.core as jcore
import repro_torch.core as tcore
from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import autotune as jat
from repro.core import dpipeline as jdp
from repro_torch.core import autotune as tat
from repro_torch.core import dpipeline as tdp
from repro_torch.core import (FnNode, GO_ON, KeyBatch, LoweringError,
                              Profile, TunedProgram, lower, pool_shutdown)
from repro_torch.core.obs import RunReport
from repro_torch.core.skeleton import FusedNode

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def retire_pool():
    yield
    pool_shutdown()


# -- the skeletons of tests/test_autotune.py, built in either package --------
def farm2(c):
    return c.Pipeline(c.Farm(N.f, 3, ordered=True), c.Farm(N.g, 3, ordered=True))


def a2a(c):
    return c.Pipeline(c.partition_by(N.mod3, 3), c.Stage(N.double),
                      c.Stage(N.f))


def pipe3(c):
    return c.Pipeline(c.Stage(N.f, grain=10000), c.Stage(N.g, grain=10000),
                      c.Stage(N.sq, grain=10000))


def fb(c):
    return c.Pipeline(c.Stage(N.f),
                      c.Feedback(N.fb_step, N.fb_pred, nworkers=2,
                                 max_trips=64), c.Stage(N.g))


def _sp(path, kind, name, us, items=256, width=1, hw=0):
    return {"path": path, "kind": kind, "name": name, "service_us": us,
            "service_ewma_us": us, "items": items, "width": width,
            "queue_high_water": hw}


# Fixed profiles, as a pilot of each skeleton could have measured them:
# every service time below the hand-off cost (sub-µs arithmetic), the
# shuffle's rows slower, the feedback loop slow enough to stay apart.
PROFILES = {
    "farm2": (farm2, {"schema": "autotune-profile/1", "handoff_us": 3.5,
                      "pilot_items": 256, "stages": [
                          _sp("0", "farm", "ff-farm", 0.8, width=3, hw=7),
                          _sp("1", "farm", "ff-farm", 0.6, width=3)]}),
    "a2a": (a2a, {"schema": "autotune-profile/1", "handoff_us": 3.5,
                  "pilot_items": 256, "stages": [
                      _sp("0.left", "a2a-left", "ff-a2a", 0.9),
                      _sp("0.right", "a2a-right", "ff-a2a", 1.2, width=3),
                      _sp("1", "stage", "ff-stage", 0.4, hw=31),
                      _sp("2", "stage", "ff-stage", 0.3)]}),
    "pipe3": (pipe3, {"schema": "autotune-profile/1", "handoff_us": 3.5,
                      "pilot_items": 256, "stages": [
                          _sp("0", "stage", "ff-stage", 0.41, hw=200),
                          _sp("1", "stage", "ff-stage", 0.35),
                          _sp("2", "stage", "ff-stage", 0.52)]}),
    "fb": (fb, {"schema": "autotune-profile/1", "handoff_us": 3.5,
                "pilot_items": 64, "stages": [
                    _sp("0", "stage", "ff-stage", 0.5, items=64),
                    _sp("1", "feedback", "ff-feedback", 40.0, items=300,
                        width=2),
                    _sp("2", "stage", "ff-stage", 0.5, items=64)]}),
}


def _node(n):
    """A node's rewrite-relevant shape, package-neutral."""
    kind = type(n).__name__
    if kind == "_RebatchNode":
        return ("rebatch", n.batch, _node(n.inner))
    if kind == "FusedNode":
        return ("fused", tuple(_node(x) for x in n.nodes))
    if kind in ("FnNode",):
        return ("fn", n._fn.__name__)
    return (kind,)


def describe(s):
    """The rewritten IR as plain data: stage kinds, grains, capacities,
    widths, nodes (fused chains, batch sizes)."""
    kind = type(s).__name__
    if kind == "Pipeline":
        return ("Pipeline", tuple(describe(x) for x in s.stages))
    if kind in ("Stage", "Source"):
        return (kind, s.grain, s.capacity, _node(s.node))
    if kind == "Farm":
        return ("Farm", s.nworkers, s.grain, s.capacity, s.ordered,
                tuple(_node(w) for w in s.worker_nodes))
    if kind == "AllToAll":
        return ("AllToAll", s.nleft, s.nright, s.grain, s.capacity,
                tuple(_node(w) for w in s.left_nodes),
                tuple(_node(w) for w in s.right_nodes))
    if kind == "Feedback":
        return ("Feedback", s.nworkers, s.max_trips, s.grain, _node(s.node))
    return (kind,)


@pytest.fixture(scope="module")
def saved_profiles(tmp_path_factory):
    """Each fixed profile written to one JSON file, read by both."""
    d = tmp_path_factory.mktemp("profiles")
    out = {}
    for name, (build, doc) in PROFILES.items():
        path = d / f"{name}.json"
        path.write_text(json.dumps(doc))
        out[name] = (build, str(path))
    return out


# -- the profile artifact ----------------------------------------------------
def test_profile_measures_every_position_like_the_reference():
    """A pilot in each package: the same positions, kinds, names, widths
    and pilot length (the times are each run's own)."""
    for build, n in ((farm2, 256), (a2a, 256), (pipe3, 256), (fb, 64)):
        mine = tat.profile(build(tcore), range(n))
        ref = jat.profile(build(jcore), range(n))
        shape = [(sp.path, sp.kind, sp.name, sp.width) for sp in mine.stages]
        assert shape == [(sp.path, sp.kind, sp.name, sp.width)
                         for sp in ref.stages]
        assert mine.pilot_items == ref.pilot_items == n
        assert mine.handoff_us > 0
        assert all(sp.items > 0 and sp.service_us > 0 for sp in mine.stages)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_profile_json_reads_in_the_other_package(tmp_path, writer):
    prof = (tat.profile(farm2(tcore), range(128)) if writer == "port"
            else jat.profile(farm2(jcore), range(128)))
    path = str(tmp_path / "prof.json")
    prof.save(path)
    reader = jat.Profile if writer == "port" else tat.Profile
    back = reader.load(path)
    assert back.to_json() == prof.to_json()
    assert back.stage("1").service_us == prof.stage("1").service_us
    with open(path) as f:
        assert json.load(f)["schema"] == "autotune-profile/1"
    for P in (tat.Profile, jat.Profile):
        with pytest.raises(ValueError):
            P.from_json({"schema": "bench-rows/1"})


def test_profile_diff_equals_the_reference():
    a = PROFILES["pipe3"][1]
    b = json.loads(json.dumps(a))
    b["stages"][1]["service_us"] = 9.0
    b["stages"][2]["queue_high_water"] = 5
    del b["stages"][0]
    mine = tat.Profile.from_json(a).diff(tat.Profile.from_json(b))
    ref = jat.Profile.from_json(a).diff(jat.Profile.from_json(b))
    assert mine == ref
    assert mine["0"]["service_us"] == (0.41, None)
    assert mine["1"]["service_us"] == (0.35, 9.0)


# -- the tuning models -------------------------------------------------------
@given(st.floats(0.0, 5e4), st.floats(0.0, 500.0), st.floats(0.01, 1.0),
       st.integers(2, 1024))
@settings(max_examples=200, deadline=None)
def test_auto_batch_equals_the_reference(svc, handoff, frac, cap):
    assert tat.auto_batch(svc, handoff, frac=frac, cap=cap) == \
        jat.auto_batch(svc, handoff, frac=frac, cap=cap)


@given(st.floats(0.0, 1e4), st.floats(0.0, 1e4), st.integers(0, 5000))
@settings(max_examples=200, deadline=None)
def test_ring_capacity_equals_the_reference(prod, cons, hw):
    assert tat.ring_capacity(prod, cons, hw) == jat.ring_capacity(prod, cons, hw)


def test_tuning_models_on_the_reference_points():
    assert [tat.auto_batch(100.0, 3.0), tat.auto_batch(1.0, 3.0),
            tat.auto_batch(0.001, 5.0), tat.auto_batch(5.0, 1.0, frac=0.5)] \
        == [1, 30, 256, 1]
    assert [tat.ring_capacity(1.0, 1.0), tat.ring_capacity(8.0, 1.0),
            tat.ring_capacity(1.0, 1000.0),
            tat.ring_capacity(1.0, 1.0, high_water=300)] == [64, 16, 512, 1024]


def test_rebatch_node_batches_flushes_and_filters_like_the_reference():
    from repro.core.autotune import _RebatchNode as JRebatch
    from repro_torch.core.autotune import _RebatchNode
    for fns, xs in (((N.double, N.double), [1, 2, 3, 4]),
                    ((T.drop_odd, N.drop_odd), [1, 3, 2, 4, 6])):
        mine, ref = _RebatchNode(FnNode(fns[0]), batch=3), \
            JRebatch(jcore.FnNode(fns[1]), batch=3)
        mine.svc_init()
        ref.svc_init()
        for x in xs:
            a, b = mine.svc(x), ref.svc(x)
            assert (a is GO_ON) == (b is jcore.GO_ON)
            if a is not GO_ON:
                assert isinstance(a, KeyBatch) and list(a) == list(b)
        a, b = mine.svc_eos(), ref.svc_eos()
        assert (a is None) == (b is None)
        if a is not None:
            assert list(a) == list(b)
        assert mine.svc_eos() is None


# -- retune of one fixed profile: the same rewritten IR ----------------------
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_retune_of_a_fixed_profile_equals_the_reference(saved_profiles, name):
    build, path = saved_profiles[name]
    mine = tat.retune(build(tcore), tat.Profile.load(path))
    ref = jat.retune(build(jcore), jat.Profile.load(path))
    assert describe(mine) == describe(ref)


def test_what_the_fixed_profiles_rewrite_to(saved_profiles):
    """The four rewrites: Farm∘Farm merged into one farm keeping the
    first farm's stats; stateless stages absorbed into the a2a right
    rows; a mis-grained chain collapsed into one micro-batched stage; the
    feedback loop left a barrier."""
    t = {n: tat.retune(b(tcore), tat.Profile.load(p))
         for n, (b, p) in saved_profiles.items()}
    skel = farm2(tcore)
    merged = tat.retune(skel, tat.Profile.load(saved_profiles["farm2"][1]))
    assert isinstance(merged, tcore.Farm) and merged.nworkers == 3
    assert merged.stats is skel.stages[0].stats
    assert isinstance(t["a2a"], tcore.AllToAll)
    assert all(isinstance(r, FusedNode) for r in t["a2a"].right_nodes)
    assert isinstance(t["pipe3"], tcore.Stage)
    assert describe(t["pipe3"])[3][0] == "rebatch"
    assert describe(t["pipe3"])[3][1] == \
        tat.auto_batch(float(t["pipe3"].grain), 3.5) > 1
    kinds = [type(s).__name__ for s in t["fb"].stages]
    assert kinds.count("Feedback") == 1
    assert tat.retune(skel, tat.Profile.load(saved_profiles["farm2"][1]),
                      backend="mesh") is skel


# -- tuned programs: outputs equal the reference's ---------------------------
def _want(name, xs):
    if name == "a2a":
        return sorted(N.f(N.double(x)) for x in xs)
    return {"farm2": lambda x: N.g(N.f(x)), "pipe3": lambda x: N.sq(N.g(N.f(x))),
            "fb": lambda x: N.g(N.fb_ref(N.f(x)))}[name]


@given(st.lists(st.integers(0, 60), max_size=30))
@settings(max_examples=5, deadline=None)
def test_tuned_threads_equal_the_reference(xs):
    for name, (build, doc) in sorted(PROFILES.items()):
        mine = lower(build(tcore), "threads",
                     profile=tat.Profile.from_json(doc))(xs)
        ref = jcore.lower(build(jcore), "threads",
                          profile=jat.Profile.from_json(doc))(xs)
        if name == "a2a":
            assert sorted(mine) == sorted(ref) == _want(name, xs)
        else:
            assert mine == ref == [_want(name, xs)(x) for x in xs]


@pytest.mark.parametrize("name", ["farm2", "a2a", "pipe3"])
def test_tuned_procs_equal_the_reference(saved_profiles, name):
    """The rewritten IR on spawned processes (the _RebatchNode wrapper
    pickles to its vertex; its KeyBatch messages unpack at the drain)."""
    build, path = saved_profiles[name]
    xs = list(range(-20, 20))
    tp = lower(build(tcore), "procs", profile=path)
    mine = tp(xs)
    assert tp.tuned.backend == "procs"
    ref = jcore.lower(build(jcore), "threads", profile=path)(xs)
    if name == "a2a":
        assert sorted(mine) == sorted(ref)
    else:
        assert mine == ref


@pytest.mark.parametrize("name", ["farm2", "pipe3", "fb"])
def test_tuned_mesh_equals_the_reference(saved_profiles, name):
    build, path = saved_profiles[name]
    xs = list(range(0, 60))
    tp = lower(build(tcore), "mesh", profile=path, device=CPU)
    assert tp.tuned_skeleton is tp.skeleton   # mesh tunes options, not IR
    assert tp.tuned.n_stage == tp.tuned.n_worker == 1
    ref = jcore.lower(build(jcore), "mesh", profile=path)
    assert tp(xs) == ref(xs) == [_want(name, xs)(x) for x in xs]


@pytest.mark.parametrize("backend", ["threads", "procs", "mesh"])
def test_tune_two_phase(backend):
    """tune=True: the pilot's outputs are real outputs, the remainder runs
    tuned, a second call goes straight to the tuned program."""
    opts = {"device": CPU} if backend == "mesh" else {}
    tp = lower(farm2(tcore), backend, tune=True, tune_pilot=32, **opts)
    assert isinstance(tp, TunedProgram) and tp.tuned is None
    xs = list(range(100))
    want = [N.g(N.f(x)) for x in xs]
    assert tp(xs) == want
    assert tp.profile.pilot_items == 32 and tp.tuned.backend == backend
    assert tp(xs[:40]) == want[:40]


def test_tune_pilot_covers_whole_stream():
    tp = lower(pipe3(tcore), "threads", tune=True, tune_pilot=512)
    xs = list(range(40))
    assert tp(xs) == [N.sq(N.g(N.f(x))) for x in xs]
    assert tp.profile.pilot_items == 40


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_saved_profile_skips_pilot(tmp_path, writer):
    prof = (tat.profile(pipe3(tcore), range(64)) if writer == "port"
            else jat.profile(pipe3(jcore), range(64)))
    path = str(tmp_path / "pipe3.json")
    prof.save(path)
    tp = lower(pipe3(tcore), "threads", profile=path)
    assert tp.tuned is not None             # built before any call
    assert tp.profile.to_json() == prof.to_json()
    xs = list(range(50))
    assert tp(xs) == [N.sq(N.g(N.f(x))) for x in xs]


# -- mesh planning -----------------------------------------------------------
def test_pipeline_utilisation_and_negotiation_equal_the_reference():
    for s in range(0, 17):
        for d in range(0, 17):
            assert tdp.negotiate_stage_axis(s, d) == \
                jdp.negotiate_stage_axis(s, d)
            if s >= 1:
                assert tdp.pipeline_utilisation(s, d + 1) == \
                    jdp.pipeline_utilisation(s, d + 1)


def test_best_factorization_equals_the_reference():
    costs = [[5.0, 1.0], [1.0, 1.0, 1.0], [2.0, 8.0, 1.0, 3.0], None, [0.0],
             [1.0] * 8]
    for s in range(0, 17):
        for d in range(0, 17):
            for c in costs:
                for m in (None, 1, 9, 40):
                    assert tdp.best_factorization(s, d, c, m) == \
                        jdp.best_factorization(s, d, c, m)


def _chain(c, n):
    return c.Pipeline(*[c.Stage(N.f) for _ in range(n)]) if n > 1 \
        else c.Stage(N.f)


@pytest.mark.parametrize("stages", [1, 2, 3, 4, 8])
def test_plan_mesh_equals_the_reference(stages):
    for skew in (1.0, 7.0):
        doc = {"schema": "autotune-profile/1", "handoff_us": 2.0,
               "pilot_items": 900, "stages": [
                   _sp(str(i), "stage", "ff-stage", 1.0 + skew * (i == 0))
                   for i in range(stages)]}
        for d in range(1, 17):
            assert tat.plan_mesh(tat.Profile.from_json(doc),
                                 _chain(tcore, stages), devices=d) == \
                jat.plan_mesh(jat.Profile.from_json(doc),
                              _chain(jcore, stages), devices=d)


def test_plan_mesh_one_device_and_a2a_guard(saved_profiles):
    prof = tat.Profile.load(saved_profiles["pipe3"][1])
    assert tat.plan_mesh(prof, pipe3(tcore), devices=1) == \
        {"factorization": (1, 1)}
    assert tat.plan_mesh(tat.Profile.load(saved_profiles["a2a"][1]),
                         a2a(tcore), devices=4) == {}


def test_mesh_factorization_validation():
    """The reference refuses (3, 1) for two stages and (2, 3) on four
    devices; so does the port, with the reference's reason, before any
    rank starts."""
    for fact in ((3, 1), (2, 3)):
        with pytest.raises(jcore.LoweringError):
            jcore.lower(farm2(jcore), "mesh", devices=4, factorization=fact)
        with pytest.raises(LoweringError, match="not expressible on 4 devices"):
            lower(farm2(tcore), "mesh", devices=4, factorization=fact,
                  device=CPU, transport="gloo")
    with pytest.raises(LoweringError, match="not expressible"):
        lower(farm2(tcore), "mesh", factorization=(1, 0), device=CPU)


# -- RunReport.to_profile ----------------------------------------------------
REPORT = {
    "counters": {"x": 3}, "gauges": {"handoff_us": 2.5},
    "farms": {"ff-farm@0": {"service_ewma": {"0": 1e-5, "1": 3e-5},
                            "tasks_collected": 120},
              "ff-farm@2.1": {"service_ewma": {}, "tasks_collected": 7},
              "ff-farm": {"service_ewma": {"0": 2e-6}, "tasks_collected": 9}},
    "queues": {"ff-emitter@0": 12, "ff-worker@0": 30, "ff-stage@1": 99,
               "ff-collector@2.1": 4, "ff-source": 8},
}


@pytest.mark.parametrize("handoff", [None, 4.0])
def test_run_report_to_profile_equals_the_reference(handoff):
    from repro.core.obs import RunReport as JRunReport
    mine = RunReport(**REPORT).to_profile(handoff)
    ref = JRunReport(**REPORT).to_profile(handoff)
    assert mine.to_json() == ref.to_json()
    assert isinstance(mine, Profile)


def test_run_report_of_a_live_run_rebuilds_a_profile():
    """metrics=True leaves a RunReport whose profile names the farm
    positions the pilot would, and diffs against a pilot profile."""
    prog = lower(farm2(tcore), "threads", metrics=True)
    xs = list(range(200))
    assert prog(xs) == [N.g(N.f(x)) for x in xs]
    prof = prog.last_report.to_profile()
    assert [sp.path for sp in prof.stages] == ["0", "1"]
    assert all(sp.kind == "farm" and sp.items == 200 for sp in prof.stages)
    pilot = tat.Profile.from_json(PROFILES["farm2"][1])
    assert set(prof.diff(pilot)) == {"0", "1"}
