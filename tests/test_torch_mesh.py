"""The port's device backend, ``lower(skel, "mesh")``, on the CPU
(``device="cpu"``) against the reference's mesh backend on the JAX CPU
device, one device each: the mesh cases of ``tests/test_skeleton.py``,
``tests/test_a2a.py``, ``tests/test_oocore.py``, ``tests/test_obs.py`` and
``tests/test_monitor.py``, line for line, with the same inputs through both
packages; the device farm (``repro_torch.core.dfarm``) against the
reference's ``dfarm`` under a one-device ``shard_map``; the row-bucket
rule; and the refusals, the reference's (int32, dtype, capacity, keys,
host-only features) and the port's own (more than one device on the CPU
needs an explicit ``transport="gloo"``; a worker axis of more than one
needs its rank group).  Programs over rank processes are held in
``tests/test_torch_mesh_ranks.py``.

Integer results and key→fold maps are compared exactly.  Float streams are
float32 in both programs; XLA may contract ``3x + 1`` into one fused
multiply-add where torch rounds twice, so float results of the two mesh
programs agree to 1e-6 relative (1e-5 absolute), and to the host backends'
Python floats at the reference's 1e-4."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import _procs_nodes as N
import repro.core as jcore
import repro_torch.core as tcore
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import (AllToAll, Farm, Feedback, LoweringError,
                              MeshProgram, Monitor, Pipeline, Source, Stage,
                              lower, reduce_by_key, rekey_reduce)
from repro_torch.core import dfarm, dpipeline

CPU = "cpu"
F_RTOL, F_ATOL = 1e-6, 1e-5     # port mesh vs reference mesh, float32
HOST_TOL = 1e-4                 # either mesh vs Python floats (reference)


def _both(build, backend_opts=None):
    """The same skeleton built in each package and lowered on "mesh":
    (port program on the CPU, reference program on the JAX CPU device)."""
    opts = dict(backend_opts or {})
    return (lower(build(tcore), "mesh", device=CPU, **opts),
            jcore.lower(build(jcore), "mesh", **opts))


def _pipe(c):
    return c.Pipeline(c.Farm(N.f, 4, ordered=True), c.Farm(N.g, 4, ordered=True))


def _fb(c):
    return c.Feedback(N.fb_step, N.fb_pred, nworkers=3, max_trips=32)


def _rbk5(c):
    return c.reduce_by_key(N.mod5, "sum", nleft=2, nright=3, nkeys=5)


def _brbk5(c):
    return c.reduce_by_key(N.mod5, "sum", nleft=2, nright=3, nkeys=5,
                           budget=256)


# Programs built once at module scope, as the reference's tests build
# theirs: each package's mesh program keeps one program per row bucket.
PIPE_M, PIPE_J = _both(_pipe)
PIPE_T = lower(_pipe(tcore), "threads")
FB_M, FB_J = _both(_fb)
FB_T = lower(_fb(tcore), "threads")
RBK_M, RBK_J = _both(_rbk5)
RBK_T = lower(_rbk5(tcore), "threads")
BRBK_M, BRBK_J = _both(_brbk5)
BRBK_T = lower(_brbk5(tcore), "threads")


def ref_rbk(xs, by, fold):
    d = {}
    for x in xs:
        k = by(x)
        d[k] = fold(d[k], x) if k in d else x
    return d


# -- tests/test_skeleton.py: backend parity, ordered outputs -----------------
@given(st.lists(st.integers(-1000, 1000), max_size=40))
@settings(max_examples=10, deadline=None)
def test_parity_pipeline_of_farms_ints(xs):
    want = [N.g(N.f(x)) for x in xs]
    assert PIPE_M(xs) == PIPE_J(xs) == PIPE_T(xs) == want


@given(st.lists(st.floats(-100.0, 100.0), max_size=40))
@settings(max_examples=10, deadline=None)
def test_parity_pipeline_of_farms_floats(xs):
    m, j, t = PIPE_M(xs), PIPE_J(xs), PIPE_T(xs)
    assert len(m) == len(j) == len(t) == len(xs)
    np.testing.assert_allclose(m, j, rtol=F_RTOL, atol=F_ATOL)
    np.testing.assert_allclose(m, t, rtol=HOST_TOL, atol=HOST_TOL)


@given(st.lists(st.integers(0, 60), max_size=32))
@settings(max_examples=10, deadline=None)
def test_parity_feedback_farm(xs):
    want = [N.fb_ref(x) for x in xs]
    assert FB_M(xs) == FB_J(xs) == FB_T(xs) == want


def test_parity_empty_stream():
    assert PIPE_M([]) == PIPE_J([]) == FB_M([]) == RBK_M([]) == []


def test_mesh_lowering_is_one_program_per_bucket():
    """Pipeline(Farm(f), Farm(g)) lowers whole: one device program (no
    thread graph), reused by a call of the same bucket."""
    prog = lower(_pipe(tcore), "mesh", device=CPU, metrics=True)
    assert isinstance(prog, MeshProgram)
    xs = list(range(48))
    assert prog(xs) == [N.g(N.f(x)) for x in xs]
    assert prog(list(range(10))) == [N.g(N.f(x)) for x in range(10)]
    assert len(prog._programs) == 1
    assert prog.metrics.counter("mesh.compiles").value == 1
    prog(list(range(100)))          # the next bucket: one more program
    assert prog.metrics.counter("mesh.compiles").value == 2


def test_mesh_rejects_host_only_features():
    for c in (tcore, jcore):
        opts = {"device": CPU} if c is tcore else {}
        with pytest.raises(c.LoweringError, match="Feedback"):
            c.lower(c.Farm(N.f, 2, feedback=lambda r: (r, [])), "mesh", **opts)
        with pytest.raises(c.LoweringError, match="backend"):
            c.lower(c.Farm(N.f, 2), "cuda-graphs")
        with pytest.raises(c.LoweringError, match="Source"):
            c.lower(c.Pipeline(c.Source(range(4)), c.Farm(N.f, 2)), "mesh",
                    **opts)
        with pytest.raises(c.LoweringError, match="emitter"):
            c.lower(c.Farm(N.f, 2, emitter=N.AddTagEmitter()), "mesh", **opts)
        with pytest.raises(c.LoweringError, match="SPMD"):
            c.lower(c.Farm([N.f, N.g], 2), "mesh", **opts)


def test_mesh_feedback_padding_rows_do_not_gate_loop():
    """worker(0) = 0 is a fixed point and loop_while(0) holds: an
    unguarded padding row would loop forever (no max_trips on purpose)."""
    m, j = _both(lambda c: c.Feedback(N.double, N.fb_pred))
    t = lower(Feedback(N.double, N.fb_pred), "threads")
    assert m([5]) == j([5]) == t([5]) == [80]


def test_feedback_max_trips_parity_on_both_backends():
    m, j = _both(lambda c: c.Feedback(N.double, N.fb_pred, max_trips=3))
    t = lower(Feedback(N.double, N.fb_pred, max_trips=3), "threads")
    xs = [1, 2, 50, 70]
    assert m(xs) == j(xs) == t(xs) == [8, 16, 100, 140]


@pytest.mark.parametrize("items", [[2 ** 31], [-2 ** 31 - 1], [1, 2 ** 40]])
def test_mesh_rejects_int_overflow_instead_of_wrapping(items):
    for prog, err in ((PIPE_M, LoweringError), (PIPE_J, jcore.LoweringError)):
        with pytest.raises(err, match="int32"):
            prog(items)


@pytest.mark.parametrize("items,match", [(["a", "b"], "numeric"),
                                         ([[[1]], [[2]]], "1-D"),
                                         ([object()], "numeric")])
def test_mesh_refuses_what_it_cannot_pack(items, match):
    for prog, err in ((PIPE_M, LoweringError), (PIPE_J, jcore.LoweringError)):
        with pytest.raises(err, match=match):
            prog(items)


def test_mesh_rejects_undersized_capacity_instead_of_dropping():
    m, j = _both(lambda c: c.Farm(N.f, 4, ordered=True), {"capacity": 1})
    for prog, err in ((m, LoweringError), (j, jcore.LoweringError)):
        with pytest.raises(err, match="capacity"):
            prog(range(16))


def test_mesh_vector_items_and_dtypes():
    """1-D items travel as rows; ints, floats and bools come back as the
    reference's Python values."""
    rows = [[1, 2, 3], [4, 5, 6], [-7, 8, 9]]
    m, j = _both(lambda c: c.Farm(N.f, 2, ordered=True))
    assert m(rows) == j(rows) == [[N.f(v) for v in r] for r in rows]
    assert m([True, False]) == j([True, False]) == [4, 1]
    fl = [[0.5, 1.5], [2.25, -3.0]]
    np.testing.assert_allclose(m(fl), j(fl), rtol=F_RTOL, atol=F_ATOL)


# -- the row-bucket rule -----------------------------------------------------
@pytest.mark.parametrize("block,grain", [(64, None), (1, None), (64, 48),
                                         (100, 7), (1, 3)])
def test_bucket_rule_equals_the_reference(block, grain):
    m, j = _both(lambda c: c.Farm(N.f, 2, ordered=True),
                 {"block": block, "grain": grain})
    assert [m._bucket_rows(n) for n in range(0, 700, 3)] == \
        [j._bucket_rows(n) for n in range(0, 700, 3)]
    am, aj = _both(_rbk5, {"block": block})
    assert [am._bucket_rows(n) for n in range(0, 700, 3)] == \
        [aj._bucket_rows(n) for n in range(0, 700, 3)]


def test_grain_from_the_skeleton_aligns_rows():
    m, j = _both(lambda c: c.Pipeline(c.Stage(N.f, grain=48),
                                      c.Farm(N.g, 2, ordered=True)))
    assert m.grain == j.grain == 48
    assert m._bucket_rows(10) == j._bucket_rows(10) == 96
    assert m(list(range(10))) == j(list(range(10)))


# -- more than one device: rank processes (tests/test_torch_mesh_ranks.py) ----
@pytest.mark.parametrize("opts", [{"devices": 2}, {"devices": 8},
                                  {"factorization": (1, 2)},
                                  {"factorization": (2, 1)}])
def test_cpu_ranks_need_gloo_and_a_factorization_that_fits(opts):
    """More than one device runs in rank processes: on the CPU they need
    ``transport="gloo"`` (NCCL has no CPU ranks, and nothing switches the
    transport silently); a factorization over more devices than the one
    of ``device="cpu"`` is not expressible, as in the reference."""
    if "devices" in opts:
        for build in (_pipe, _rbk5):
            with pytest.raises(LoweringError, match='transport="gloo"'):
                lower(build(tcore), "mesh", device=CPU, **opts)
            prog = lower(build(tcore), "mesh", device=CPU, transport="gloo",
                         **opts)
            assert prog.n_worker * getattr(prog, "n_stage", 1) == \
                opts["devices"]
            assert prog.pool is None     # the ranks start at the first call
    else:
        with pytest.raises(LoweringError,
                           match="not expressible on 1 devices"):
            lower(_pipe(tcore), "mesh", device=CPU, **opts)


def test_one_device_is_the_default_and_factorization_1_1_is_allowed():
    prog = lower(_pipe(tcore), "mesh", device=CPU, devices=1,
                 factorization=(1, 1))
    assert (prog.n_stage, prog.n_worker) == (1, 1)
    assert prog([3, 4]) == [N.g(N.f(3)), N.g(N.f(4))]


def test_exchanges_over_more_than_one_worker_need_the_worker_group():
    """A worker axis of more than one is a rank group inside a rank job
    (``tests/test_torch_dchannel.py``); a bare count above one names no
    ranks to exchange with, and ``pipeline_apply`` needs its stage group."""
    x = torch.zeros(4, 1)
    dest = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="worker Group"):
        dfarm.dispatch(x, dest, 2, 4)
    with pytest.raises(ValueError, match="worker Group"):
        dfarm.farm_map(N.f, x, dest, 2, 4, backend="ring")
    with pytest.raises(ValueError, match="unknown dispatch backend"):
        dfarm.dispatch(x, dest, 1, 4, backend="smoke-signals")
    with pytest.raises(TypeError, match="group"):
        dpipeline.pipeline_apply(lambda p, v: v, None, x)


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lower(_pipe(tcore), "mesh")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lower(_rbk5(tcore), "mesh")


# -- tests/test_a2a.py and tests/test_oocore.py: the keyed shuffle -----------
@given(st.lists(st.integers(0, 1000), max_size=40))
@settings(max_examples=8, deadline=None)
def test_reduce_by_key_parity_threads_mesh(xs):
    want = ref_rbk(xs, N.mod5, lambda a, b: a + b)
    assert dict(RBK_M(xs)) == dict(RBK_J(xs)) == dict(RBK_T(xs)) == want


@given(st.lists(st.integers(0, 1000), max_size=40))
@settings(max_examples=8, deadline=None)
def test_budgeted_rbk_parity_threads_mesh(xs):
    want = ref_rbk(xs, N.mod5, lambda a, b: a + b)
    assert dict(BRBK_M(xs)) == dict(BRBK_J(xs)) == dict(BRBK_T(xs)) == want


@pytest.mark.parametrize("fold,ref", [("min", min), ("max", max)])
def test_named_folds_threads_vs_mesh(fold, ref):
    xs = list(range(7, 43))
    m, j = _both(lambda c: c.reduce_by_key(N.mod5, fold, nkeys=5))
    want = ref_rbk(xs, N.mod5, ref)
    assert dict(m(xs)) == dict(j(xs)) == want
    neg = [-x for x in xs]
    assert dict(m(neg)) == dict(j(neg))


def test_count_fold_threads_vs_mesh():
    xs = list(range(23))
    m, j = _both(lambda c: c.reduce_by_key(N.mod5, "count", nkeys=5))
    want = {k: sum(1 for x in xs if x % 5 == k) for k in range(5)}
    assert dict(m(xs)) == dict(j(xs)) == want


def test_mesh_float_fold_tolerance():
    xs = [0.25 * i for i in range(40)]
    m, j = _both(lambda c: c.reduce_by_key(N.mod2int, "sum", nkeys=2))
    t = dict(lower(reduce_by_key(N.mod2int, "sum", nkeys=2), "threads")(xs))
    got, ref = dict(m(xs)), dict(j(xs))
    assert set(got) == set(ref) == set(t)
    for k in t:
        np.testing.assert_allclose(got[k], ref[k], rtol=F_RTOL)
        np.testing.assert_allclose(got[k], t[k], rtol=1e-5)


def test_pre_maps_before_the_shuffle():
    xs = list(range(-20, 40))
    m, j = _both(lambda c: c.Pipeline(c.Stage(N.double), c.Stage(N.f),
                                      c.reduce_by_key(N.mod7, "max", nkeys=7)))
    assert dict(m(xs)) == dict(j(xs))


def test_mesh_rejects_out_of_range_keys():
    m, j = _both(lambda c: c.reduce_by_key(N.mod7, "sum", nkeys=5))
    for prog, err in ((m, LoweringError), (j, jcore.LoweringError)):
        with pytest.raises(err, match="nkeys"):
            prog(range(35))
    assert dict(RBK_M(range(35))) == dict(RBK_J(range(35))) == \
        ref_rbk(range(35), N.mod5, lambda a, b: a + b)
    neg, _ = _both(lambda c: c.reduce_by_key(N.double, "sum", nkeys=5))
    with pytest.raises(LoweringError, match=r"\[-4, 0\]"):
        neg([-2, -1, 0])


@pytest.mark.parametrize("build,match", [
    (lambda c: c.AllToAll(N.double, N.double, by=N.mod3, nright=2), "keyed"),
    (lambda c: c.reduce_by_key(N.mod3, N.keep_larger, nkeys=3), "keyed"),
    (lambda c: c.reduce_by_key(N.mod3, "sum"), "nkeys"),
    (lambda c: c.Pipeline(c.reduce_by_key(N.mod3, "sum", nkeys=3),
                          c.Stage(N.second)), "ONE AllToAll"),
    (lambda c: rekey_reduce(reduce_by_key(N.mod5, "sum", nkeys=5, nright=2),
                            N.mod10_pair, N.add_val, init=0.0, combine=N.add2)
     if c is tcore else c.rekey_reduce(
         c.reduce_by_key(N.mod5, "sum", nkeys=5, nright=2), N.mod10_pair,
         N.add_val, init=0.0, combine=N.add2), "exactly one"),
])
def test_mesh_rejects_what_the_keyed_program_cannot_express(build, match):
    with pytest.raises(LoweringError, match=match):
        lower(build(tcore), "mesh", device=CPU)
    with pytest.raises(jcore.LoweringError, match=match):
        jcore.lower(build(jcore), "mesh")


def test_three_backend_parity_with_batched_zero_copy_procs():
    xs = list(range(64))
    want = ref_rbk(xs, N.mod5, lambda a, b: a + b)
    assert dict(lower(_rbk5(tcore), "procs", batch=8, zero_copy=True)(xs)) \
        == want
    assert dict(RBK_M(xs)) == dict(RBK_J(xs)) == want
    tcore.pool_shutdown()


# -- tests/test_obs.py and tests/test_monitor.py: program-level telemetry ----
def test_mesh_program_level_events():
    prog = lower(Farm(N.double, nworkers=2), "mesh", device=CPU, trace=True,
                 metrics=True)
    out = prog([float(x) for x in range(32)])
    assert out == [2.0 * x for x in range(32)]
    tr = prog.last_trace
    assert tr.qualnames() == ["mesh-program"]
    kinds = [e[0] for e in tr.events()]
    assert kinds == ["devices", "compile", "call"]
    dev = next(e for e in tr.events() if e[0] == "devices")
    assert dev[3] == {"devices": 1, "n_stage": 1, "n_worker": 1}
    prog([float(x) for x in range(32)])
    assert prog.metrics.counter("mesh.compiles").value == 1
    assert prog.metrics.counter("mesh.calls").value == 2
    assert prog.metrics.counter("mesh.items").value == 64
    rep = prog.last_report
    assert rep.gauges["mesh.devices"] == 1
    assert rep.hists["mesh.call_us"]["count"] == 2
    assert rep.meta == {"backend": "mesh", "n_stage": 1, "n_worker": 1}
    jprog = jcore.lower(jcore.Farm(N.double, nworkers=2), "mesh", trace=True,
                        metrics=True)
    jprog([float(x) for x in range(32)])
    jprog([float(x) for x in range(32)])
    assert sorted(jprog.last_report.counters) == sorted(rep.counters)
    assert {k: v for k, v in jprog.last_report.counters.items()} == \
        rep.counters
    assert [e[0] for e in jprog.last_trace.events()] == \
        ["devices", "compile", "call", "call"]
    assert [e[0] for e in prog.last_trace.events()] == \
        ["devices", "compile", "call", "call"]


def test_keyed_program_level_events():
    prog = lower(_rbk5(tcore), "mesh", device=CPU, trace=True, metrics=True)
    assert dict(prog(range(20))) == ref_rbk(range(20), N.mod5,
                                            lambda a, b: a + b)
    assert [e[0] for e in prog.last_trace.events()] == \
        ["devices", "compile", "call"]
    assert prog.last_report.counters == {"mesh.calls": 1, "mesh.items": 20,
                                         "mesh.compiles": 1}
    assert prog.last_report.meta["rows"] == 64


def test_mesh_program_level_frames():
    mon = Monitor()
    prog = lower(Farm(N.double, nworkers=2), "mesh", device=CPU, monitor=mon)
    prog([float(x) for x in range(16)])
    prog([float(x) for x in range(16)])
    frames = mon.timeline.frames()
    assert len(frames) == 2, len(frames)
    for fr in frames:
        assert not fr["depths"] and not fr["ewma_us"]
        assert {"mesh.calls", "mesh.items", "mesh.compiles",
                "mesh.devices", "mesh.call_us"} == set(fr["counters"])
    assert frames[1]["counters"]["mesh.calls"] == 2
    assert frames[1]["counters"]["mesh.items"] == 32
    assert frames[1]["counters"]["mesh.compiles"] == \
        frames[0]["counters"]["mesh.compiles"] == 1
    jmon = jcore.Monitor()
    jprog = jcore.lower(jcore.Farm(N.double, nworkers=2), "mesh",
                        monitor=jmon)
    jprog([float(x) for x in range(16)])
    jprog([float(x) for x in range(16)])
    strip = [{k: v for k, v in fr["counters"].items() if k != "mesh.call_us"}
             for fr in jmon.timeline.frames()]
    assert strip == [{k: v for k, v in fr["counters"].items()
                      if k != "mesh.call_us"} for fr in frames]


# -- the device farm against the reference's, one device each ----------------
def _jax_one_device(body, *arrays):
    """``body`` under a one-device ``shard_map`` on the JAX CPU device."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro import compat
    mesh = compat.make_mesh((1,), ("w",))
    fn = jax.jit(compat.shard_map(body, mesh=mesh,
                                  in_specs=tuple(P("w") for _ in arrays),
                                  out_specs=P("w"), check_vma=False))
    return np.asarray(fn(*arrays))


def _items(seed, L, d, kind):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-50, 50, (L, d)).astype(np.int32)
    return rng.standard_normal((L, d)).astype(np.float32)


@pytest.mark.parametrize("L,d,cap,kind", [(10, 1, 11, "int"), (37, 3, 37, "f32"),
                                          (16, 2, 8, "int"), (9, 4, 1, "f32")])
def test_dispatch_and_combine_equal_the_reference(L, d, cap, kind):
    """Bucket positions, overflow dropping past ``capacity``, and the
    ordered combine (dropped rows come back as zeros), exactly."""
    from repro.core import dfarm as jdfarm
    x = _items(L * d, L, d, kind)
    dest = np.zeros(L, np.int32)
    recv, info = dfarm.dispatch(torch.from_numpy(x), torch.from_numpy(dest),
                                1, cap)
    want = _jax_one_device(lambda a, b: jdfarm.dispatch(a, b, "w", cap)[0],
                           x, dest)
    np.testing.assert_array_equal(recv.numpy(), want)
    back = dfarm.combine(recv * 2, info, 1)
    want_back = _jax_one_device(
        lambda a, b: jdfarm.combine(
            jdfarm.dispatch(a, b, "w", cap)[0] * 2,
            jdfarm.dispatch(a, b, "w", cap)[1], "w"), x, dest)
    np.testing.assert_array_equal(back.numpy(), want_back)
    assert int(info[2].sum()) == min(L, cap)


@pytest.mark.parametrize("kind", ["int", "f32"])
def test_farm_map_equals_the_reference(kind):
    from repro.core import dfarm as jdfarm
    x = _items(7, 50, 2, kind)
    dest = np.zeros(50, np.int32)
    got = dfarm.farm_map(N.f, torch.from_numpy(x), torch.from_numpy(dest), 1,
                         51)
    want = _jax_one_device(lambda a, b: jdfarm.farm_map(N.f, a, b, "w", 51),
                           x, dest)
    if kind == "int":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=F_RTOL,
                                   atol=F_ATOL)


@pytest.mark.parametrize("max_trips", [None, 1, 3])
def test_farm_until_equals_the_reference(max_trips):
    """The do-while loop with the validity flag: padding rows (valid 0)
    never keep it going, and max_trips bounds it."""
    from repro.core import dfarm as jdfarm
    rng = np.random.default_rng(11)
    x = rng.integers(0, 70, (40, 1)).astype(np.int32)
    valid = (rng.random(40) < 0.8).astype(np.int32)
    dest = np.zeros(40, np.int32)
    got = dfarm.farm_until(N.fb_step, N.fb_pred, torch.from_numpy(x),
                           torch.from_numpy(dest), 1, 41,
                           valid=torch.from_numpy(valid), max_trips=max_trips)
    want = _jax_one_device(lambda a, b, v: jdfarm.farm_until(
        N.fb_step, N.fb_pred, a, b, "w", 41, valid=v, max_trips=max_trips),
        x, dest, valid)
    np.testing.assert_array_equal(got.numpy(), want)


def test_roundrobin_dest_and_utilisation_equal_the_reference():
    from repro.core import dfarm as jdfarm
    got = dfarm.roundrobin_dest(13, 1)
    want = _jax_one_device(lambda a: jdfarm.roundrobin_dest(13, "w"),
                           np.zeros(13, np.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert dfarm.roundrobin_dest(6, 4).tolist() == [0, 1, 2, 3, 0, 1]
    for n in range(0, 40):
        for w in range(0, 9):
            assert dfarm.farm_utilisation(n, w) == \
                jdfarm.farm_utilisation(n, w)


def test_device_farm_of_sw_scores_equals_sw_plain():
    """The device farm of chip_smoke.py's phase 12 at a small size: rows
    of padded subject residues (codes >= 24 are padding) scored by
    sw_batch's plain version, each row's column 0 carrying its score,
    equal to sw_plain and to the reference's oracle."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops
    from repro_torch.kernels import smith_waterman as sw
    rng = np.random.default_rng(8)
    query = rng.integers(0, 20, 40).astype(np.int32)
    prof, q_len = ops.build_profile(torch.from_numpy(query), ops.BLOSUM50)
    A = ops.BLOSUM50.shape[0]
    subjects = [rng.integers(0, 20, n).astype(np.int32)
                for n in rng.integers(2, 60, 9)]
    padded, _ = sw.pack_subjects(subjects, A, CPU)

    def score_rows(x):
        y = torch.zeros_like(x)
        y[:, 0] = sw.sw_batch(prof, x.contiguous(), gap_open=10.0,
                              gap_extend=2.0, q_len=q_len).to(torch.int32)
        return y

    out = lower(Farm(score_rows, 2, ordered=True), "mesh", device=CPU)(
        list(padded.numpy()))
    got = [row[0] for row in out]
    assert got == [int(v) for v in sw.sw_plain(prof, padded, 10.0, 2.0,
                                                q_len).tolist()]
    jprof, _ = jops.build_profile(jnp.asarray(query))
    assert got == [int(jref.sw_ref(jprof, jnp.asarray(s), 10.0, 2.0))
                   for s in subjects]
