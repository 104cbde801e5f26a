"""The port's mesh programs over rank processes (``lower(.., "mesh",
devices=n, transport="gloo")`` on CPU ranks) against the reference's mesh
backend over 4 forced JAX host devices: ``MeshProgram`` at 4 devices
negotiating ``(2, 2)`` (the pipeline over farms of
``tests/test_multidevice.py``) and at ``(1, 4)``, the Feedback loop,
``A2AMeshProgram`` over 2 and 4 ranks, the tuned program's
``plan_mesh(devices=4)``; the trace and metrics of a program over ranks;
and the refusals: a lambda with ``devices > 1``, more ranks than cards
without ``transport=``, a factorization beyond the devices, keys out of
range on every rank alike.

Integer outputs and key→fold maps are compared exactly; float streams to
1e-6 relative (XLA may fuse ``3x + 1`` into one multiply-add where torch
rounds twice, as in ``tests/test_torch_mesh.py``).  One reference
subprocess computes every reference output at once."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _procs_nodes as N
import _torch_rank_jobs as J
import repro.core as jcore
import repro_torch.core as tcore
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import LoweringError, lower, ranks, reduce_by_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", transport="gloo")
F_RTOL, F_ATOL = 1e-6, 1e-5
XS = list(range(-50, 163))
FL = [0.37 * x for x in XS]
FB_XS = list(range(200))
RBK_XS = [int(v) for v in np.random.default_rng(5).integers(-900, 900, 700)]
FOLDS = ("sum", "min", "max", "count")

REFERENCE = """
import json, sys
sys.path.insert(0, sys.argv[2])
import _procs_nodes as N
from repro.core import Farm, Feedback, Pipeline, lower, reduce_by_key
xs, fl, fb_xs, rbk_xs = json.loads(sys.argv[3])
out = {}
skel = Pipeline(Farm(N.f, 4, ordered=True), Farm(N.g, 4, ordered=True))
for name, fact in (("auto", None), ("1x4", (1, 4)), ("2x2", (2, 2))):
    prog = lower(skel, "mesh", grain=8, factorization=fact)
    out["pipe_" + name] = [[prog.n_stage, prog.n_worker], prog(xs), prog(fl)]
fb = lower(Feedback(N.fb_step, N.fb_pred, max_trips=32), "mesh")
out["fb"] = [fb.n_worker, fb(fb_xs)]
for devs in (2, 4):
    for fold in ("sum", "min", "max", "count"):
        prog = lower(reduce_by_key(N.mod5, fold, nkeys=5), "mesh", devices=devs)
        out["rbk_%d_%s" % (devs, fold)] = sorted(prog(rbk_xs))
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(path),
         os.path.join(ROOT, "tests"), json.dumps([XS, FL, FB_XS, RBK_XS])],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module", autouse=True)
def rank_pools():
    """The mesh programs start their pools on first use; retire them all
    when the module is done, and check that nothing is left."""
    yield
    pools = list(ranks._POOLS.values())
    procs = [p for pool in pools for p in pool._procs]
    dirs = [pool._dir for pool in pools]
    ranks.shutdown()
    assert not ranks._POOLS
    assert not any(p.is_alive() for p in procs)
    assert not any(d and os.path.exists(d) for d in dirs)


def _pipe(c):
    return c.Pipeline(c.Farm(N.f, 4, ordered=True), c.Farm(N.g, 4, ordered=True))


@pytest.mark.parametrize("name,fact", [("auto", None), ("1x4", (1, 4)),
                                       ("2x2", (2, 2))])
def test_mesh_program_over_4_ranks_equals_the_reference(ref, name, fact):
    """Four devices negotiate (2, 2) for two stages: each stage row runs
    its farm over its two workers and microbatches of 8 rows stream down
    the columns; (1, 4) runs both farms in order over four workers."""
    prog = lower(_pipe(tcore), "mesh", devices=4, grain=8,
                 factorization=fact, **CPU)
    shape, want, want_fl = ref["pipe_" + name]
    assert [prog.n_stage, prog.n_worker] == shape
    got = prog(XS)
    assert got == want == lower(_pipe(tcore), "threads")(XS)
    np.testing.assert_allclose(prog(FL), want_fl, rtol=F_RTOL, atol=F_ATOL)
    assert prog.pool.world == 4 and prog.pool.transport == "gloo"


def test_negotiated_grid_is_two_by_two():
    prog = lower(_pipe(tcore), "mesh", devices=4, **CPU)
    assert (prog.n_stage, prog.n_worker) == (2, 2)
    single = lower(tcore.Farm(N.f, 4, ordered=True), "mesh", devices=4, **CPU)
    assert (single.n_stage, single.n_worker) == (1, 4)


def test_feedback_over_4_ranks_equals_the_reference(ref):
    fb = lower(tcore.Feedback(N.fb_step, N.fb_pred, max_trips=32), "mesh",
               devices=4, **CPU)
    n_worker, want = ref["fb"]
    assert fb.n_worker == n_worker == 4
    assert fb(FB_XS) == want == [N.fb_ref(x) for x in FB_XS]


@pytest.mark.parametrize("devs", [2, 4])
@pytest.mark.parametrize("fold", FOLDS)
def test_keyed_mesh_over_ranks_equals_the_reference(ref, devs, fold):
    """Rows travel to rank ``key % W`` and fold there; the segments come
    back in key order, equal to the reference's and to threads'."""
    skel = reduce_by_key(N.mod5, fold, nkeys=5)
    prog = lower(skel, "mesh", devices=devs, **CPU)
    assert prog.n_worker == devs
    got = sorted(prog(RBK_XS))
    assert [list(kv) for kv in got] == ref[f"rbk_{devs}_{fold}"]
    assert dict(got) == dict(lower(skel, "threads")(RBK_XS))


def test_keys_out_of_range_are_refused_on_every_rank_alike():
    """Every rank learns the key range (one all-reduce) and refuses; the
    pool stays open for the next call."""
    prog = lower(reduce_by_key(N.double, "sum", nkeys=10), "mesh", devices=4,
                 **CPU)
    with pytest.raises(LoweringError, match=r"keys in \[0, 198\].*nkeys=10"):
        prog(list(range(100)))
    assert not prog.pool.closed
    assert dict(prog([1, 2, 3, 4])) == {2: 1, 4: 2, 6: 3, 8: 4}


def test_a_call_that_fails_on_one_rank_restarts_the_ranks(monkeypatch):
    """A worker that raises in one rank leaves the others waiting in the
    farm's exchange: the call raises that rank's error and closes the
    pool, and the next call starts fresh ranks instead of failing on a
    closed pool."""
    monkeypatch.setattr(ranks, "_GRACE_S", 1.0)
    prog = lower(tcore.Farm(J.fail_on_rank_one, 2), "mesh", devices=2, **CPU)
    with pytest.raises(ValueError, match="worker failed on rank 1"):
        prog([1, 2, 3, 4])
    first = prog.pool
    assert first.closed
    with pytest.raises(ValueError, match="worker failed on rank 1"):
        prog([1, 2, 3, 4])
    assert prog.pool is not first


def test_trace_and_metrics_of_a_program_over_ranks():
    prog = lower(_pipe(tcore), "mesh", devices=4, trace=True, metrics=True,
                 **CPU)
    assert prog(XS[:40]) == [N.g(N.f(x)) for x in XS[:40]]
    events = prog.last_trace.lane("mesh-program").events
    assert [e[0] for e in events] == ["devices", "compile", "call"]
    assert events[0][3] == {"devices": 4, "n_stage": 2, "n_worker": 2,
                            "transport": "gloo"}
    rep = prog.last_report
    assert rep.gauges["mesh.devices"] == 4
    assert rep.meta["n_stage"] == 2 and rep.meta["n_worker"] == 2
    assert prog.metrics.counter("mesh.compiles").value == 1


def test_tuned_mesh_plans_over_4_devices_as_the_reference():
    """``tune=True`` on 4 ranks: the pilot on threads, then the plan of
    ``plan_mesh(devices=4)`` — the reference's plan from the same profile
    (JSON either package reads) — and the tuned program over the ranks."""
    from repro.core import autotune as jat
    from repro_torch.core import autotune as tat
    xs = list(range(600))
    tp = lower(_pipe(tcore), "mesh", tune=True, tune_pilot=200, devices=4,
               **CPU)
    assert tp(xs) == lower(_pipe(tcore), "threads")(xs)
    plan = tat.plan_mesh(tp.profile, _pipe(tcore), devices=4)
    want = jat.plan_mesh(jat.Profile.from_json(tp.profile.to_json()),
                         _pipe(jcore), devices=4)
    assert plan == want
    assert (tp.tuned.n_stage, tp.tuned.n_worker) == tuple(
        plan["factorization"])


# -- the refusals ---------------------------------------------------------------
def test_a_lambda_over_more_than_one_device_is_refused():
    with pytest.raises(LoweringError, match="picklable"):
        lower(tcore.Farm(lambda x: x + 1, 2), "mesh", devices=2, **CPU)
    with pytest.raises(LoweringError, match="picklable"):
        lower(reduce_by_key(lambda x: x % 3, "sum", nkeys=3), "mesh",
              devices=2, **CPU)
    # one device runs in this process and keeps taking lambdas
    one = lower(tcore.Farm(lambda x: x + 1, 2), "mesh", device="cpu")
    assert one([1, 2]) == [2, 3]


@pytest.mark.parametrize("skel", [_pipe, lambda c: reduce_by_key(N.mod5, "sum",
                                                                  nkeys=5)])
def test_more_ranks_than_cards_need_an_explicit_transport(monkeypatch, skel):
    """Four ranks on one card without ``transport=``: NCCL cannot share a
    card, and nothing switches to gloo behind the caller's back."""
    monkeypatch.setattr(ranks, "card_count", lambda: 1)
    with pytest.raises(LoweringError, match='transport="gloo"'):
        lower(skel(tcore), "mesh", devices=4)
    with pytest.raises(LoweringError, match='transport="gloo"'):
        lower(skel(tcore), "mesh", devices=4, transport="nccl")
    with pytest.raises(LoweringError, match='transport="gloo"'):
        lower(skel(tcore), "mesh", devices=2, device="cpu")
    assert ranks.plan_ranks(4, None, "gloo") == (["cuda:0"] * 4, "gloo")
    monkeypatch.setattr(ranks, "card_count", lambda: 4)
    assert ranks.plan_ranks(4) == ([f"cuda:{r}" for r in range(4)], "nccl")
    with pytest.raises(LoweringError, match="unknown transport"):
        ranks.plan_ranks(2, "cpu", "mpi")


@pytest.mark.parametrize("fact", [(3, 1), (2, 3), (1, 5)])
def test_a_factorization_beyond_the_devices_is_refused(fact):
    """``tests/test_autotune.py``'s refusals: three stages of a two-stage
    skeleton, six devices of four; the reference refuses them too."""
    with pytest.raises(jcore.LoweringError):
        jcore.lower(_pipe(jcore), "mesh", devices=4, factorization=fact)
    with pytest.raises(LoweringError, match="not expressible on 4 devices"):
        lower(_pipe(tcore), "mesh", devices=4, factorization=fact, **CPU)
