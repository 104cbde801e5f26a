"""The port's live monitor (``repro_torch.core.monitor``) against the
reference's (``repro.core.monitor``).

What is deterministic is held equal to the reference, as JSON: ``analyze``
on the same scripted frames and on the same scripted ``Trace`` (identical
``BottleneckReport.to_json()``), the ``Timeline`` ring and its JSON (each
package reads what the other writes), the Chrome counter tracks, the
``DriftWatcher`` and ``SLOMonitor`` latches on scripted series, and the
CLI's rendering of a timeline and of a run report (the same text).

A live run is not deterministic, so the live cases check only what every
run must show: a monitor on threads and on procs samples a monotone
``items_out`` that ends at the stream's length, with no absorbed error,
and the same backend-neutral depth taps on both backends.  No case copies
the reference's single-run verdicts (which stage a live run blames): they
are timing-dependent (ROADMAP §3).  ``monitor=None`` never imports the
module."""
import json
import os
import subprocess
import sys
import tracemalloc

import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import monitor as jmon
from repro_torch.core import (Farm, Pipeline, Stage, lower, pool_shutdown)
from repro_torch.core import monitor as tmon
from repro_torch.core.obs import Histogram, MetricsRegistry, Tracer
from repro.core.obs import (Histogram as JHistogram,
                            MetricsRegistry as JMetricsRegistry,
                            Tracer as JTracer)
from tests._procs_nodes import fast_stage, slow_stage

ROOT = os.path.join(os.path.dirname(__file__), "..")
SKEW = Pipeline(Stage(fast_stage), Stage(slow_stage))
N_SKEW = 60
WANT_SKEW = sorted(slow_stage(fast_stage(x)) for x in range(N_SKEW))


@pytest.fixture(autouse=True, scope="module")
def retire_pool():
    yield
    pool_shutdown()


# -- scripted frames: a skewed pipeline, a saturated farm, a balanced run ----
def _frames(kind, n=40):
    out = []
    for i in range(n):
        t = 100.0 + 0.002 * i
        if kind == "skewed-pipeline":
            depths = {"ff-source@in": 30 + i % 3, "ff-stage@0": 25 + i % 5,
                      "ff-stage@1": i % 2, "ff-stage@2": 0}
        elif kind == "saturated-farm":
            depths = {"ff-source@in": 5, "ff-stage@0": 2,
                      "ff-emitter@1": 40 - i % 4, "ff-worker@1.0": 9,
                      "ff-worker@1.1": 11 + i % 3, "ff-collector@1": 0,
                      "ff-stage@2": 1}
        elif kind == "balanced":
            depths = {"ff-source@in": i % 2, "ff-stage@0": 0,
                      "ff-stage@1": 0}
        else:                                   # "a2a": rows share one position
            depths = {"ff-source@in": 3, "ff-a2a-scatter@0": 12,
                      "ff-a2a@0.left.0": 8, "ff-a2a@0.right.1": 0,
                      "ff-stage@1": 2}
        out.append({"t": t, "depths": depths,
                    "ewma_us": {"ff-farm@1": 10.0 + i} if "farm" in kind else {},
                    "counters": {"items_out": 3 * i, "ff-farm@1.emitted": 4 * i}})
    return out


KINDS = ["skewed-pipeline", "saturated-farm", "balanced", "a2a"]


@pytest.mark.parametrize("kind", KINDS)
def test_analyze_frames_equals_the_reference(kind):
    frames = _frames(kind)
    mine, ref = tmon.Timeline(), jmon.Timeline()
    for fr in frames:
        mine.append(dict(fr))
        ref.append(dict(fr))
    a, b = tmon.analyze(mine), jmon.analyze(ref)
    assert a.to_json() == b.to_json()
    assert a.render() == b.render()
    assert tmon.analyze(mine.to_json()).to_json() == b.to_json()
    assert tmon.analyze(mine, min_depth=100.0).to_json() == \
        jmon.analyze(ref, min_depth=100.0).to_json()


def _scripted_trace(pkg_tracer, kind):
    tr = pkg_tracer()
    spans = {"two-stages": [("ff-stage", "0", 0.2), ("ff-stage", "1", 2.0)],
             "farm": [("ff-source", "in", 0.1), ("ff-worker", "1.0", 1.5),
                      ("ff-worker", "1.1", 1.4), ("ff-collector", "1", 0.2)]}
    if kind == "empty":
        tr.vertex("ff-stage", "0")
        return tr.trace()
    for name, path, dur in spans[kind]:
        lane = tr.vertex(name, path)
        for k in range(10):
            t0 = 50.0 + k * 3.0
            lane.span("svc", t0, t0 + dur)
        lane.span("life", 50.0, 80.0)
    return tr.trace()


@pytest.mark.parametrize("kind", ["two-stages", "farm", "empty"])
def test_analyze_trace_equals_the_reference(kind):
    a = tmon.analyze(_scripted_trace(Tracer, kind))
    b = jmon.analyze(_scripted_trace(JTracer, kind))
    assert a.to_json() == b.to_json()
    assert a.render() == b.render()


def test_analyze_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="timeline/1"):
        tmon.analyze({"schema": "run-report/1"})
    with pytest.raises(TypeError):
        tmon.analyze(42)


# -- the timeline ring and its JSON ------------------------------------------
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_timeline_json_reads_in_the_other_package(tmp_path, writer):
    W, R = (tmon, jmon) if writer == "port" else (jmon, tmon)
    tl = W.Timeline(capacity=4)
    for i in range(7):
        tl.append({"t": float(i), "depths": {"v": i}, "ewma_us": {},
                   "counters": {"items_out": i}})
    assert [f["t"] for f in tl.frames()] == [3.0, 4.0, 5.0, 6.0]
    assert tl.dropped == 3 and tl.span_s() == 3.0
    path = str(tmp_path / "tl.json")
    tl.save(path)
    back = R.Timeline.load(path)
    assert back.schema == "timeline/1"
    assert back.frames() == tl.frames() and back.dropped == 3
    assert back.to_json() == tl.to_json()
    with open(path) as f:
        assert tmon.analyze(json.load(f)).frames == 4
    with pytest.raises(ValueError):
        R.Timeline.from_json({"schema": "nope"})


@pytest.mark.parametrize("kind", KINDS)
def test_chrome_counter_tracks_equal_the_reference(kind):
    mine, ref = tmon.Timeline(), jmon.Timeline()
    for fr in _frames(kind, 6):
        mine.append(fr)
        ref.append(fr)
    assert mine.chrome_events(pid=3) == ref.chrome_events(pid=3)


# -- drift watcher and SLO monitor on scripted series ------------------------
def _saved(mod, service_us):
    return mod.Profile(handoff_us=1.0, pilot_items=50, stages=[
        mod.StageProfile(path="1", kind="farm", name="ff-farm",
                         service_us=service_us, service_ewma_us=service_us,
                         items=50),
        mod.StageProfile(path="2", kind="stage", name="ff-stage",
                         service_us=10.0, service_ewma_us=10.0, items=50)])


DRIFT_SERIES = [{"ff-farm@1": 120.0}, {"ff-farm@1": 200.0},
                {"ff-farm@1": 210.0, "ff-stage@2": 30.0},
                {"ff-farm@1": 500.0, "ff-stage@2": 11.0},
                {"ff-farm@1": 160.0}, {"ff-farm@1": 110.0},
                {"ff-farm@1": 300.0, "ff-stage@3": 1.0}, {"nope": 5.0},
                {"ff-stage@2": 40.0}, {"ff-farm@1": 0.0}]


@pytest.mark.parametrize("threshold", [0.5, 1.0, 3.0])
def test_drift_watcher_fires_and_latches_like_the_reference(threshold):
    from repro.core import autotune as jat
    from repro_torch.core import autotune as tat
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    seen, jseen = [], []
    reg.watch(lambda rep: seen.append(rep.meta))
    jreg.watch(lambda rep: jseen.append(rep.meta))
    w = tmon.DriftWatcher(_saved(tat, 100.0), threshold=threshold,
                          registry=reg)
    jw = jmon.DriftWatcher(_saved(jat, 100.0), threshold=threshold,
                           registry=jreg)
    for live in DRIFT_SERIES:
        assert w.check(live) == jw.check(live)
    assert w.events == jw.events and seen == jseen
    assert reg.counter("monitor.drift_alerts").value == len(w.events) == \
        jreg.counter("monitor.drift_alerts").value


def test_drift_watcher_reads_a_saved_profile_path(tmp_path):
    from repro.core import autotune as jat
    path = str(tmp_path / "saved.json")
    _saved(jat, 100.0).save(path)
    w = tmon.DriftWatcher(path, threshold=0.5)
    assert [e["path"] for e in w.check({"ff-farm@1": 300.0})] == ["1"]


def _hist(mod, v, n=50):
    h = mod("serve.request_latency_us")
    for _ in range(n):
        h.observe(v)
    return h


def test_slo_monitor_latency_and_goodput_latch_like_the_reference():
    """The same series of latency histograms and goodput rates: the same
    alerts, the same slo.alerts count, the same alert instants on an
    slo-monitor lane."""
    tr, jtr = Tracer(), JTracer()
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    slo = tmon.SLOMonitor(p99_us=10_000.0, min_goodput=100.0, registry=reg)
    jslo = jmon.SLOMonitor(p99_us=10_000.0, min_goodput=100.0, registry=jreg)
    assert slo.bind(tr) is slo
    jslo.bind(jtr)
    series = [(50_000.0, 40.0), (50_000.0, 35.0), (1_000.0, 150.0),
              (60_000.0, 10.0), (9_999.0, 100.0), (None, 99.9),
              (None, None), (20_000.0, 500.0)]
    for lat, good in series:
        h = None if lat is None else _hist(Histogram, lat)
        jh = None if lat is None else _hist(JHistogram, lat)
        assert slo.check(h, goodput=good) == jslo.check(jh, goodput=good)
    assert slo.events == jslo.events and len(slo.events) == 6
    assert reg.counter("slo.alerts").value == len(slo.events) == \
        jreg.counter("slo.alerts").value
    inst = [e[3] for e in tr.trace().events() if e[0] == "alert"]
    assert inst == [e[3] for e in jtr.trace().events() if e[0] == "alert"]
    assert inst == slo.events
    assert tr.trace().qualnames() == ["slo-monitor"]
    assert tmon.SLOMonitor().check(_hist(Histogram, 1e9), goodput=0.0) == []


# -- the CLI -----------------------------------------------------------------
def _cli(module, path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module, path], env=env,
                          capture_output=True, text=True, timeout=120)


def test_cli_renders_a_timeline_and_a_report_like_the_reference(tmp_path):
    tl = tmon.Timeline()
    for fr in _frames("skewed-pipeline", 12):
        tl.append(fr)
    tl_path = str(tmp_path / "timeline.json")
    tl.save(tl_path)
    reg = MetricsRegistry()
    reg.counter("serve.requests").inc(8)
    reg.histogram("serve.request_latency_us").observe(1234.5)
    rep_path = str(tmp_path / "report.json")
    reg.report(queues={"ff-stage@0": 3, "ff-stage@1": 9},
               meta={"backend": "threads", "items_in": 8}).save(rep_path)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"schema": "nope/9"}, f)
    for path, rc in ((tl_path, 0), (rep_path, 0), (bad, 2)):
        mine = _cli("repro_torch.core.monitor", path)
        ref = _cli("repro.core.monitor", path)
        assert mine.returncode == ref.returncode == rc, mine.stderr
        assert mine.stdout == ref.stdout
    out = _cli("repro_torch.core.monitor", tl_path).stdout
    assert "ff-monitor: 12 frames" in out and "bottleneck:" in out
    assert "run-report/1 summary" in _cli("repro_torch.core.monitor",
                                          rep_path).stdout


# -- monitor off: the module is never imported, nothing allocated ------------
def test_monitor_off_never_imports_the_monitor():
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "from _procs_nodes import f, g\n"
            "from repro_torch.core import Farm, Pipeline, lower\n"
            "p = lower(Pipeline(Farm(f, 2, ordered=True), g), 'threads',"
            " metrics=True)\n"
            "assert p(range(50)) == [g(f(x)) for x in range(50)]\n"
            "assert 'repro_torch.core.monitor' not in sys.modules\n"
            "assert 'torch' not in sys.modules\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_monitor_off_allocates_nothing():
    prog = lower(SKEW, "threads")
    prog(range(N_SKEW))
    tracemalloc.start()
    try:
        assert sorted(prog(range(N_SKEW))) == WANT_SKEW
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    allocs = snap.filter_traces([tracemalloc.Filter(True, tmon.__file__)])
    assert sum(s.size for s in allocs.statistics("filename")) == 0


# -- live runs: what every run must show -------------------------------------
def _monotone(tl, key):
    vals = [fr["counters"][key] for fr in tl.frames() if key in fr["counters"]]
    assert vals, f"counter {key!r} never sampled"
    assert all(a <= b for a, b in zip(vals, vals[1:])), (key, vals)
    return vals


def _depth_quals(tl):
    return set().union(*(fr["depths"] for fr in tl.frames()))


def test_live_monitor_on_threads_and_procs():
    quals = {}
    for backend in ("threads", "procs"):
        mon = tmon.Monitor(interval_s=0.001)
        prog = lower(SKEW, backend, monitor=mon, metrics=True)
        assert sorted(prog(range(N_SKEW))) == WANT_SKEW
        tl = mon.timeline
        assert tl.frames() and mon.errors == 0, (backend, mon.errors)
        assert _monotone(tl, "items_out")[-1] == N_SKEW
        rep = tmon.analyze(tl)
        assert rep.frames == len(tl) and rep.verdict in (
            "queue-bound", "balanced")
        assert prog.last_report.meta["items_out"] == N_SKEW
        quals[backend] = _depth_quals(tl)
    assert quals["threads"] == quals["procs"]
    assert {"ff-source@in", "ff-stage@0", "ff-stage@1"} <= quals["threads"]


def test_procs_farm_live_boards_monotone():
    mon = tmon.Monitor(interval_s=0.001)
    prog = lower(Pipeline(Stage(fast_stage), Farm(slow_stage, nworkers=2)),
                 "procs", monitor=mon)
    assert sorted(prog(range(40))) == sorted(slow_stage(fast_stage(x))
                                             for x in range(40))
    em = _monotone(mon.timeline, "ff-farm@1.emitted")
    co = _monotone(mon.timeline, "ff-farm@1.collected")
    assert em[-1] == co[-1] == 40 and mon.errors == 0
    for fr in mon.timeline.frames():
        c = fr["counters"]
        if "ff-farm@1.emitted" in c and "ff-farm@1.collected" in c:
            assert c["ff-farm@1.collected"] <= c["ff-farm@1.emitted"], c


def test_drift_fires_exactly_once_mid_run_threads():
    """slow_stage sleeps 2 ms against a saved 100 µs: the per-frame
    checks alert once for the whole excursion."""
    from repro_torch.core import autotune as tat
    reg = MetricsRegistry()
    alerts = []
    reg.watch(lambda rep: alerts.append(rep.meta))
    mon = tmon.Monitor(interval_s=0.001, profile=_saved(tat, 100.0),
                       drift_threshold=3.0, registry=reg)
    prog = lower(Pipeline(Stage(fast_stage), Farm(slow_stage, nworkers=2)),
                 "threads", monitor=mon)
    prog(range(80))
    drift = [e for e in mon.drift.events if e["path"] == "1"]
    assert len(drift) == 1 and drift[0]["live_us"] > drift[0]["saved_us"]
    assert [a["event"] for a in alerts] == ["drift"]
    assert reg.counter("monitor.drift_alerts").value == 1


def test_monitored_traced_run_merges_counter_tracks():
    mon = tmon.Monitor(interval_s=0.001)
    prog = lower(SKEW, "threads", trace=True, monitor=mon)
    prog(range(N_SKEW))
    doc = prog.last_trace.to_chrome_json(timeline=mon.timeline)
    cev = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    names = {e["name"] for e in cev}
    assert any(n.startswith("depth:") for n in names) and "items_out" in names
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"
             and e["pid"] in {e["pid"] for e in cev}}
    assert "ff-monitor" in procs


def test_monitor_true_builds_one_and_attach_twice_raises():
    prog = lower(SKEW, "threads", monitor=True)
    assert isinstance(prog.monitor, tmon.Monitor)
    assert sorted(prog(range(10))) == sorted(slow_stage(fast_stage(x))
                                             for x in range(10))
    mon = tmon.Monitor()
    g = lower(SKEW, "threads").to_graph([1])
    mon.attach(g)
    with pytest.raises(RuntimeError, match="already attached"):
        mon.attach(g)
    mon.detach()
    assert mon.sample()["depths"] == {}     # detached: an empty frame
