"""The port's serving engine, on the CPU.

The port's form of tests/test_runtime.py:164-205 (order and isolation,
resume after a truncated run, recycled slots), and the port's
``ServeEngine`` against the reference's with the same converted weights:
the same greedy tokens per request (dense, hybrid and moe), and the same
refusal of audio (and, at construction, of vlm).
"""
import gc
import weakref

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import init_params as jinit
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.core import RunReport
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import init_params_spec

CPU = "cpu"


def _prompts(cfg, n, seed=1, lo=2, hi=6):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi)))]
            for _ in range(n)]


def test_serve_engine_order_and_isolation():
    cfg = ARCHS["phi3-mini-3.8b"].smoke()
    eng = ServeEngine(cfg, max_batch=3, max_len=128, seed=0, device=CPU)
    prompts = _prompts(cfg, 7)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=5))
    results = eng.run()
    assert len(results) == 7
    assert [r.tag for r in results] == list(range(7))  # order-preserving
    assert all(len(r.generated) == 5 for r in results)
    assert isinstance(eng.last_report, RunReport)
    assert eng.last_report.counters["serve.tokens"] == 35
    assert eng.last_report.meta["device"] == CPU
    # isolation: a request's output depends only on its own prompt
    eng2 = ServeEngine(cfg, max_batch=3, max_len=128, seed=0, device=CPU)
    eng2.submit(Request(rid=0, prompt=prompts[0], max_new=5))
    solo = eng2.run()[0]
    batched = next(r for r in results if r.rid == 0)
    assert solo.generated == batched.generated


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "zamba2-2.7b"])
def test_finished_engine_is_freed_without_the_garbage_collector(arch):
    """An engine that has served is freed, its parameters with it, when its
    last reference goes: nothing it built (the serving graph, whose
    vertices and graph refer to each other) holds it in a reference cycle.
    The collector stays off from construction to the probe."""
    cfg = ARCHS[arch].smoke()
    # torch's first operation on a meta tensor in a process imports modules
    # whose frames stay in a cycle, with the caller's frame: do it first
    init_params_spec(cfg)
    was_on = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        eng = ServeEngine(cfg, max_batch=2, max_len=64, seed=0, device=CPU)
        for i, p in enumerate(_prompts(cfg, 3)):
            eng.submit(Request(rid=i, prompt=p, max_new=3))
        assert len(eng.run()) == 3
        probe, params = weakref.ref(eng), weakref.ref(eng.params["embed"])
        del eng
        assert probe() is None and params() is None
    finally:
        if was_on:
            gc.enable()


def test_serve_engine_resumes_after_truncated_run():
    """A run() cut short by max_steps strands its batch mid-generation; a
    later run() with no new submissions seeds a tick and finishes it."""
    cfg = ARCHS["phi3-mini-3.8b"].smoke()
    eng = ServeEngine(cfg, max_batch=2, max_len=128, seed=0, device=CPU)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=4))
    assert eng.run(max_steps=2) == []      # budget exhausted mid-prompt
    results = eng.run()
    assert len(results) == 1 and len(results[0].generated) == 4


def test_serve_engine_recycles_slots():
    cfg = ARCHS["phi3-mini-3.8b"].smoke()
    eng = ServeEngine(cfg, max_batch=2, max_len=200, device=CPU)
    for i in range(6):  # 6 requests through 2 slots
        eng.submit(Request(rid=i, prompt=[1, 2, 3], max_new=4))
    results = eng.run()
    assert len(results) == 6
    assert eng.pool.allocated == 6


@pytest.mark.parametrize("breach", [True, False])
def test_serve_engine_slo_alerts_like_the_reference(breach):
    """slo= on both engines, the same requests: a p99 bound of 1 µs and a
    goodput floor of 1e12 tokens/s are breached by any run, and a bound of
    1e12 µs with a floor of 0 by none.  Each engine routes its alerts to
    slo.events, to its own registry's slo.alerts counter and to alert
    instants on an slo-monitor lane of engine.last_trace."""
    from repro.core.monitor import SLOMonitor as JSLOMonitor
    from repro_torch.core.monitor import SLOMonitor
    lim = dict(p99_us=1.0, min_goodput=1e12) if breach else \
        dict(p99_us=1e12, min_goodput=0.0)
    cfg, jcfg = ARCHS["phi3-mini-3.8b"].smoke(), JARCHS["phi3-mini-3.8b"].smoke()
    prompts = _prompts(cfg, 3)
    runs = {}
    for name, slo, eng in (
            ("port", SLOMonitor(**lim), None),
            ("reference", JSLOMonitor(**lim), None)):
        eng = (ServeEngine(cfg, max_batch=2, max_len=64, seed=0, device=CPU,
                           slo=slo) if name == "port" else
               JServeEngine(jcfg, max_batch=2, max_len=64, slo=slo))
        assert slo.registry is eng.metrics
        R = Request if name == "port" else JRequest
        for i, p in enumerate(prompts):
            eng.submit(R(rid=i, prompt=p, max_new=3))
        assert len(eng.run()) == 3
        alerts = [e for e in eng.last_trace.events() if e[0] == "alert"]
        assert "slo-monitor" in eng.last_trace.qualnames()
        assert [e[3] for e in alerts] == slo.events
        assert eng.last_report.counters.get("slo.alerts", 0) == len(slo.events)
        runs[name] = [(e["event"], e["signal"], e["threshold"])
                      for e in slo.events]
    assert runs["port"] == runs["reference"]
    assert len(runs["port"]) == (2 if breach else 0)


def test_serve_engine_refuses_audio_like_the_reference():
    """The step feeds token ids: audio is refused by both engines (the
    reference's at its first step, the port's at construction)."""
    cfg, jcfg = ARCHS["musicgen-medium"].smoke(), JARCHS["musicgen-medium"].smoke()
    jeng = JServeEngine(jcfg, max_batch=2, max_len=32)
    jeng.submit(JRequest(rid=0, prompt=[1, 2], max_new=2))
    with pytest.raises(NotImplementedError, match="audio serving uses frame embeddings"):
        jeng.run()
    with pytest.raises(NotImplementedError, match="audio serving uses frame embeddings"):
        ServeEngine(cfg, device=CPU)


def test_serve_engine_refuses_vlm_without_a_vision_stream():
    """The reference's step carries no vision embeddings, so its vlm
    serving fails on the missing key; the port refuses at construction."""
    cfg, jcfg = ARCHS["llama-3.2-vision-90b"].smoke(), JARCHS["llama-3.2-vision-90b"].smoke()
    jeng = JServeEngine(jcfg, max_batch=2, max_len=32)
    jeng.submit(JRequest(rid=0, prompt=[1, 2], max_new=2))
    with pytest.raises(KeyError, match="vision_embeds"):
        jeng.run()
    with pytest.raises(NotImplementedError, match="no vision stream"):
        ServeEngine(cfg, device=CPU)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "zamba2-2.7b", "mixtral-8x7b"])
def test_serve_engine_generates_the_references_tokens(arch):
    """Both engines, f32, the same converted weights and requests (more
    requests than slots, so slots are recycled): the same tokens per
    request, in the same tag order.  Greedy argmax over f32 logits that
    agree to ~1e-6 (test_torch_models.py)."""
    jcfg = JARCHS[arch].smoke().replace(dtype="float32")
    cfg = ARCHS[arch].smoke().replace(dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(3))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    prompts = _prompts(cfg, 5, seed=2)
    jeng = JServeEngine(jcfg, max_batch=3, max_len=64, params=jp)
    teng = ServeEngine(cfg, max_batch=3, max_len=64, params=tp, device=CPU)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=list(p), max_new=4))
        teng.submit(Request(rid=i, prompt=list(p), max_new=4))
    want = [(r.rid, r.tag, r.generated) for r in jeng.run()]
    got = [(r.rid, r.tag, r.generated) for r in teng.run()]
    assert got == want
    assert teng.steps_run == jeng.steps_run


@pytest.mark.parametrize("split", [0, 3, 7])
def test_run_report_matches_the_reference(split):
    """``MetricsRegistry.report``/``finalize`` and ``RunReport.merge`` give
    the reference's wire form on the same observations, split across two
    runs at ``split``."""
    from repro.core import obs as jobs
    from repro_torch.core import obs as tobs
    values = [float(v) for v in np.random.default_rng(split).integers(1, 500, 9)]
    out = {}
    for name, mod in (("ref", jobs), ("port", tobs)):
        seen = []
        reports = []
        for part in (values[:split], values[split:]):
            reg = mod.MetricsRegistry()
            reg.watch(seen.append)
            reg.counter("serve.tokens").inc(len(part))
            reg.gauge("serve.tokens_per_s").set(sum(part))
            for v in part:
                reg.histogram("serve.request_latency_us").observe(v)
            reports.append(reg.finalize(reg.report(
                queues={"in": len(part)}, meta={"part": len(reports)})))
        assert seen == reports          # each registry's watcher fired once
        out[name] = reports[0].merge(reports[1]).to_json()
    assert out["port"] == out["ref"]
    assert out["port"]["counters"]["serve.tokens"] == len(values)
