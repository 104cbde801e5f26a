"""The port's observability (``repro_torch.core.obs``) inside ``TaskFarm``,
and the cross entropy's profiler range.

* ``TaskFarm(trace=None)``, the default, allocates nothing in obs.py and
  binds no lane: the untraced farm runs the vertex loops it always ran;
* a Tracer handed to successive farm runs keeps one lane per vertex
  (qualname), numbers the runs, records every worker's first task of a
  run whatever the sample, and gives each run one ``run`` span whose
  ``first_svc`` is the earliest ``svc`` start of that run;
* the new spans and their arguments reach the Chrome export;
* ``train.ce`` is an ancestor of the cross entropy's backward products in
  a profiled step of a tiny model, and profiling leaves the numbers as
  they are.
"""
import json
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS
from repro_torch.core import Farm, FnNode, TaskFarm, lower
from repro_torch.core import obs as obs_mod
from repro_torch.core.graph import Graph, StageVertex
from repro_torch.core.obs import Tracer
from repro_torch.core.skeleton import _SeqNode
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves_with_path, tree_map

from _torch_threads import one_torch_thread  # noqa: F401

FARM_LANES = ["ff-collector", "ff-emitter", "ff-farm", "ff-worker-0",
              "ff-worker-1"]


def _inc(x):
    return x + 1


def _farm_run(n, trace=None):
    farm = TaskFarm(2, preserve_order=True, trace=trace)
    farm.add_stream(list(range(n)))
    farm.add_worker(FnNode(_inc))
    return farm, farm.run_and_wait()


def _runs(tr):
    return [e for e in tr.trace().lane("ff-farm").events if e[0] == "run"]


def _svc(tr, run):
    return [e for w in ("ff-worker-0", "ff-worker-1")
            for e in tr.trace().lane(w).events
            if e[0] == "svc" and e[3]["run"] == run]


def test_taskfarm_tracer_off_allocates_nothing():
    _farm_run(200)              # warm the lowering before the snapshot
    tracemalloc.start()
    try:
        farm, out = _farm_run(200)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert out == [x + 1 for x in range(200)]
    total = sum(s.size for s in snap.filter_traces(
        [tracemalloc.Filter(True, obs_mod.__file__)]).statistics("filename"))
    assert total == 0, f"untraced farm run allocated {total}B in obs.py"
    assert farm.tracer is None and farm._graph.tracer is None
    assert farm._graph.run_id is None
    assert all(v.tracer is None for v in farm._graph.vertices)


@pytest.mark.parametrize("trace", [True, False, None])
def test_taskfarm_takes_trace_as_thread_program_does(trace):
    farm, out = _farm_run(10, trace)
    assert out == [x + 1 for x in range(10)]
    assert isinstance(farm.tracer, Tracer) if trace else farm.tracer is None


def test_successive_runs_share_lanes_and_number_runs():
    tr = Tracer(sample=16)
    for _ in range(5):
        _, out = _farm_run(40, tr)
        assert out == [x + 1 for x in range(40)]
    assert tr.trace().qualnames() == FARM_LANES
    for vt in tr.trace().lanes:
        kinds = [e[0] for e in vt.events]
        if vt.name != "ff-farm":
            assert kinds.count("eos") == 5 and kinds.count("life") == 5
        assert vt.dropped == 0
    runs = _runs(tr)
    assert [e[3]["run"] for e in runs] == [0, 1, 2, 3, 4]
    assert all(e[3]["tasks"] == 40 for e in runs)


def test_first_task_of_every_run_is_recorded_whatever_the_sample():
    tr = Tracer(sample=1 << 10)          # nothing else is sampled in
    for _ in range(3):
        _farm_run(64, tr)
    for run, (_, t0, t1, args) in enumerate(_runs(tr)):
        svc = _svc(tr, run)
        # round robin: worker 0 starts with tag 0, worker 1 with tag 1
        assert sorted(e[3]["tag"] for e in svc) == [0, 1]
        assert args["first_svc"] == min(e[1] for e in svc)
        assert t0 <= args["first_svc"] <= t1
        assert all(t0 <= e[1] <= e[2] <= t1 for e in svc)


def test_every_task_recorded_at_sample_one_with_run_and_tag():
    tr = Tracer(sample=1)
    _farm_run(50, tr)
    _farm_run(30, tr)
    assert sorted(e[3]["tag"] for e in _svc(tr, 0)) == list(range(50))
    assert sorted(e[3]["tag"] for e in _svc(tr, 1)) == list(range(30))


def test_a_full_lane_counts_its_drops():
    tr = Tracer(sample=1, capacity=16)
    _farm_run(100, tr)
    lanes = {vt.qualname: vt for vt in tr.trace().lanes}
    assert lanes["ff-worker-0"].dropped > 0
    assert len(lanes["ff-worker-0"].events) == 16


def test_thread_program_runs_reuse_their_lanes():
    prog = lower(Farm(_inc, nworkers=2), "threads", trace=True)
    prog(range(20))
    first = prog.last_trace.qualnames()
    prog(range(20))
    assert prog.last_trace.qualnames() == first
    assert len(first) == len(set(first))


def test_two_vertices_of_one_qualname_in_one_run_get_two_lanes():
    tr = Tracer()
    lanes = []
    for _ in range(2):              # a second run takes the same two lanes
        g = Graph()
        g.tracer = tr
        a = g.add(StageVertex(_SeqNode(range(5)), name="twin"))
        b = g.add(StageVertex(FnNode(_inc), name="twin"))
        g.connect(a, b)
        assert sorted(g.run_and_wait()) == [1, 2, 3, 4, 5]
        assert a.tracer is not b.tracer
        lanes.append((a.tracer, b.tracer))
    assert lanes[0] == lanes[1]
    assert tr.trace().qualnames() == ["twin", "twin"]


def test_chrome_export_carries_run_and_svc_args(tmp_path):
    tr = Tracer(sample=4)
    _farm_run(32, tr)
    _farm_run(32, tr)
    doc = tr.trace().to_chrome_json(str(tmp_path / "farm.json"))
    assert json.loads((tmp_path / "farm.json").read_text()) == doc
    evs = doc["traceEvents"]
    lanes = {(e["pid"], e["tid"]): e["args"]["name"] for e in evs
             if e["ph"] == "M"}
    assert sorted(lanes.values()) == FARM_LANES
    runs = [e for e in evs if e["name"] == "run"]
    assert [e["args"]["run"] for e in runs] == [0, 1]
    for e in runs:
        assert e["ph"] == "X" and lanes[(e["pid"], e["tid"])] == "ff-farm"
        assert set(e["args"]) == {"run", "tasks", "first_svc"}
        assert e["ts"] <= e["args"]["first_svc"] * 1e6 <= e["ts"] + e["dur"]
    svc = [e for e in evs if e["name"] == "svc"
           and lanes[(e["pid"], e["tid"])].startswith("ff-worker")]
    assert svc and all(set(e["args"]) == {"run", "tag"} for e in svc)


# -- the cross entropy's range ------------------------------------------------
def _tiny_step(prof_on):
    cfg = ARCHS["phi3-mini-3.8b"].smoke().replace(loss_chunk=16)    # bf16
    params = tree_map(lambda t: t.requires_grad_(True),
                      M.init_params(cfg, 0, device="cpu"))
    tok = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(3))
    leaves = [t for _, t in tree_leaves_with_path(params)]

    def step():
        loss, _ = M.loss_fn(params, {"tokens": tok, "labels": tok}, cfg)
        return loss, torch.autograd.grad(loss, leaves)

    if not prof_on:
        return step() + (None, cfg)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = step()
    return out + (prof, cfg)


def _ancestors(ev):
    up = ev.cpu_parent
    while up is not None:
        yield up.name
        up = up.cpu_parent


def test_ce_range_covers_the_backward_products():
    loss, grads, prof, cfg = _tiny_step(True)
    back = [ev for ev in prof.events() if ev.name == "aten::mm"
            and any("MmBackward0" in a for a in _ancestors(ev))]
    # the CE's products are the only ones with the vocabulary as a side
    ce = [ev for ev in back if any(cfg.vocab_size in s
                                   for s in ev.input_shapes if s)]
    rest = [ev for ev in back if ev not in ce]
    assert len(ce) == 2 * 2           # 2 chunks x (d logits -> x, head)
    assert all("train.ce" in _ancestors(ev) for ev in ce)
    assert rest and not any("train.ce" in _ancestors(ev) for ev in rest)
    # the last nodes of a chunk's backward: the casts of its gradients (to
    # x_c, a (2, 16, d) chunk, and to the head) back to bf16
    casts = [ev for ev in prof.events() if ev.name == "aten::_to_copy"
             and any("ToCopyBackward0" in a for a in _ancestors(ev))]
    ce_casts = [ev for ev in casts if ev.input_shapes[0] in (
        [2, 16, cfg.d_model], [cfg.vocab_padded, cfg.d_model])]
    assert len(ce_casts) == 2 * 2
    assert all("train.ce" in _ancestors(ev) for ev in ce_casts)
    assert not any("train.ce" in _ancestors(ev)
                   for ev in casts if ev not in ce_casts)
    loss0, grads0, _, _ = _tiny_step(False)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_train_split_counts_the_nested_recompute_once():
    """``chip_smoke.train_split`` on a hand-built profile: the recompute's
    ``train.ce`` range nested in the backward's counts once, and the parts
    add up to the total."""
    from types import SimpleNamespace as NS
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kernels = []

    def rng(name, ks=(), children=()):
        ev = NS(name=name, device_type=cpu, cpu_parent=None,
                cpu_children=list(children),
                kernels=[NS(name=n, duration=us) for n, us in ks])
        kernels.extend(NS(name=n, device_type=cuda, device_time_total=us)
                       for n, us in ks)
        for ch in children:
            ch.cpu_parent = ev
        return ev

    recompute = rng("train.ce", [("gemm_f32", 100.0)])
    cpus = [rng("train.ce", [("gemm_f32", 100.0), ("lse", 10.0)]),
            rng("train.ce", [("gemm_f32", 200.0), ("cast", 5.0)],
                [rng("autograd::engine::evaluate_function: MmBackward0",
                     children=[recompute])]),
            rng("train.adamw", [("adam", 50.0)])]
    cpus += [recompute, cpus[1].cpu_children[0]]
    rng("other", [("gemm_bf16", 300.0), ("fa_kernel", 40.0), ("add", 20.0)])
    prof = NS(events=lambda: cpus + kernels)
    split = _chip_smoke().train_split(prof)
    assert split["cross-entropy"] == pytest.approx(0.415)
    assert split["GEMMs"] == pytest.approx(0.3)
    assert split["optimizer update"] == pytest.approx(0.05)
    assert split["rest"] == pytest.approx(0.02)
    assert sum(v for k, v in split.items() if k != "total") \
        == pytest.approx(split["total"]) == pytest.approx(0.825)
