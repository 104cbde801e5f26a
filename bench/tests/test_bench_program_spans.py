"""The readers of the program's spans on hand-built traces, and the search
runner's farm in an untraced run: built as the program's default, with no
tracer, so the untraced runs that give the end-to-end metrics pay nothing for
the farm's spans."""
from types import SimpleNamespace

import pytest
import torch

from bench import harness
from bench.tests import tiny
from bench.trace import Trace


def _ev(name, kernels_us=(), children=()):
    ev = SimpleNamespace(name=name, cpu_parent=None, cpu_children=list(children),
                         kernels=[SimpleNamespace(name="k", duration=us)
                                  for us in kernels_us])
    for ch in children:
        ch.cpu_parent = ev
    return ev


def _flatten(evs):
    for ev in evs:
        yield ev
        yield from _flatten(ev.cpu_children)


def _trace(roots, counters):
    return Trace([], list(_flatten(roots)), 1.0, counters)


def test_ce_ms_counts_each_outermost_range_once():
    read = harness.load_metric("ce_ms.train")
    forward = _ev("train.ce", [1000.0])
    # the backward's range: the recompute's range nested in a node of it
    recompute = _ev("train.ce", [1000.0])
    backward = _ev("train.ce", [2000.0],
                   [_ev("autograd::engine::evaluate_function: LogsumexpBackward0",
                        children=[recompute])])
    other = _ev("train.adamw", [5000.0])
    tr = _trace([forward, backward, other], {"steps": 2})
    assert read(tr) == pytest.approx((1000.0 + 1000.0 + 2000.0) / 2 / 1e3)


@pytest.mark.parametrize("roots, counters", [
    ([_ev("train.adamw", [5000.0])], {"steps": 2}),       # no CE range
    ([_ev("train.ce", [1000.0])], {}),                    # no steps counted
    ([_ev("train.ce")], {"steps": 2}),                    # no kernel under it
])
def test_ce_ms_is_silent_without_its_span(roots, counters):
    assert harness.load_metric("ce_ms.train")(_trace(roots, counters)) is None


def test_untraced_search_builds_its_farms_without_a_tracer(monkeypatch):
    from repro_torch import core
    built = []

    class Spy(core.TaskFarm):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(core, "TaskFarm", Spy)
    out = harness.run_cell("sw-swissprot-search", 2**31 + 11, 0.2, False,
                           t_process=0.0, device=torch.device("cpu"),
                           overrides=tiny.overrides("sw-swissprot-search"),
                           log=lambda s: None)
    assert out["correct"] and out["attempted"] >= 1
    assert len(built) >= 1 + out["attempted"]          # the warm-up's too
    assert all(f.tracer is None and f._graph.tracer is None for f in built)
