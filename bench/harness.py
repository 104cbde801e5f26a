"""Run one cell of ``BENCHMARK.json`` and print the result line.

Everything that belongs to one configuration, traffic mix, runner or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` or a configuration file gives it:

* ``bench/configs/<config>.json``: the configuration as it is run; its key
  ``runner`` names a module ``bench/runners/<runner>.py``;
* ``bench/traffic/<traffic>.json``: the traffic mix's parameters;
* ``bench/metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(trace)`` returning a number, or ``None`` when it finds nothing.

A runner is a module with three functions:

* ``setup(env)`` builds the system under test from ``env.seed`` and warms
  up every shape the cell uses; it returns the runner's state;
* ``window(state, env)`` measures for ``env.seconds`` and returns a
  :class:`Window`; it calls ``env.tracer.start()`` and ``.stop()`` around
  the traced part (a no-op without ``--trace 1``);
* ``check(state, window, env)`` frees the program's state, runs the plain
  reference and returns the :class:`Check` list that decides ``correct``.

It also holds ``LIMITS``, each compared number's limit by name, and
``control(env)``, the readings of its control and planted faults by name
(``bench/control.py``).

A name that has no file fails the run; nothing falls back.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")    # top-level module names


class NotFound(LookupError):
    """A cell, configuration, traffic mix, runner or metric named in
    ``BENCHMARK.json`` or a configuration file has no file."""


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit: the run
    is correct where every ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def verdict(checks: List[Check]) -> bool:
    """``correct``: there are numbers compared, and each is within its limit."""
    return bool(checks) and all(c.ok for c in checks)


@dataclasses.dataclass
class Window:
    """What a runner's measured window gives the harness."""
    t_start: float                # host clock (time.perf_counter) at its start
    t_end: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]  # by metric name, without setup_s
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RunEnv:
    root: Path
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any                   # a torch.device
    tracer: Any                   # bench.trace.Tracer or bench.trace.NoTracer
    log: Callable[[str], None]


def _read_json(path: Path, what: str) -> Dict[str, Any]:
    if not path.is_file():
        raise NotFound(f"no {what} file {path}")
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _read_json(root / "BENCHMARK.json", "benchmark")


def find_cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise NotFound(f"no workload {name!r} in BENCHMARK.json (has "
                   f"{[c['name'] for c in bench['workloads']]})")


def load_config(name: str, root: Path = ROOT) -> Dict[str, Any]:
    return _read_json(root / "bench" / "configs" / f"{name}.json",
                      f"configuration {name!r}")


def load_traffic(name: str, root: Path = ROOT) -> Dict[str, Any]:
    return _read_json(root / "bench" / "traffic" / f"{name}.json",
                      f"traffic mix {name!r}")


def load_runner(name: str, root: Path = ROOT):
    if not (root / "bench" / "runners" / f"{name}.py").is_file():
        raise NotFound(f"no runner {name!r} (bench/runners/{name}.py)")
    return importlib.import_module(f"bench.runners.{name}")


def load_metric(name: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """The ``read`` function of ``bench/metrics/<name>.py`` (a name may
    hold dots, so the file is loaded by its path)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise NotFound(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict[str, Any], cell: str, kind: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports: a
    metric with a ``workloads`` key in the cells it lists; a per-layer
    metric without one in every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def forbidden_modules(names: Optional[List[str]] = None) -> List[str]:
    """Of ``names`` (the loaded modules by default), the top-level names,
    the part before the first dot, that are in ``FORBIDDEN``: whole names,
    so ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def make_env(workload: str, seed: int, seconds: float, trace: bool, device: Any,
             root: Path = ROOT, overrides: Optional[Dict[str, Dict[str, Any]]] = None,
             log: Callable[[str], None] = None) -> RunEnv:
    """The cell's files, found by name, with ``overrides`` ({"config":
    {...}, "traffic": {...}}) laid over them (tests run tiny cells so)."""
    from bench.trace import NoTracer, Tracer
    overrides = overrides or {}
    cell = find_cell(load_benchmark(root), workload)
    config = {**load_config(cell["config"], root), **overrides.get("config", {})}
    traffic = {**load_traffic(cell["traffic"], root), **overrides.get("traffic", {})}
    return RunEnv(root=root, cell=cell, config=config, traffic=traffic,
                  seed=seed, seconds=seconds, trace=trace, device=device,
                  tracer=Tracer(device) if trace else NoTracer(),
                  log=log or (lambda s: print(s, file=sys.stderr, flush=True)))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_process: float, device: Any, root: Path = ROOT,
             overrides: Optional[Dict[str, Dict[str, Any]]] = None,
             log: Callable[[str], None] = None) -> Dict[str, Any]:
    """One run of ``workload``: set-up, the measured window, the check
    against the plain reference.  Returns the result line's object.
    ``t_process``: the host clock (time.perf_counter) at process start,
    where ``setup_s`` begins; ``overrides`` as :func:`make_env`'s."""
    import torch

    env = make_env(workload, seed, seconds, trace, device, root, overrides, log)
    bench = load_benchmark(root)
    runner = load_runner(env.config["runner"], root)
    e2e = cell_metrics(bench, workload, "end_to_end")
    per_layer = cell_metrics(bench, workload, "per_layer")
    readers = {m["name"]: load_metric(m["name"], root) for m in per_layer}
    cuda = device.type == "cuda"
    state = runner.setup(env)
    win = runner.window(state, env)
    setup_s = win.t_start - t_process
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    checks = runner.check(state, win, env)       # frees the program's state first

    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        tr = env.tracer.result(win.counters)
        for m in per_layer:
            value = readers[m["name"]](tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win.end_to_end, setup_s=setup_s)
        for m in e2e:
            if m["name"] not in values:
                raise KeyError(f"runner {env.config['runner']!r} gave no "
                               f"{m['name']!r} for {workload!r}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": env.cell["chips"],
        "memory_peak_bytes": int(peak),
    }
    out: Dict[str, Any] = {
        "correct": verdict(checks),
        "attempted": win.attempted,
        "failed": win.failed,
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None,
                              "limit": c.limit} for c in checks}
    return out
