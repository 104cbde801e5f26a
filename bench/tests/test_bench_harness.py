"""The harness finds every file by the name BENCHMARK.json gives it, fails
on a name it cannot find, and takes a new configuration, traffic mix,
per-layer metric or runner as new files plus new entries."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark(ROOT)


def _cell_names():
    return [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", _cell_names())
def test_every_cell_finds_its_files(cell):
    c = harness.find_cell(BENCH, cell)
    config = harness.load_config(c["config"], ROOT)
    harness.load_traffic(c["traffic"], ROOT)
    runner = harness.load_runner(config["runner"], ROOT)
    assert all(callable(getattr(runner, f)) for f in ("setup", "window", "check", "control"))
    e2e = harness.cell_metrics(BENCH, cell, "end_to_end")
    layer = harness.cell_metrics(BENCH, cell, "per_layer")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and layer
    for m in layer:
        assert callable(harness.load_metric(m["name"], ROOT))


def test_every_config_file_states_its_source_and_cuts():
    for entry in BENCH["configs"]:
        path = ROOT / entry["file"]
        c = json.loads(path.read_text())
        assert path.stem == entry["name"] and c["source"] == entry["source"]
        assert c["reduced"] == entry["reduced"]
        assert isinstance(c["assumed"], list) and isinstance(c["departures"], list)


@pytest.mark.parametrize("kind,name", [("cell", "no-such-cell"), ("config", "no-such-config"),
                                       ("traffic", "no-such-mix"), ("runner", "no_such_runner"),
                                       ("metric", "no_such_metric.train")])
def test_unknown_name_fails(kind, name):
    load = {"cell": lambda n: harness.find_cell(BENCH, n),
            "config": lambda n: harness.load_config(n, ROOT),
            "traffic": lambda n: harness.load_traffic(n, ROOT),
            "runner": lambda n: harness.load_runner(n, ROOT),
            "metric": lambda n: harness.load_metric(n, ROOT)}[kind]
    with pytest.raises(harness.NotFound):
        load(name)


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.core.farm", "numpy"], []),
    (["repro", "repro.core"], ["repro"]),
    (["jaxlib.xla_client", "flax.linen", "jax"], ["flax", "jax", "jaxlib"]),
    (["reproduce", "jax_lookalike"], [])])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_run_py_refuses_without_a_card():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "sw-swissprot-search", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_new_config_traffic_metric_and_runner_are_data_only(tmp_path):
    """In a copy of the benchmark: a new runner (a module that reuses the
    search runner), a configuration naming it, a traffic mix and a
    per-layer metric, added as files plus entries, run without an edit to
    any file that was there."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/sw-swissprot-57.5.json").read_text())
    cfg.update(runner="toy_search", database={"subjects": 200, "mean_len": 30,
               "gamma_shape": 2.0, "min_len": 2, "max_len": 60}, chunk_subjects=32)
    (tmp_path / "bench/configs/toy-db.json").write_text(json.dumps(cfg))
    (tmp_path / "bench/traffic/toy-q16.json").write_text(json.dumps(
        {"query_lengths": [16], "gap_regimes": [[10.0, 2.0]]}))
    (tmp_path / "bench/runners/toy_search.py").write_text(
        "from bench.runners.sw_search import setup, window, check, control  # noqa: F401\n")
    (tmp_path / "bench/metrics/searches.toy.py").write_text(
        "def read(trace):\n    return float(trace.counters['sw_cells'])\n")
    b["configs"].append({"name": "toy-db", "source": "https://arxiv.org/abs/0909.1187",
                         "file": "bench/configs/toy-db.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "toy.cell", "config": "toy-db", "traffic": "toy-q16",
                           "chips": 1, "why": "test"})
    b["end_to_end"][0]["workloads"].append("toy.cell")
    b["per_layer"].append({"name": "searches.toy", "unit": "cells", "better": "higher",
                           "source": "program_counter", "layer": "sw kernel",
                           "moves": "gcups", "workloads": ["toy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    script = ("import json, sys, time, torch\n"
              "torch.set_num_threads(1)\n"
              f"sys.path[:0] = [{str(tmp_path)!r}, {str(tmp_path / 'src')!r}]\n"
              "from bench import harness\n"
              "t = time.perf_counter()\n"
              "for trace in (False, True):\n"
              "    print(json.dumps(harness.run_cell('toy.cell', 5, 0.5, trace, t_process=t,\n"
              "        device=torch.device('cpu'), root=harness.ROOT)))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = [json.loads(line) for line in out.stdout.strip().splitlines()[-2:]]
    assert plain["correct"] and set(plain["metrics"]) == {"gcups", "setup_s"}
    assert traced["correct"] and traced["metrics"]["searches.toy"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
