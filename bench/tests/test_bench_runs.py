"""Each runner at a tiny size on the CPU, with the kernels' plain versions,
in a fresh process: the result line has exactly the contract's keys, the
run is correct, and nothing of JAX or the JAX package was loaded; the
plain references load nothing of the program."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(script: str) -> str:
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("cell", ["sw-swissprot-search", "phi3-train-4k"])
def test_tiny_run_prints_the_contract_keys(cell):
    script = (
        "import json, sys, time\n"
        "t = time.perf_counter()\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from bench import harness\n"
        "from bench.tests import tiny\n"
        "for trace in (False, True):\n"
        f"    out = harness.run_cell({cell!r}, 2**31 + 7, 0.5, trace, t_process=t,\n"
        "        device=torch.device('cpu'), overrides=tiny.overrides(" + repr(cell) + "))\n"
        "    print(json.dumps(out))\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    lines = _run(script).strip().splitlines()
    plain, traced = [json.loads(x) for x in lines if x.startswith("{")]
    assert json.loads(lines[-1]) == []
    assert set(plain) == KEYS and set(traced) == KEYS | {"breakdown"}
    assert list(plain)[-1] == "checks" and list(traced)[-1] == "checks"
    for out in (plain, traced):
        assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
        assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert "setup_s" in plain["metrics"] and len(plain["metrics"]) >= 2
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_references_load_nothing_of_the_program():
    script = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import bench.reference.sw, bench.reference.phi3, bench.gen, bench.counts.work\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = set(json.loads(_run(script).strip().splitlines()[-1]))
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
