"""Import hygiene of the PyTorch port: ``repro_torch`` and ``chip_smoke.py``
import torch, numpy and the standard library, never ``jax``, ``triton`` or
anything of the reference package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "triton")
PORT_MODULES = [
    "repro_torch", "repro_torch.core", "repro_torch.core.allocator",
    "repro_torch.core.mdf", "repro_torch.core.shm",
    "repro_torch.core.procgraph", "repro_torch.core.a2a",
    "repro_torch.core.stream_ops", "repro_torch.core.oocore",
    "repro_torch.core.autotune", "repro_torch.core.monitor",
    "repro_torch.core.dpipeline", "repro_torch.core.dfarm",
    "repro_torch.core.ranks", "repro_torch.core.dchannel",
    "repro_torch.parallel", "repro_torch.parallel.ring_attention",
    "repro_torch.parallel.context", "repro_torch.parallel.rules",
    "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
    "repro_torch.models.moe",
    "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.kernels.smith_waterman", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.ssd_scan", "repro_torch.kernels.gated_norm",
    "repro_torch.convert",
    "repro_torch.configs", "repro_torch.models", "repro_torch.models.config",
    "repro_torch.models.layers", "repro_torch.models.attention",
    "repro_torch.models.ssm", "repro_torch.models.model",
    "repro_torch.models.zamba2",
    "repro_torch.launch.serve", "repro_torch.launch.steps",
    "repro_torch.launch.train", "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.schedule", "repro_torch.optim.compression",
    "repro_torch.optim.accumulate", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.runtime",
    "repro_torch.runtime.checkpoint", "repro_torch.runtime.fault",
    "repro_torch.tree",
]


def _top(module: str) -> str:
    return module.split(".")[0]


def _imports(path: Path):
    """Every absolute module name that ``path`` imports, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_modules_import_nothing_forbidden_ast():
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in _sources() for line, mod in _imports(p)
           if _top(mod) in FORBIDDEN]
    assert not bad, "forbidden imports:\n" + "\n".join(bad)


def test_ast_walk_tells_repro_torch_from_repro(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.core\nfrom repro_torch import convert\n"
                     "from repro.kernels import ops\nimport jax.numpy\n")
    mods = [_top(m) for _, m in _imports(probe)]
    assert [m for m in mods if m in FORBIDDEN] == ["repro", "jax"]


def test_port_import_leaves_jax_repro_triton_unloaded():
    code = ("import sys\n"
            f"import {', '.join(PORT_MODULES)}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    """Without CUDA, or copied alone into an empty directory, the smoke
    exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (lone, ROOT / "chip_smoke.py"):
        proc = subprocess.run([sys.executable, str(script)], env=env,
                              cwd=script.parent, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("name", ["spsc", "lockq", "obs", "sched",
                                  "skeleton", "graph", "farm", "allocator",
                                  "mdf", "procgraph", "a2a", "stream_ops",
                                  "oocore", "autotune", "monitor",
                                  "dpipeline"])
def test_runtime_copies_stay_plain_python(name):
    """The runtime copies import neither torch nor numpy: like the
    reference's, they are plain Python.  (``shm`` imports either only
    inside the decoder of a frame that carries it, checked below.)"""
    mods = {_top(m) for _, m in _imports(PORT / "core" / f"{name}.py")}
    assert not mods & {"torch", "numpy", *FORBIDDEN}, mods


@pytest.mark.parametrize("module", [
    "repro_torch.core", "repro_torch.core.procgraph", "repro_torch.core.shm",
    "repro_torch.core.a2a", "repro_torch.core.oocore",
    "repro_torch.core.stream_ops", "repro_torch.core.autotune",
    "repro_torch.core.monitor", "repro_torch.core.dpipeline"])
def test_runtime_import_leaves_torch_and_numpy_unloaded(module):
    """What a spawned vertex of the procs backend imports loads no torch
    and no numpy, module by module in a fresh interpreter (the
    counterpart of the reference's procs pin in
    ``tests/test_lazy_import.py``)."""
    code = ("import sys\n"
            f"import {module}\n"
            "bad = sorted(m for m in ('torch', 'numpy') if m in sys.modules)\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_core_names_of_the_device_backend_load_no_torch():
    """``import repro_torch.core`` and the names of the self-tuning
    compile, the monitor and the mesh programs load no torch (and the
    monitor only when touched); the device farm loads torch when first
    touched, as a mesh program's construction does."""
    code = ("import sys\n"
            "import repro_torch.core as c\n"
            "assert 'torch' not in sys.modules\n"
            "assert 'repro_torch.core.monitor' not in sys.modules\n"
            "from repro_torch.core import (A2AMeshProgram, MeshProgram, "
            "TunedProgram, plan_mesh, best_factorization, pipeline_apply)\n"
            "assert 'torch' not in sys.modules\n"
            "assert 'repro_torch.core.monitor' not in sys.modules\n"
            "from repro_torch.core import Monitor, analyze\n"
            "assert 'torch' not in sys.modules\n"
            "c.farm_map\n"
            "assert 'torch' in sys.modules\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_shm_reaches_torch_and_numpy_only_lazily():
    """``shm`` names torch and numpy only through ``sys.modules`` on the
    producer side and inside the decoder functions."""
    tree = ast.parse((PORT / "core" / "shm.py").read_text())
    top = {_top(a.name) for n in tree.body if isinstance(n, ast.Import)
           for a in n.names}
    top |= {_top(n.module or "") for n in tree.body
            if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not top & {"torch", "numpy", *FORBIDDEN}, top


def test_every_port_module_is_covered():
    """The import check above names every module of the package."""
    found = {".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
             .removesuffix(".__init__") for p in PORT.rglob("*.py")}
    skip = {m for m in found if m.startswith("repro_torch.configs.")
            or m.startswith("repro_torch.core.") or m == "repro_torch.kernels"
            or m in ("repro_torch.kernels._build", "repro_torch.launch")}
    assert found - skip <= set(PORT_MODULES), sorted(found - skip - set(PORT_MODULES))


def test_device_channels_load_torch_only_when_touched():
    """``pipeline_apply`` keeps ``dpipeline`` plain Python; the channels
    (``ring_send`` and the rest, through ``repro_torch.core``) bring torch
    and the rank layer in on first touch."""
    code = ("import sys\n"
            "import repro_torch.core as c\n"
            "from repro_torch.core import pipeline_apply\n"
            "assert 'torch' not in sys.modules\n"
            "assert 'repro_torch.core.ranks' not in sys.modules\n"
            "c.ring_send, c.RingChannel, c.double_buffered_ring\n"
            "assert 'torch' in sys.modules\n"
            "assert 'repro_torch.core.ranks' in sys.modules\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dry_run_imports_no_jax_repro_triton_nor_the_fake_group():
    """``launch.dryrun`` and ``launch.steps`` import no ``jax``, nothing of
    ``repro`` and no ``triton``; neither they nor ``import repro_torch``
    load torch's ``fake`` process group (``torch.testing._internal
    .distributed``, an internal module of torch's own tests), which only
    ``core.ranks.simulated`` imports, when called.  (``import torch``
    itself loads other parts of ``torch.testing._internal`` in some
    versions, so the pin is on the distributed part.)"""
    code = ("import sys\n"
            "import repro_torch\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.steps\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r} or m.startswith('torch.testing._internal.distributed'))\n"
            "assert not bad, bad\n"
            "from repro_torch.core import ranks\n"
            "with ranks.simulated(4):\n"
            "    pass\n"
            "assert 'torch.testing._internal.distributed.fake_pg' in sys.modules\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
