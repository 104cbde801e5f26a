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
            "import repro_torch, repro_torch.core, repro_torch.kernels.ops, "
            "repro_torch.kernels.ref, repro_torch.kernels.smith_waterman, "
            "repro_torch.convert\n"
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
                                  "skeleton", "graph", "farm"])
def test_runtime_copies_stay_plain_python(name):
    """The runtime copies import neither torch nor numpy: like the
    reference's, they are plain Python."""
    mods = {_top(m) for _, m in _imports(PORT / "core" / f"{name}.py")}
    assert not mods & {"torch", "numpy", *FORBIDDEN}, mods
