"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source has a plain C interface, so it compiles in seconds without
PyTorch's headers.  The shared library goes into ``build/repro_torch/`` at
the root of the checkout (git-ignored), named by a hash of the source and
the flags, so an edited source never loads a stale build.  The build runs
once per process, under a lock, at the first launch — never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "load", "build_info"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_INFO: Dict[str, Tuple[float, str]] = {}  # name -> (build seconds, nvcc log)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin: cannot build the CUDA kernels")


def _build(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"
    if lib.exists():
        _INFO[name] = (0.0, f"reused {lib}")
        return ctypes.CDLL(str(lib))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd: List[str] = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    _INFO[name] = (dt, log)
    return ctypes.CDLL(str(lib))


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first
    call; raises with nvcc's output if the build fails)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = _build(name)
        return lib


def build_info(name: str) -> Tuple[float, str]:
    """``(seconds, nvcc output)`` of this process's build of ``name``."""
    return _INFO[name]

