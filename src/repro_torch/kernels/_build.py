"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source has a plain C interface, so it compiles in seconds without
PyTorch's headers.  The shared library goes into ``build/repro_torch/`` at
the root of the checkout (git-ignored), named by a hash of the source, the
local headers it includes (``#include "..."``, e.g. ``csrc/fa_hopper.cuh``)
and the flags, so an edited source or header never loads a stale build;
nvcc's output (ptxas's register and spill counts) is kept beside it as
``.log`` and read back when the library is reused.  The build runs once
per process, under a lock per source, at the first
launch — never at import; different sources build concurrently
(``load_all``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "SOURCES", "load", "load_all",
           "build_info", "compile_source", "ptxas_usage"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

SOURCES = ("smith_waterman", "flash_attention", "flash_attention_bwd",
           "ssd_scan", "ssd_scan_bwd")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_LOCK = threading.Lock()                      # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}
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


def _inputs(src: Path) -> List[Path]:
    """``src`` and the local headers it includes, directly or through
    another header (nvcc looks for them beside the file that includes them)."""
    found: List[Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        if path not in found:
            found.append(path)
            todo += [path.parent / h for h in _INCLUDE.findall(path.read_text())]
    return found


def _digest(src: Path) -> str:
    """Hash of the flags, ``src`` and the headers it includes."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs(src):
        digest.update(path.read_bytes())
    return digest.hexdigest()[:12]


def compile_source(src: Path, out: Path) -> Tuple[float, str]:
    """nvcc ``src`` with ``NVCC_FLAGS`` into the shared library ``out``;
    returns ``(seconds, nvcc output)``, raises with that output on failure."""
    cmd: List[str] = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        out.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n"
                           f"{' '.join(cmd)}\n{log}")
    return dt, log


def _build(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}-{_digest(src)}.so"
    saved = lib.with_suffix(".log")
    if lib.exists():
        log = saved.read_text() if saved.exists() else ""
        _INFO[name] = (0.0, f"reused {lib}\n{log}")
        return ctypes.CDLL(str(lib))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    dt, log = compile_source(src, tmp)
    saved.write_text(log)
    os.replace(tmp, lib)
    _INFO[name] = (dt, log)
    return ctypes.CDLL(str(lib))


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first
    call; raises with nvcc's output if the build fails)."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = _build(name)
        return lib


def load_all(names=SOURCES) -> Dict[str, ctypes.CDLL]:
    """Build (or reuse) every named source at once, one nvcc each; raises
    the first build's error after all have finished."""
    libs: Dict[str, ctypes.CDLL] = {}
    errors: List[BaseException] = []

    def one(name: str) -> None:
        try:
            libs[name] = load(name)
        except BaseException as e:  # re-raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return libs


def build_info(name: str) -> Tuple[float, str]:
    """``(seconds, nvcc output)`` of this process's build of ``name``; a
    reused library gives 0 seconds and ``reused <path>`` before the output
    kept from its build (nothing more if that was not kept)."""
    return _INFO[name]


def ptxas_usage(log: str) -> Dict[str, Tuple[Optional[int], Optional[int],
                                              Optional[int]]]:
    """``{mangled entry: (registers, spill store bytes, spill load bytes)}``
    from ``ptxas -v`` output, in the order ptxas compiled the entries."""
    out: Dict[str, List[Optional[int]]] = {}
    name = props = None         # the entry being compiled; whose properties follow
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        prop = re.search(r"Function properties for (\w+)", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            name = entry.group(1)
            out[name] = [None, None, None]
        elif prop:
            props = prop.group(1)
        elif name and spill and props == name:
            out[name][1:] = [int(spill.group(1)), int(spill.group(2))]
        elif name and regs:
            out[name][0] = int(regs.group(1))
    return {k: tuple(v) for k, v in out.items()}

