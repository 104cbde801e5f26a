"""Async checkpointing — the Collector pattern applied to I/O.

Counterpart of ``repro.runtime.checkpoint``, with its layout on disk:

    <dir>/step_000000123/ arrays.npz  manifest.json      (tmp → os.replace)

The npz keys are the reference's tree paths (``jax.tree_util.keystr``
strings such as ``['params']['blocks']['wq']`` and ``['opt'].mu[...]``,
written here by the port's own code), bfloat16 widened to float32, so
either package restores what the other saved.

The train loop does not wait for the disk: ``AsyncCheckpointer.save``
takes a snapshot and enqueues it on a lock-free SPSC ring; a writer thread
(the paper's Collector) drains the ring and publishes each step directory
atomically.  Where the reference can enqueue its immutable arrays as they
are, the port's train step updates the state in place, so the snapshot is
taken before ``save`` returns: a CPU tensor is cloned; a CUDA tensor is
copied into pinned host memory on the current stream, behind the work
already enqueued there and ahead of the next step's in-place update, and
the writer waits on the copy's event before it reads.

Restore loads on the host and places each tensor in its template leaf's
dtype on its device, or on the ``device`` given (the counterpart of the
reference's ``shardings``).  Keys are tree paths, so restore also takes a
template that is a subset of what was saved.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..core.spsc import EOS, SPSCQueue
from ..tree import tree_leaves_with_path, tree_map_with_path

__all__ = ["AsyncCheckpointer", "save_sync", "restore", "latest_step"]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()             # lossless widen; numpy can't store bf16
        return t.numpy()
    return np.asarray(leaf)


def save_sync(state: Any, step: int, directory: str) -> str:
    """Write ``state`` as step ``step`` of ``directory`` and publish it
    atomically.  Returns the step directory."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step:09d}")
    final = os.path.join(directory, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in tree_leaves_with_path(state)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "time": time.time(),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


def _snapshot(state: Any):
    """(a copy of ``state`` that later in-place updates cannot reach, the
    CUDA event its copies complete at or None)."""
    event = None

    def copy(_, leaf):
        nonlocal event
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = leaf.detach()
        if leaf.device.type != "cuda":
            return leaf.clone()
        host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        host.copy_(leaf, non_blocking=True)
        event = torch.cuda.Event()
        return host

    snap = tree_map_with_path(copy, state)
    if event is not None:
        event.record()
    return snap, event


class AsyncCheckpointer:
    def __init__(self, directory: str, *, keep: int = 3, ring: int = 2):
        self.directory = directory
        self.keep = keep
        self._ring = SPSCQueue(ring)
        self._written: list = []
        self._errors: list = []
        self._pending = 0
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._writer, name="ckpt-collector",
                                        daemon=True)
        self._thread.start()

    def _writer(self) -> None:
        while True:
            item = self._ring.pop_wait()
            if item is EOS:
                return
            step, state, event = item
            try:
                if event is not None:
                    event.synchronize()
                save_sync(state, step, self.directory)
                self._written.append(step)
                self._gc()
            except BaseException as e:  # re-raised by wait() and close()
                self._errors.append(e)
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()

    def _gc(self) -> None:
        steps = sorted(self._written)
        for s in steps[:-self.keep]:
            path = os.path.join(self.directory, f"step_{s:09d}")
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            self._written.remove(s)

    def save(self, state: Any, step: int) -> None:
        """Snapshot ``state`` (see the module's docstring) and enqueue it;
        returns without waiting for the disk."""
        snap, event = _snapshot(state)
        with self._cond:
            self._pending += 1
        self._ring.push_wait((step, snap, event))

    def wait(self) -> None:
        """Block until every enqueued checkpoint is durably published."""
        with self._cond:
            self._cond.wait_for(lambda: self._pending == 0)
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        self._ring.push_wait(EOS)
        self._thread.join(timeout=60)
        if self._errors:
            raise self._errors[0]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(template: Any, directory: str, step: Optional[int] = None,
            device: Any = None) -> Any:
    """Load step ``step`` (the latest by default) into the structure of
    ``template``: each tensor leaf in its template's dtype, on ``device``
    or else on the template leaf's device."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def load(key, tpl):
        a = torch.from_numpy(arrays[key])
        if isinstance(tpl, torch.Tensor):
            return a.to(dtype=tpl.dtype, device=device if device is not None
                        else tpl.device)
        return a if device is None else a.to(device)

    return tree_map_with_path(load, template)
