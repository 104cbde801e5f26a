"""Failure detection and restart from a checkpoint.

Counterpart of ``repro.runtime.fault``:

  * **Heartbeat** — every participant bumps a counter; members silent for
    more than ``timeout`` seconds are reported dead (here it guards the
    host-side workers: data emitter, checkpoint collector, farm workers).
  * **FaultTolerantRunner** — wraps the train step; on an exception it
    restores the last published checkpoint and replays.  With the
    deterministic data pipeline (a pure function of (seed, step)) this
    gives exactly-once step semantics.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from .checkpoint import AsyncCheckpointer, latest_step, restore

__all__ = ["Heartbeat", "FaultTolerantRunner"]


class Heartbeat:
    def __init__(self, members, timeout: float = 30.0):
        self.timeout = timeout
        self._last: Dict[str, float] = {m: time.monotonic() for m in members}
        self._lock = threading.Lock()

    def beat(self, member: str) -> None:
        with self._lock:
            self._last[member] = time.monotonic()

    def dead(self) -> list:
        now = time.monotonic()
        with self._lock:
            return [m for m, t in self._last.items() if now - t > self.timeout]


class FaultTolerantRunner:
    """run(step_fn) with restore-on-failure semantics.

    step_fn(state, step) -> state.  ``state`` must be checkpointable; a
    restore places each leaf where the state's leaf is.  The port's steps
    update the state in place, so the caller's state cannot be replayed
    after a failure, as the reference's immutable one can: ``run``
    checkpoints it at ``start_step`` first."""

    def __init__(self, ckpt_dir: str, *, ckpt_every: int = 50,
                 max_restarts: int = 3):
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, step_fn: Callable[[Any, int], Any], state: Any,
            start_step: int, n_steps: int,
            on_step: Optional[Callable[[int, Any], None]] = None) -> Any:
        step = start_step
        self.ckpt.save(state, step)
        while step < start_step + n_steps:
            try:
                state = step_fn(state, step)
                if on_step is not None:
                    on_step(step, state)
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(state, step)
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                last = latest_step(self.ckpt_dir)
                state = restore(state, self.ckpt_dir, last)
                step = last
        self.ckpt.save(state, step)
        self.ckpt.wait()
        return state
