"""Lock-based MPMC queue — the *baseline* the paper argues against.

The paper's experimental claim is that traditional mutex/condition-variable
queues (what OpenMP critical sections, TBB ``concurrent_queue`` in its
blocking mode, and naive pthread code boil down to) impose a per-item
synchronisation cost that dominates fine-grained streaming.  To reproduce
that comparison we need the baseline too, with the *same* API surface as
``SPSCQueue`` so the farm can be instantiated over either.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Optional

from .spsc import SPSCQueue

__all__ = ["LockQueue"]


class LockQueue:
    """Mutex-protected bounded MPMC FIFO (the "fence-full" baseline)."""

    def __init__(self, capacity: int = 512):
        self._buf: deque = deque()
        self._capacity = capacity
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self.pushes = 0
        self.pops = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def capacity(self) -> int:
        return self._capacity

    def empty(self) -> bool:
        with self._lock:
            return not self._buf

    def full(self) -> bool:
        with self._lock:
            return len(self._buf) >= self._capacity

    def push(self, item: Any) -> bool:
        with self._lock:
            if len(self._buf) >= self._capacity:
                return False
            self._buf.append(item)
            self.pushes += 1
            self._not_empty.notify()
            return True

    def push_wait(self, item: Any, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while len(self._buf) >= self._capacity:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._not_full.wait(remaining)
            self._buf.append(item)
            self.pushes += 1
            self._not_empty.notify()
            return True

    def pop(self) -> Any:
        with self._lock:
            if not self._buf:
                return SPSCQueue._EMPTY
            item = self._buf.popleft()
            self.pops += 1
            self._not_full.notify()
            return item

    def pop_wait(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not self._buf:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return SPSCQueue._EMPTY
                self._not_empty.wait(remaining)
            item = self._buf.popleft()
            self.pops += 1
            self._not_full.notify()
            return item
