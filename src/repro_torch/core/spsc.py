"""Lock-free Single-Producer/Single-Consumer ring buffer (Lamport 1983).

This is the paper's primitive (Sec. 3.1): a *wait-free, fence-free* bounded
queue correct under exactly one producer thread and one consumer thread.

The algorithm:
  - ``_tail`` is written only by the producer, read by the consumer;
  - ``_head`` is written only by the consumer, read by the producer;
  - a slot is published by writing the payload *then* advancing ``_tail``
    (program order; CPython's GIL gives us the store ordering the paper gets
    from x86 TSO), and reclaimed by reading the payload *then* advancing
    ``_head``.

No locks, no compare-and-swap, no fetch-and-add anywhere on the data path —
that is the whole point of the paper.  ``push``/``pop`` are non-blocking and
return success; blocking helpers spin with an exponential yield backoff
(the paper's queues are non-blocking; blocking is a convenience wrapper).

The FastForward-style cache-line separation of head/tail (Giacomoni et al.,
PPoPP'08) has no observable analogue in CPython, but the single-writer
discipline — the property that makes the algorithm correct — is preserved
exactly and is what the hypothesis tests in ``tests/test_spsc.py`` check.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional

__all__ = ["SPSCQueue", "EOS", "Backoff"]


class Backoff:
    """Truncated-exponential spin/yield backoff for the blocking helpers.

    One instance per ``push_wait``/``pop_wait`` call: 64 pure spins (the
    uncontended hand-off resolves in nanoseconds), then sleeps that double
    from 20µs up to a 1ms cap.  ``pause`` checks the deadline *before*
    sleeping and never sleeps past it, so a blocking call returns within
    ``timeout`` plus at most one scheduler quantum — not ``timeout`` plus
    a full backoff step.  Shared by ``SPSCQueue`` and ``ShmRing`` so the
    two rings keep identical blocking semantics.
    """

    __slots__ = ("_spins", "_delay")

    SPINS = 64
    FLOOR = 0.000_02
    CAP = 0.001

    def __init__(self) -> None:
        self._spins = 0
        self._delay = self.FLOOR

    def pause(self, deadline: Optional[float] = None) -> bool:
        """Back off once; returns False when the deadline has passed."""
        if self._spins < self.SPINS:
            self._spins += 1
            return True
        if deadline is None:
            time.sleep(self._delay)
        else:
            now = time.monotonic()
            if now >= deadline:
                return False
            time.sleep(min(self._delay, deadline - now))
        self._delay = min(self._delay * 2.0, self.CAP)
        return True


class _EOS:
    """End-of-stream sentinel (FastFlow's ``NULL`` return from ``svc``).

    A singleton *per process*: every ``item is EOS`` check in the runtime
    relies on identity.  ``__reduce__`` makes pickling return the
    constructor, so an EOS crossing a process boundary (the ``procs``
    backend ships it through a shared-memory ring) unpickles to the far
    side's canonical instance under **every** protocol — without it,
    protocol ≤ 1 reconstructs via ``object.__new__`` and breaks every
    identity check downstream."""

    _instance: Optional["_EOS"] = None

    def __new__(cls) -> "_EOS":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __reduce__(self):
        return (_EOS, ())

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<EOS>"


EOS = _EOS()


class SPSCQueue:
    """Bounded wait-free SPSC FIFO.

    ``capacity`` is rounded up to a power of two so the ring index is a mask
    (as in FastFlow's implementation).  One slot is sacrificed to distinguish
    full from empty (classic Lamport formulation).
    """

    __slots__ = ("_buf", "_mask", "_head", "_tail", "pushes", "pops")

    def __init__(self, capacity: int = 512):
        if capacity < 2:
            capacity = 2
        size = 1
        while size < capacity + 1:
            size <<= 1
        self._buf: List[Any] = [None] * size
        self._mask = size - 1
        # Producer-private and consumer-private indices, stored masked to
        # the ring size (not monotonic: every advance re-wraps with
        # ``& _mask``, so len()/full() mask both sides before comparing).
        self._head = 0  # next slot to read  (consumer writes)
        self._tail = 0  # next slot to write (producer writes)
        self.pushes = 0
        self.pops = 0

    # -- introspection (safe from either side; values may be stale) --------
    def __len__(self) -> int:
        return (self._tail - self._head) & self._mask

    @property
    def capacity(self) -> int:
        return self._mask  # one slot reserved

    def empty(self) -> bool:
        return self._head == self._tail

    def full(self) -> bool:
        return ((self._tail + 1) & self._mask) == (self._head & self._mask)

    # -- producer side ------------------------------------------------------
    def push(self, item: Any) -> bool:
        """Non-blocking enqueue. Returns False when full. Producer-only."""
        tail = self._tail
        nxt = (tail + 1) & self._mask
        if nxt == (self._head & self._mask):
            return False
        self._buf[tail & self._mask] = item  # write payload ...
        self._tail = nxt                     # ... then publish (order matters)
        self.pushes += 1
        return True

    def push_wait(self, item: Any, timeout: Optional[float] = None) -> bool:
        """Blocking enqueue with spin/yield backoff."""
        deadline = None if timeout is None else time.monotonic() + timeout
        backoff = Backoff()
        while not self.push(item):
            if not backoff.pause(deadline):
                return False
        return True

    # -- consumer side ------------------------------------------------------
    _EMPTY = object()

    def pop(self) -> Any:
        """Non-blocking dequeue. Returns ``SPSCQueue._EMPTY`` when empty."""
        head = self._head
        if head == self._tail:
            return SPSCQueue._EMPTY
        idx = head & self._mask
        item = self._buf[idx]
        self._buf[idx] = None   # read payload / drop ref ...
        self._head = (head + 1) & self._mask  # ... then release the slot
        self.pops += 1
        return item

    def pop_wait(self, timeout: Optional[float] = None) -> Any:
        """Blocking dequeue with spin/yield backoff.

        Returns ``SPSCQueue._EMPTY`` on timeout.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        backoff = Backoff()
        while True:
            item = self.pop()
            if item is not SPSCQueue._EMPTY:
                return item
            if not backoff.pause(deadline):
                return SPSCQueue._EMPTY
