"""Picklable nodes and child targets for the port's procs-backend tests.

Spawned vertex processes unpickle their nodes by importing the defining
module, so everything a port procs test ships to a child that is not in
``tests/_procs_nodes.py`` lives here: the nodes that return the port's own
sentinels and containers (``GO_ON``, ``EmitMany``, ``KeyBatch`` of
``repro_torch.core``, which the port's vertices test by identity and
type), and the tensor nodes.  Like ``_procs_nodes`` it has no test-only
imports, and it imports torch only inside the nodes that need it: a child
that never services a tensor stays cheap to start.
"""
from __future__ import annotations


def drop_odd(x):
    from repro_torch.core import GO_ON
    return x if x % 2 == 0 else GO_ON


def emit_twice(x):
    from repro_torch.core import EmitMany
    return EmitMany([x, x])


def emit_pair_batch(x):
    from repro_torch.core import KeyBatch
    return KeyBatch([(x, 0.5 * x), (x, 0.5 * x + 1)])


class Dedup:
    """Stateful per-partition worker: emits each value once."""

    def __init__(self):
        self.seen = set()

    def __call__(self, x):
        from repro_torch.core import GO_ON
        if x in self.seen:
            return GO_ON
        self.seen.add(x)
        return x


# -- tensor nodes --------------------------------------------------------------
def describe(t):
    """What the worker received: type, dtype, shape, device and the tensor."""
    return type(t).__name__, str(t.dtype), tuple(t.shape), t.device.type, t


def explode_scores(chunk):
    """A (2, n) int32 tensor -> one ``(bucket, score)`` row per column, as
    a KeyBatch (one wire message per destination partition)."""
    from repro_torch.core import KeyBatch
    buckets, scores = chunk.tolist()
    return KeyBatch(zip(buckets, scores))


# -- child targets for test_torch_shm ------------------------------------------
def echo_child(inbound, outbound):
    """Pop until EOS, echoing each item; report whether the port's
    sentinels kept their identity and what type each tensor arrived as."""
    from repro_torch.core import EOS, GO_ON
    while True:
        item = inbound.pop_wait(timeout=30)
        if item is EOS:
            outbound.push_wait(("eos-is-eos", True), timeout=30)
            return
        if item is GO_ON:
            outbound.push_wait(("go-on-is-go-on", True), timeout=30)
            continue
        outbound.push_wait(item, timeout=30)


def board_and_flag_child(board, flag):
    board.add(1, 5)  # slot 1 is this process's single-writer counter
    flag.set()
