"""The port's shared-memory SPSC ring (``repro_torch.core.shm``) against the
reference's (``repro.core.shm``): the same pushes and pops on a ring of
each package give the same items, in order, for every slot kind (inline
and spilled pickles, raw bytes, ndarrays, batches); the port's ndarray
frames are byte-identical to the reference's.  Then what the port adds:
the ``TENSOR`` slot kind (f32, int32, bool, bf16 and the other dtypes
numpy lacks, viewed back on arrival; non-contiguous tensors, tensors that
require grad, 0-d tensors and subclasses by pickle; tensors nested in a
payload by their host view) and segment names of its own (``fft_<pid>_<n>``).
Every test unlinks every segment it made."""
import glob
import os
import pickle
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro_torch.core as tcore
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import (EOS, GO_ON, SPSCQueue, ShmCounters, ShmFlag,
                              ShmRing)
from repro_torch.core import shm as tshm
from repro_torch.core.spsc import _EOS

_EMPTY = SPSCQueue._EMPTY
_JEMPTY = jcore.SPSCQueue._EMPTY


def _segments():
    return set(glob.glob(f"/dev/shm/{tshm.SEG_PREFIX}{os.getpid()}_*"))


@pytest.fixture(autouse=True)
def no_leaked_segments():
    """Every test unlinks every segment this process made (the port's
    names carry the creating pid, so other test processes never count)."""
    before = _segments()
    yield
    assert _segments() - before == set(), "leaked SharedMemory segments"


def _drain(r, empty):
    out = []
    while True:
        item = r.pop()
        if item is empty:
            return out
        out.append(item)


_REF_SEQ = iter(range(1 << 30))


def _both(capacity, slot_size, **kw):
    """A reference ring and a port ring.  The reference's is named under
    the port's prefix: its default ``psm_*`` name would count in the
    reference's own leak check, which runs beside these tests."""
    name = f"{tshm.SEG_PREFIX}{os.getpid()}_ref{next(_REF_SEQ)}"
    return (jcore.ShmRing(capacity, slot_size, name=name, **kw),
            ShmRing(capacity, slot_size, **kw))


def _same(a, b):
    """Equal values of the same type (arrays and tensors by value)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape \
            and np.array_equal(a, b)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape \
            and a.requires_grad == b.requires_grad and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


# -- the Lamport invariants: both rings, the same operations -----------------
def test_fifo_capacity_and_wraparound_match_reference():
    for r, empty in zip(_both(8, 64), (_JEMPTY, _EMPTY)):
        try:
            assert r.pop() is empty
            pushed = 0
            while r.push(pushed):
                pushed += 1
            assert pushed == r.capacity == 15
            assert r.full() and not r.push(99)
            assert r.pop() == 0 and r.push(99)
            assert _drain(r, empty) == list(range(1, 15)) + [99]
            seen = []
            for i in range(10 * (r.capacity + 1)):  # many trips around
                assert r.push_wait(i, timeout=1)
                if i % 3 == 0:
                    seen.extend(_drain(r, empty))
            seen.extend(_drain(r, empty))
            assert seen == list(range(10 * (r.capacity + 1)))
        finally:
            r.unlink()


@given(st.lists(st.tuples(st.booleans(),
                          st.sampled_from(["int", "float", "list"])),
                min_size=1, max_size=60),
       st.integers(2, 16))
@settings(max_examples=25, deadline=None)
def test_interleaved_push_pop_matches_reference(ops, cap):
    """Arbitrary interleavings: the port's ring accepts and returns exactly
    what the reference's does, never reordering, losing or corrupting."""
    mk = {"int": lambda k: k, "float": lambda k: k * 0.5,
          "list": lambda k: [k, [k + 1], "x" * (k % 7)]}
    results = []
    for r, empty in zip(_both(cap, 64), (_JEMPTY, _EMPTY)):
        try:
            pushed, popped, n = [], [], 0
            for is_push, kind in ops:
                if is_push:
                    item = mk[kind](n)
                    if r.push(item):
                        pushed.append(item)
                    n += 1
                else:
                    item = r.pop()
                    if item is not empty:
                        popped.append(item)
            popped.extend(_drain(r, empty))
            assert popped == pushed
            results.append(popped)
        finally:
            r.unlink()
    assert results[0] == results[1]


# -- slot kinds: the port decodes what the reference decodes -----------------
def test_slot_kinds_match_reference():
    """Raw bytes kinds, ndarrays (typed frames), the pickle fallback and
    spills: each package's ring gives back the same items, same types."""
    items = [b"hello", bytearray(b"world"), memoryview(b"view-me"),
             np.arange(12, dtype=np.float32).reshape(4, 3),
             np.arange(7, dtype=np.int64), np.zeros(4096, dtype=np.float32),
             {"k": [1, 2]}, np.asfortranarray(np.ones((3, 3))),
             np.zeros(2, dtype=[("a", "i4")]), np.float32(1.5), None,
             "x" * 30_000, list(range(2_000))]
    got = []
    for r, empty in zip(_both(32, 20_000), (_JEMPTY, _EMPTY)):
        try:
            for it in items:
                assert r.push(it)
            got.append(_drain(r, empty))
        finally:
            r.unlink()
    want = [b"hello", bytearray(b"world"), b"view-me"] + items[3:]
    for ref, port, w in zip(got[0], got[1], want):
        assert _same(port, ref) and _same(port, w)


def test_ndarray_frames_are_byte_identical_to_reference():
    for a in (np.arange(12, dtype=np.float32).reshape(4, 3),
              np.ones((2, 3, 4), dtype=np.float64),
              np.arange(5, dtype=np.uint8)):
        j, t = jcore.ShmRing._build_nd_meta(a), ShmRing._build_nd_meta(a)
        assert j == t


def test_empty_ndarray_goes_without_payload_bytes():
    """An array with a zero in its shape: the reference's push raises
    (its view cannot be cast); the port's sends the frame's header alone."""
    a = np.zeros((3, 0), dtype=np.float32)
    r = ShmRing(8, 256)
    try:
        kind, _, buf = r._typed_frame(a)
        assert kind == tshm._KIND_NDARRAY and len(buf) == 0
        assert r.push(a)
        out = r.pop()
        assert out.dtype == a.dtype and out.shape == a.shape
    finally:
        r.unlink()


def test_zero_copy_opt_out_matches_reference():
    a = np.arange(16, dtype=np.float32)
    for r in _both(8, 20_000, zero_copy=False):
        try:
            assert r.push(a) and np.array_equal(r.pop(), a)
            peer = pickle.loads(pickle.dumps(r))
            assert peer.zero_copy is False  # the flag survives attach
            peer.close()
        finally:
            r.unlink()


def test_push_many_matches_reference():
    """Batched slots: FIFO across partial packs, EOS ordering, the pending
    tail counted by len(), an oversized first item shipped alone."""
    outs = []
    for r, empty, eos in zip(_both(16, 64), (_JEMPTY, _EMPTY),
                             (jcore.EOS, EOS)):
        try:
            got, i, items = [], 0, list(range(40))
            while i < len(items):
                n = r.push_many(items[i:])
                i += n
                if n == 0:
                    got.append(r.pop())
            got.extend(_drain(r, empty))
            stream = [1, 2, 3, eos]
            i = 0
            while i < len(stream):
                i += r.push_many(stream[i:])
            got += [r.pop() for _ in range(3)]
            assert r.pop() is eos and r.empty()
            assert r.push_many([10, 11, 12]) == 3 and r.pop() == 10
            assert len(r) == 2 and not r.empty()
            got += _drain(r, empty)
            assert r.push_many(["x" * 1000, 1, 2]) == 1  # spills via push()
            got += _drain(r, empty)
            outs.append(got)
        finally:
            r.unlink()
    assert outs[0] == outs[1] == list(range(40)) + [1, 2, 3, 11, 12, "x" * 1000]


# -- spills -----------------------------------------------------------------
def test_spills_are_deleted_on_pop_and_swept_on_unlink(tmp_path):
    r = ShmRing(8, slot_size=32, spill_dir=str(tmp_path))
    pattern = str(tmp_path / f"ffshm-{r.name}-*")
    try:
        big = ["x" * 10_000, list(range(2_000)), b"z" * 50_000]
        for item in big:
            assert r.push(item)
        assert len(glob.glob(pattern)) == 3
        assert [r.pop() for _ in big] == big
        assert not glob.glob(pattern)  # consumed spills deleted eagerly
        r.push("a" * 1000)
        assert glob.glob(pattern)
    finally:
        r.unlink()
    assert not glob.glob(pattern)  # unconsumed spill swept by the owner


def test_spill_decode_failure_leaves_file_and_ring_recovers(tmp_path):
    r = ShmRing(8, slot_size=64, spill_dir=str(tmp_path))
    try:
        r.push("a" * 500)
        r.push("next")
        [path] = glob.glob(str(tmp_path / f"ffshm-{r.name}-*"))
        good = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(b"\x80garbage")
        with pytest.raises(Exception):
            r.pop()
        assert os.path.exists(path)
        with open(path, "wb") as fh:
            fh.write(good)
        assert r.pop() == "a" * 500      # head was never published
        assert not os.path.exists(path)
        assert r.pop() == "next"
    finally:
        r.unlink()


def test_spill_dir_pinned_at_creation(tmp_path, monkeypatch):
    made = tmp_path / "made-here"
    made.mkdir()
    r = ShmRing(8, slot_size=16, spill_dir=str(made))
    try:
        r.push("b" * 500)
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "elsewhere"))
        peer = pickle.loads(pickle.dumps(r))
        assert peer.spill_dir == str(made)
        assert peer.pop() == "b" * 500
        peer.close()
    finally:
        r.unlink()


# -- the tensor edge ---------------------------------------------------------
TYPED = [torch.arange(12, dtype=torch.float32).reshape(3, 4),
         torch.tensor([1, -2, 3], dtype=torch.int32),
         torch.tensor([True, False, True]),
         torch.linspace(-3, 3, 10).to(torch.bfloat16).reshape(2, 5),
         torch.arange(6, dtype=torch.float16),
         torch.arange(5, dtype=torch.int64),
         torch.arange(7, dtype=torch.uint8),
         torch.tensor([0.5, -1.0]).to(torch.float8_e4m3fn),
         torch.arange(10)[2:5],                 # contiguous, offset storage
         torch.zeros(3, 0)]


@pytest.mark.parametrize("t", TYPED, ids=lambda t: f"{t.dtype}{tuple(t.shape)}")
def test_tensor_frame_roundtrips_dtype_shape_values(t):
    r = ShmRing(8, 4096)
    try:
        kind, meta, _ = r._typed_frame(t)
        assert kind == tshm._KIND_TENSOR
        assert (tshm._SLOT_HDR.size + len(meta)) % 64 == 0  # aligned data
        assert r.push(t)
        out = r.pop()
        assert type(out) is torch.Tensor
        assert out.dtype == t.dtype and out.shape == t.shape
        assert torch.equal(out.view(torch.uint8) if t.element_size() == 1
                           and t.is_floating_point() else out,
                           t.view(torch.uint8) if t.element_size() == 1
                           and t.is_floating_point() else t)
        assert not glob.glob(os.path.join(r.spill_dir, f"ffshm-{r.name}-*"))
    finally:
        r.unlink()


@pytest.mark.parametrize("case", ["non-contiguous", "requires-grad",
                                  "parameter", "0-d", "conjugate"])
def test_tensors_outside_the_kind_take_the_pickle_path(case):
    t = {"non-contiguous": torch.arange(12.0).reshape(3, 4).t(),
         "requires-grad": torch.randn(3, requires_grad=True),
         "parameter": torch.nn.Parameter(torch.ones(2)),
         "0-d": torch.tensor(3.5),
         "conjugate": torch.tensor([1 + 2j, 3 - 1j]).conj()}[case]
    r = ShmRing(8, 4096)
    try:
        assert r._typed_frame(t) is None
        assert r.push(t)
        out = r.pop()
        assert type(out) is type(t) and out.dtype == t.dtype
        assert out.shape == t.shape and out.stride() == t.stride()
        assert out.requires_grad == t.requires_grad
        assert torch.equal(out.detach().resolve_conj(),
                           t.detach().resolve_conj())
    finally:
        r.unlink()


def test_tensors_nested_in_a_payload_travel_by_host_view():
    """A farm token (tag, issued, payload) and plain containers: the
    tensors inside arrive with their dtype, bf16 included, and the pickle
    carries their numpy views (so a CUDA tensor would reach the host)."""
    r = ShmRing(8, 256)
    try:
        payloads = [(3, 0.0, torch.randn(4, 5)),
                    [torch.randn(6).to(torch.bfloat16), "x"],
                    (torch.tensor([True, False]), [torch.arange(3)])]
        for p in payloads:
            assert r.push(p)   # larger than the slot: the spill path
        for p in payloads:
            assert _same(r.pop(), p)
        blob = r._dumps((1, 0.0, torch.arange(4, dtype=torch.int32)))
        assert b"_rebuild_tensor" in blob and b"torch._utils" not in blob
    finally:
        r.unlink()


def test_tensor_through_a_spawned_consumer_and_sentinel_identity(
        tmp_path, monkeypatch):
    """One spawned echo process: tensors and ndarrays (typed frames both
    ways, bf16 included), a spill written under the parent's TMPDIR read
    by a child whose TMPDIR differs, and EOS/GO_ON keeping their
    identity."""
    import multiprocessing as mp
    from _torch_procs_nodes import echo_child
    a, b = ShmRing(16, 4096), ShmRing(16, 4096)
    child_tmp = tmp_path / "child-tmp"
    child_tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(child_tmp))
    p = mp.get_context("spawn").Process(target=echo_child, args=(a, b),
                                        daemon=True)
    p.start()
    try:
        items = [torch.arange(100, dtype=torch.float32),
                 torch.randn(3, 7).to(torch.bfloat16),
                 torch.tensor([True, False]),
                 np.arange(1000, dtype=np.float32).reshape(10, 100),
                 np.arange(7, dtype=np.int64), "c" * 5000, 1, [3, "four"]]
        for it in items + [GO_ON, EOS]:
            assert a.push_wait(it, timeout=30)
        got = [b.pop_wait(timeout=30) for _ in range(len(items) + 2)]
        assert all(_same(g, w) for g, w in zip(got, items))
        assert got[-2:] == [("go-on-is-go-on", True), ("eos-is-eos", True)]
        p.join(30)
        assert p.exitcode == 0
    finally:
        if p.is_alive():
            p.terminate()
        a.unlink()
        b.unlink()


# -- counters, flag, sentinels, lifecycle ------------------------------------
def test_counters_and_flag_cross_process():
    import multiprocessing as mp
    from _torch_procs_nodes import board_and_flag_child
    board, flag = ShmCounters(2), ShmFlag()
    try:
        board.add(0, 3)
        p = mp.get_context("spawn").Process(
            target=board_and_flag_child, args=(board, flag), daemon=True)
        p.start()
        p.join(30)
        assert p.exitcode == 0
        assert board.get(0) == 3 and board.get(1) == 5
        assert board.snapshot() == (3, 5) and flag.is_set()
    finally:
        board.unlink()
        flag.unlink()
    assert board.peek() is None  # closed: observers get None, not a raise


def test_flag_sticky_through_attach_and_counters_named():
    fl = ShmFlag()
    board = ShmCounters(2, name=f"fftctr{os.getpid()}x")
    try:
        peer = pickle.loads(pickle.dumps(fl))
        assert not peer.is_set()
        peer.set()
        peer.set()  # idempotent
        assert fl.is_set()
        peer.close()
        assert board.name == f"fftctr{os.getpid()}x"
        board.add(0, 7)
        peer = pickle.loads(pickle.dumps(board))
        assert peer.get(0) == 7
        peer.close()
    finally:
        fl.unlink()
        board.unlink()


def test_segments_carry_the_port_prefix_and_pid():
    r, board, flag = ShmRing(4, 64), ShmCounters(3), ShmFlag()
    try:
        names = [r.name, board.name, flag.name]
        assert all(n.startswith(f"fft_{os.getpid()}_") for n in names)
        assert len(set(names)) == 3
        assert not any(n.startswith("psm_") for n in names)
    finally:
        for seg in (r, board, flag):
            seg.unlink()


def test_eos_pickle_identity_every_protocol():
    for proto in range(pickle.HIGHEST_PROTOCOL + 1):
        assert pickle.loads(pickle.dumps(EOS, proto)) is EOS, proto
        assert pickle.loads(pickle.dumps(GO_ON, proto)) is GO_ON, proto
    assert _EOS() is EOS and EOS is not jcore.EOS


def test_two_thread_stream_over_shared_memory():
    r = ShmRing(64, 64)
    try:
        n, out = 2000, []

        def consume():
            while True:
                item = r.pop_wait(timeout=30)
                if item is EOS:
                    return
                out.append(item)

        t = threading.Thread(target=consume)
        t.start()
        for i in range(n):
            assert r.push_wait(i, timeout=30)
        r.push_wait(EOS, timeout=30)
        t.join(30)
        assert out == list(range(n))
        assert r.pushes == n + 1 and r.pops == n + 1
    finally:
        r.unlink()


def test_push_wait_pop_wait_give_up_after_their_timeout():
    r = ShmRing(4, 64)
    try:
        while r.push(0):
            pass
        t0 = time.monotonic()
        assert not r.push_wait(99, timeout=0.2)
        assert time.monotonic() - t0 >= 0.15
        _drain(r, _EMPTY)
        t0 = time.monotonic()
        assert r.pop_wait(timeout=0.2) is _EMPTY
        assert time.monotonic() - t0 >= 0.15
    finally:
        r.unlink()


def test_attach_pops_from_the_same_segment_and_unlink_destroys_it():
    from multiprocessing import shared_memory
    r = ShmRing(16, 64)
    r.push("hello")
    peer = pickle.loads(pickle.dumps(r))
    try:
        assert not peer.owner and peer.capacity == r.capacity
        assert peer.pop() == "hello" and r.empty()
    finally:
        peer.close()
        r.unlink()
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=r.name)


def test_core_exports_the_reference_shm_names():
    for name in ("ShmRing", "ShmCounters", "ShmFlag"):
        assert hasattr(tcore, name) and hasattr(jcore, name)
