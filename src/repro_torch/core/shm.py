"""Lock-free SPSC ring over OS shared memory — the paper's queue, off-GIL.

The port's copy of ``repro.core.shm``, with one more typed slot kind (a
``torch.Tensor``) and segment names of its own (``fft_<pid>_<n>``, see
:data:`SEG_PREFIX`).

``spsc.py`` is the Lamport/FastForward ring for one *process*: correct
under exactly one producer thread and one consumer thread, with CPython's
GIL standing in for x86 store ordering.  This module is the same algorithm
over ``multiprocessing.shared_memory``, so producer and consumer can be
separate *processes* — which is where the paper's speedup story finally
applies to pure-Python stages (a thread farm of GIL-holding ``svc``
functions serialises; a process farm does not; see ``procgraph.py``).

What is byte-for-byte faithful to the paper here (Sec. 3.1, after
Giacomoni et al.'s FastForward, PPoPP'08):

* **single-writer counters** — ``head`` is written only by the consumer,
  ``tail`` only by the producer; each side reads the other's counter
  benignly stale.  No locks, no CAS, no fetch-and-add on the data path.
* **cache-line separation** — head and tail live 64 bytes apart in the
  shared segment (offsets 0 and 64; slots start at 128 and each slot is
  padded to a cache-line multiple), so the two cores never false-share a
  line.  Both counters are plain 8-byte stores into mapped memory with no
  interpreter lock between the cores.
* **publication order** — the producer writes the payload *then* the
  tail; the consumer reads the payload *then* the head.  CPython emits
  these as ordinary stores in program order; x86-TSO keeps them ordered,
  exactly the assumption the paper makes for its fence-free queue.

Slots are **typed**.  Payloads exposing the buffer protocol skip pickle
entirely — the producer copies the bytes once, straight into the mapped
segment, under a small header, and the consumer copies them once out:

* kind ``RAW``   — ``bytes``/``bytearray``/C-contiguous ``memoryview``
  (one subkind byte restores the concrete type; a memoryview comes back
  as ``bytes``, the only faithful owner once detached from its source);
* kind ``NDARRAY`` — a C-contiguous unstructured numpy array: dtype
  string + shape in the header, raw data after it.  The consumer
  allocates the array and copies the segment bytes in — one copy per
  side, no serialisation.
* kind ``TENSOR`` — an exact ``torch.Tensor`` that is contiguous, strided,
  at least 1-d and does not require grad: the ``NDARRAY`` frame of its
  ``numpy()`` view, preceded by the tensor's dtype name.  A dtype that
  numpy lacks (``bfloat16``, the float8 types) travels as the raw integer
  view of its width and is viewed back on arrival; a CUDA tensor is
  moved to the host at the edge.  The consumer wraps the array it copied
  out with ``torch.from_numpy``: no copy beyond the ndarray path's own.
  Non-contiguous tensors, tensors that require grad, 0-d tensors and
  tensor subclasses (``nn.Parameter``) take the pickle path.
* kind ``INLINE``/``SPILL`` — everything else pickles.  Once the
  producer has torch loaded, a qualifying tensor nested in the payload
  (a farm's ``(tag, issued, payload)`` token, a tuple, a list) pickles as
  its host numpy view, so a CUDA tensor reaches the far side on the host
  wherever it sits.  An item whose
  encoding exceeds the slot goes through the **spill side-channel**: the
  producer writes the blob to a spill file (named by the ring + a
  producer-owned sequence number — still single-writer) and the slot
  carries only the sequence number; the consumer reads, decodes, *then*
  deletes the file and only then publishes the head, so a consumer dying
  mid-decode leaves the item on disk for the owner's sweep instead of
  losing it.  The spill directory is pinned at ring creation and travels
  through ``__reduce__`` so producer and consumer agree on paths even
  under divergent ``TMPDIR``.
* kind ``BATCH`` — ``push_many`` packs a run of small items into one
  slot (one header + one counter store amortised over the run); ``pop``
  unpacks transparently, holding the tail of the batch in a consumer-
  local pending queue that ``empty()``/``len()`` account for.

Neither numpy nor torch is imported here: the producer's typed kinds
engage only when ``sys.modules`` says the caller already has the library,
and the consumer imports it when such a frame arrives.  So ``import
repro_torch.core`` stays cheap in the spawned vertices.

``push``/``pop`` are non-blocking; ``push_wait``/``pop_wait`` share
``SPSCQueue``'s truncated-exponential ``Backoff`` (deadline checked
before sleeping), and the ``EOS`` sentinel pickles to the canonical
instance on the far side (``_EOS.__reduce__``), so the two rings are
drop-in interchangeable.
"""
from __future__ import annotations

import glob
import io
import itertools
import os
import pickle
import struct
import sys
import tempfile
import time
from collections import deque
from typing import Any, Optional, Sequence, Tuple

from multiprocessing import shared_memory

from .spsc import EOS, Backoff, SPSCQueue  # noqa: F401  (EOS re-exported)

__all__ = ["ShmRing", "ShmCounters", "ShmFlag", "EOS", "SEG_PREFIX"]

#: prefix of every segment this module names itself (``fft_<pid>_<n>``):
#: the port's segments are told apart from the reference's ``psm_*`` ones
#: in ``/dev/shm``, so a leak check of either package counts only its own
SEG_PREFIX = "fft_"
_SEG_SEQ = itertools.count()

_CACHE_LINE = 64
_HEAD_OFF = 0            # consumer-written counter, own cache line
_TAIL_OFF = _CACHE_LINE  # producer-written counter, own cache line
_DATA_OFF = 2 * _CACHE_LINE
_SLOT_HDR = struct.Struct("<IB3x")   # payload length, kind
_FRAME_HDR = struct.Struct("<IB")    # per-item header inside a BATCH slot
_KIND_INLINE = 0   # pickle, inline
_KIND_SPILL = 1    # pickle, spill file (slot carries the sequence number)
_KIND_RAW = 2      # buffer-protocol bytes: 1 subkind byte + raw payload
_KIND_NDARRAY = 3  # ndim,dtype-len,pad + dtype-str + shape(u64 each) + pad
                   # zeros + raw C data (64B-aligned when the frame starts
                   # a slot: aligned memcpy is ~4x an unaligned one)
_KIND_BATCH = 4    # u32 count + count frames of _FRAME_HDR + payload
_KIND_TENSOR = 5   # torch dtype-len + torch dtype name + an NDARRAY frame
_RAW_BYTES = 0
_RAW_BYTEARRAY = 1
_RAW_MEMORYVIEW = 2
_PICKLE_PROTO = pickle.HIGHEST_PROTOCOL  # sentinel __reduce__ needs >= 2
#: integer dtype of each width: a tensor whose dtype numpy lacks travels
#: as this view of its bytes
_RAW_TENSOR_VIEW = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _segment(size: int, name: Optional[str]) -> shared_memory.SharedMemory:
    """Create a segment of ``size`` bytes, named ``name`` or, by default,
    ``fft_<pid>_<n>`` (a name left over by an earlier process of the same
    pid is skipped)."""
    if name is not None:
        return shared_memory.SharedMemory(create=True, size=size, name=name)
    while True:
        try:
            return shared_memory.SharedMemory(
                create=True, size=size,
                name=f"{SEG_PREFIX}{os.getpid()}_{next(_SEG_SEQ)}")
        except FileExistsError:
            continue


class ShmRing:
    """Bounded wait-free SPSC FIFO in a ``SharedMemory`` segment.

    ``capacity`` is rounded up to a power of two minus the one sacrificial
    Lamport slot, exactly like ``SPSCQueue``; ``slot_size`` is the inline
    payload budget per slot (larger encodings spill, see module
    docstring).  ``zero_copy`` (default on) enables the typed RAW/NDARRAY
    slot kinds; off, every payload takes the pickle path — useful as a
    benchmark baseline and for payload types whose identity must survive
    the hop exactly.

    The creating process *owns* the segment: only ``unlink()`` from the
    owner destroys it (and sweeps leftover spill files).  The object
    pickles as an **attach**: sending a ring to a spawned child re-opens
    the same segment by name, which is how ``procgraph`` wires edges.
    ``pushes``/``pops`` are endpoint-local telemetry (each side counts its
    own operations; they are not shared state).
    """

    def __init__(self, capacity: int = 512, slot_size: int = 248, *,
                 name: Optional[str] = None, spill_dir: Optional[str] = None,
                 zero_copy: bool = True, _attach: bool = False):
        if capacity < 2:
            capacity = 2
        size = 1
        while size < capacity + 1:
            size <<= 1
        self._mask = size - 1
        self.slot_size = slot_size
        self._stride = -(-(_SLOT_HDR.size + slot_size) // _CACHE_LINE) \
            * _CACHE_LINE
        nbytes = _DATA_OFF + size * self._stride
        if _attach:
            self._shm = shared_memory.SharedMemory(name=name)
            self.owner = False
        else:
            self._shm = _segment(nbytes, name)
            self.owner = True
        # pinned at creation and carried through __reduce__: producer and
        # consumer must resolve identical spill paths even when their
        # environments disagree about TMPDIR
        self.spill_dir = spill_dir if spill_dir is not None \
            else tempfile.gettempdir()
        self.zero_copy = zero_copy
        self.name = self._shm.name
        self._mv = self._shm.buf
        self._idx = self._mv.cast("Q")  # [0] = head, [8] = tail (64B apart)
        if self.owner:
            self._idx[_HEAD_OFF // 8] = 0
            self._idx[_TAIL_OFF // 8] = 0
        self._spill_seq = 0  # producer-private; consumer tracks via slots
        self._pending: deque = deque()  # consumer-local tail of a BATCH slot
        # codec caches: streams are overwhelmingly homogeneous, so the
        # ndarray meta header (producer) and the parsed dtype (consumer)
        # are computed once per (dtype, shape) / dtype-string, not per item
        self._nd_meta: dict = {}
        self._nd_dtypes: dict = {}
        self._t_meta: dict = {}
        self._pickler: Optional[pickle.Pickler] = None
        self._pbuf: Optional[io.BytesIO] = None
        self.pushes = 0
        self.pops = 0
        self._closed = False

    # -- pickling = attach (how edges reach spawned vertices) ---------------
    def __reduce__(self):
        return (_attach_ring, (self.name, self._mask, self.slot_size,
                               self.spill_dir, self.zero_copy))

    # -- introspection (either side; cross-side values benignly stale) ------
    def __len__(self) -> int:
        return len(self._pending) \
            + ((self._idx[_TAIL_OFF // 8] - self._idx[_HEAD_OFF // 8])
               & self._mask)

    @property
    def capacity(self) -> int:
        return self._mask  # one slot reserved (Lamport full/empty)

    def empty(self) -> bool:
        return not self._pending \
            and self._idx[_HEAD_OFF // 8] == self._idx[_TAIL_OFF // 8]

    def full(self) -> bool:
        return ((self._idx[_TAIL_OFF // 8] + 1) & self._mask) \
            == self._idx[_HEAD_OFF // 8]

    # -- producer side ------------------------------------------------------
    def _spill_path(self, seq: int) -> str:
        return os.path.join(self.spill_dir,
                            f"ffshm-{self.name.lstrip('/')}-{seq}.spill")

    def _typed_frame(self, item: Any):
        """``(kind, meta, buf)`` for a buffer-protocol payload, else None.

        Exact-type checks only: subclasses may carry state the raw bytes
        would silently drop, so they take the pickle path.
        """
        t = type(item)
        if t is bytes:
            return _KIND_RAW, _RAW_BYTES_META, item
        if t is bytearray:
            return _KIND_RAW, _RAW_BYTEARRAY_META, item
        if t is memoryview:
            if not item.c_contiguous:
                return None
            if item.format != "B" or item.ndim != 1:
                item = item.cast("B")
            return _KIND_RAW, _RAW_MEMORYVIEW_META, item
        np = sys.modules.get("numpy")
        if np is not None and t is np.ndarray:
            key = (item.dtype, item.shape)
            meta = self._nd_meta.get(key, False)
            if meta is False:
                meta = self._build_nd_meta(item)
                if len(self._nd_meta) < 256:  # bounded: hetero streams
                    self._nd_meta[key] = meta
            if meta is None or not item.flags.c_contiguous:
                return None
            # an empty array's view cannot be cast (zeros in its shape)
            return _KIND_NDARRAY, meta, \
                item.data.cast("B") if item.size else b""
        torch = sys.modules.get("torch")
        if torch is not None and t is torch.Tensor:
            return self._tensor_frame(item, torch)
        return None

    def _tensor_frame(self, item: Any, torch: Any):
        """The ``TENSOR`` frame of an exact ``torch.Tensor``, else None
        (pickle path): see the module docstring for which tensors qualify.
        A CUDA tensor is copied to the host here."""
        view = _host_view(item, torch)
        if view is None:
            return None
        arr, name = view
        key = (item.dtype, arr.shape)
        meta = self._t_meta.get(key, False)
        if meta is False:
            tag = name.encode("ascii")
            meta = self._build_nd_meta(arr, bytes([len(tag)]) + tag)
            if len(self._t_meta) < 256:  # bounded: hetero streams
                self._t_meta[key] = meta
        if meta is None:
            return None
        return _KIND_TENSOR, meta, arr.data.cast("B") if arr.size else b""

    @staticmethod
    def _build_nd_meta(item: Any, prefix: bytes = b"") -> Optional[bytes]:
        """ndarray meta header, or None when the dtype/shape is untyped
        (object/structured/0-d): those fall back to pickle.

        The header is zero-padded so the raw data lands on a 64-byte
        boundary when the frame starts a slot (slots are cache-line
        aligned): an unaligned 16 KiB memcpy measures ~4x slower than an
        aligned one, which is most of a zero-copy hand-off's budget.
        ``prefix`` leads the header (the ``TENSOR`` kind's dtype name)."""
        if (item.dtype.hasobject or item.dtype.names is not None
                or item.ndim == 0 or item.ndim > 255):
            return None
        ds = item.dtype.str.encode("ascii")
        if len(ds) > 255:
            return None
        head = len(prefix) + 3 + len(ds) + 8 * item.ndim
        pad = -(_SLOT_HDR.size + head) % _CACHE_LINE
        return prefix + struct.pack("<BBB", item.ndim, len(ds), pad) + ds \
            + struct.pack(f"<{item.ndim}Q", *item.shape) + b"\x00" * pad

    def _write_frame(self, off: int, meta: bytes, buf) -> None:
        mv = self._mv
        mlen = len(meta)
        if mlen:
            mv[off:off + mlen] = meta
        blen = len(buf)
        if blen:
            mv[off + mlen:off + mlen + blen] = buf

    def _dumps(self, item: Any) -> bytes:
        """The pickle of ``item``.  Once the caller has torch loaded, a
        tensor nested in the payload (a farm's ``(tag, issued, payload)``
        token, a tuple, a list) travels as its host numpy view too, so a
        CUDA tensor reaches the far side on the host wherever it sits."""
        if "torch" not in sys.modules:
            return pickle.dumps(item, _PICKLE_PROTO)
        if self._pickler is None:  # producer-private, reused per push
            self._pbuf = io.BytesIO()
            self._pickler = _TensorPickler(self._pbuf, _PICKLE_PROTO)
        buf = self._pbuf
        buf.seek(0)
        buf.truncate()
        self._pickler.clear_memo()
        self._pickler.dump(item)
        return buf.getvalue()

    def _write_pickled(self, base: int, item: Any) -> None:
        blob = self._dumps(item)
        if len(blob) <= self.slot_size:
            _SLOT_HDR.pack_into(self._mv, base, len(blob), _KIND_INLINE)
            self._mv[base + _SLOT_HDR.size:
                     base + _SLOT_HDR.size + len(blob)] = blob
        else:
            # spill side-channel: blob to a producer-owned file, slot
            # carries the sequence number (file is durable before the
            # tail store publishes the slot)
            seq = self._spill_seq
            self._spill_seq += 1
            with open(self._spill_path(seq), "wb") as f:
                f.write(blob)
            _SLOT_HDR.pack_into(self._mv, base, 8, _KIND_SPILL)
            struct.pack_into("<Q", self._mv, base + _SLOT_HDR.size, seq)

    def push(self, item: Any) -> bool:
        """Non-blocking enqueue. Returns False when full. Producer-only."""
        idx = self._idx
        tail = idx[_TAIL_OFF // 8]
        nxt = (tail + 1) & self._mask
        if nxt == idx[_HEAD_OFF // 8]:
            return False
        base = _DATA_OFF + (tail & self._mask) * self._stride
        frame = self._typed_frame(item) if self.zero_copy else None
        if frame is not None:
            kind, meta, buf = frame
            size = len(meta) + len(buf)
            if size <= self.slot_size:
                _SLOT_HDR.pack_into(self._mv, base, size, kind)
                self._write_frame(base + _SLOT_HDR.size, meta, buf)
            else:
                frame = None  # larger than a slot: spill the pickle
        if frame is None:
            self._write_pickled(base, item)
        idx[_TAIL_OFF // 8] = nxt  # publish AFTER the payload (order matters)
        self.pushes += 1
        return True

    def push_many(self, items: Sequence[Any]) -> int:
        """Pack a run of ``items`` into ONE slot (kind ``BATCH``).

        Returns how many leading items were consumed: 0 when the ring is
        full, otherwise at least 1 — an item whose frame alone exceeds
        the slot budget ships unbatched through ``push`` (taking the
        spill path if needed) so the caller's loop always advances.
        FIFO order is preserved; the consumer unpacks transparently.
        """
        if not items:
            return 0
        idx = self._idx
        tail = idx[_TAIL_OFF // 8]
        nxt = (tail + 1) & self._mask
        if nxt == idx[_HEAD_OFF // 8]:
            return 0
        base = _DATA_OFF + (tail & self._mask) * self._stride
        start = base + _SLOT_HDR.size
        limit = start + self.slot_size
        pos = start + 4  # u32 batch count, patched below
        count = 0
        for item in items:
            frame = self._typed_frame(item) if self.zero_copy else None
            if frame is None:
                kind, meta, buf = _KIND_INLINE, b"", self._dumps(item)
            else:
                kind, meta, buf = frame
            size = len(meta) + len(buf)
            if pos + _FRAME_HDR.size + size > limit:
                break
            _FRAME_HDR.pack_into(self._mv, pos, size, kind)
            pos += _FRAME_HDR.size
            self._write_frame(pos, meta, buf)
            pos += size
            count += 1
        if count == 0:
            # first item alone blows the batch budget: ship it solo
            return 1 if self.push(items[0]) else 0
        struct.pack_into("<I", self._mv, start, count)
        _SLOT_HDR.pack_into(self._mv, base, pos - start, _KIND_BATCH)
        idx[_TAIL_OFF // 8] = nxt
        self.pushes += count
        return count

    def push_wait(self, item: Any, timeout: Optional[float] = None) -> bool:
        """Blocking enqueue with truncated-exponential spin/yield backoff."""
        deadline = None if timeout is None else time.monotonic() + timeout
        backoff = Backoff()
        while not self.push(item):
            if not backoff.pause(deadline):
                return False
        return True

    # -- consumer side ------------------------------------------------------
    def _decode_frame(self, kind: int, off: int, length: int) -> Any:
        mv = self._mv
        if kind == _KIND_INLINE:
            return pickle.loads(mv[off:off + length])
        if kind == _KIND_RAW:
            raw = bytes(mv[off + 1:off + length])
            return bytearray(raw) if mv[off] == _RAW_BYTEARRAY else raw
        if kind == _KIND_NDARRAY:
            return self._decode_ndarray(off)
        if kind == _KIND_TENSOR:
            tlen = mv[off]
            return _rebuild_tensor(self._decode_ndarray(off + 1 + tlen),
                                   bytes(mv[off + 1:off + 1 + tlen]).decode())
        raise ValueError(f"corrupt slot kind {kind!r}")  # pragma: no cover

    def _decode_ndarray(self, off: int) -> Any:
        mv = self._mv
        import numpy as np  # producer proved it importable (kind check)
        ndim, dlen, pad = mv[off], mv[off + 1], mv[off + 2]
        pos = off + 3
        dbytes = bytes(mv[pos:pos + dlen])
        dtype = self._nd_dtypes.get(dbytes)
        if dtype is None:
            dtype = np.dtype(dbytes.decode("ascii"))
            self._nd_dtypes[dbytes] = dtype
        pos += dlen
        shape = _shape_struct(ndim).unpack_from(mv, pos)
        pos += 8 * ndim + pad
        count = 1
        for dim in shape:
            count *= dim
        if not count:
            return np.empty(shape, dtype)
        # one aligned memcpy out of the segment (copy() owns its data:
        # the slot is free for reuse the moment head publishes)
        return np.frombuffer(mv, dtype, count, pos).reshape(shape).copy()

    def pop(self) -> Any:
        """Non-blocking dequeue. Returns ``SPSCQueue._EMPTY`` when empty."""
        if self._pending:
            self.pops += 1
            return self._pending.popleft()
        idx = self._idx
        head = idx[_HEAD_OFF // 8]
        if head == idx[_TAIL_OFF // 8]:
            return SPSCQueue._EMPTY
        base = _DATA_OFF + (head & self._mask) * self._stride
        length, kind = _SLOT_HDR.unpack_from(self._mv, base)
        off = base + _SLOT_HDR.size
        if kind == _KIND_SPILL:
            seq = struct.unpack_from("<Q", self._mv, off)[0]
            path = self._spill_path(seq)
            with open(path, "rb") as f:
                raw = f.read()
            # decode BEFORE unlink and BEFORE the head store: a consumer
            # dying here leaves the file for the owner's sweep and the
            # slot intact for a retry — the item is never lost
            item = pickle.loads(raw)
            os.unlink(path)
        elif kind == _KIND_BATCH:
            count = struct.unpack_from("<I", self._mv, off)[0]
            pos = off + 4
            item = None
            pending = self._pending
            for i in range(count):
                flen, fkind = _FRAME_HDR.unpack_from(self._mv, pos)
                pos += _FRAME_HDR.size
                decoded = self._decode_frame(fkind, pos, flen)
                pos += flen
                if i == 0:
                    item = decoded
                else:
                    pending.append(decoded)
        else:
            item = self._decode_frame(kind, off, length)
        idx[_HEAD_OFF // 8] = (head + 1) & self._mask  # release AFTER reading
        self.pops += 1
        return item

    def pop_wait(self, timeout: Optional[float] = None) -> Any:
        """Blocking dequeue with truncated-exponential spin/yield backoff.

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

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Drop this process's mapping (the segment survives for peers)."""
        if self._closed:
            return
        self._closed = True
        self._idx.release()
        self._mv = None
        self._shm.close()

    def __del__(self):
        # release the cast view before SharedMemory's own __del__ runs, or
        # its close() raises BufferError ("exported pointers exist")
        try:
            self.close()
        except Exception:  # pragma: no cover - interpreter-shutdown races
            pass

    def unlink(self) -> None:
        """Owner-only: destroy the segment and sweep leftover spill files."""
        self.close()
        if not self.owner:
            return
        for path in glob.glob(os.path.join(
                self.spill_dir, f"ffshm-{self.name.lstrip('/')}-*.spill")):
            try:
                os.unlink(path)
            except OSError:  # pragma: no cover - another sweep won the race
                pass
        try:
            self._shm.unlink()
        except FileNotFoundError:  # pragma: no cover - already unlinked
            pass


def _host_view(item: Any, torch: Any) -> Optional[Tuple[Any, str]]:
    """``(numpy view, dtype name)`` of a tensor the ``TENSOR`` kind takes,
    else None: exact ``torch.Tensor``, strided, at least 1-d, contiguous,
    no grad, no conjugate or negative bit, on the host or on a CUDA
    device (copied to the host here).  A dtype numpy lacks is viewed as
    the integer dtype of its width."""
    if (item.requires_grad or item.layout is not torch.strided
            or item.dim() == 0 or not item.is_contiguous()
            or item.is_quantized or item.is_conj() or item.is_neg()):
        return None
    if item.device.type == "cuda":
        item = item.cpu()
    elif item.device.type != "cpu":
        return None
    try:
        arr = item.numpy()
    except TypeError:  # a dtype numpy lacks: send its integer view
        raw = _RAW_TENSOR_VIEW.get(item.element_size())
        if raw is None:
            return None
        arr = item.view(getattr(torch, raw)).numpy()
    return arr, str(item.dtype).rpartition(".")[2]


def _rebuild_tensor(arr: Any, name: str) -> Any:
    """The far side of :func:`_host_view`: the tensor over ``arr``,
    viewed back to its dtype (module-level: pickles by name)."""
    import torch  # the producer had it loaded
    out = torch.from_numpy(arr)
    dtype = getattr(torch, name)
    return out if out.dtype == dtype else out.view(dtype)


class _TensorPickler(pickle.Pickler):
    """Pickler that sends each tensor :func:`_host_view` takes as that
    view (used only once the producer has torch loaded)."""

    def reducer_override(self, obj: Any) -> Any:
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) is torch.Tensor:
            view = _host_view(obj, torch)
            if view is not None:
                return _rebuild_tensor, view
        return NotImplemented


_SHAPE_STRUCTS: dict = {}


def _shape_struct(ndim: int) -> struct.Struct:
    s = _SHAPE_STRUCTS.get(ndim)
    if s is None:
        s = _SHAPE_STRUCTS[ndim] = struct.Struct(f"<{ndim}Q")
    return s


_RAW_BYTES_META = bytes([_RAW_BYTES])
_RAW_BYTEARRAY_META = bytes([_RAW_BYTEARRAY])
_RAW_MEMORYVIEW_META = bytes([_RAW_MEMORYVIEW])


def _attach_ring(name: str, mask: int, slot_size: int,
                 spill_dir: Optional[str] = None,
                 zero_copy: bool = True) -> ShmRing:
    ring = ShmRing.__new__(ShmRing)
    ShmRing.__init__(ring, mask, slot_size, name=name, spill_dir=spill_dir,
                     zero_copy=zero_copy, _attach=True)
    return ring


class ShmCounters:
    """``n`` single-writer u64 counters, one per cache line, in shared
    memory — the cross-process analogue of ``TagSpace``'s split counters.

    ``procgraph`` uses a 2-counter board per wrap-around farm: slot 0
    (``entered``) is written only by the dispatch arbiter, slot 1
    (``retired``) only by the merge arbiter; each side reads the other's
    slot benignly stale, with the same store-ordering argument as the
    ring (the merge arbiter pushes looped-back tasks *before* bumping
    ``retired``, so the dispatcher's quiescence check stays race-free).
    """

    def __init__(self, n: int = 2, *, name: Optional[str] = None,
                 _attach: bool = False):
        self.n = n
        if _attach:
            self._shm = shared_memory.SharedMemory(name=name)
            self.owner = False
        else:
            self._shm = _segment(n * _CACHE_LINE, name)
            self.owner = True
        self.name = self._shm.name
        self._idx = self._shm.buf.cast("Q")
        if self.owner:
            for i in range(n):
                self._idx[i * (_CACHE_LINE // 8)] = 0
        self._closed = False

    def __reduce__(self):
        return (_attach_counters, (self.name, self.n))

    def get(self, i: int) -> int:
        return self._idx[i * (_CACHE_LINE // 8)]

    def snapshot(self) -> tuple:
        """All ``n`` values at once (each slot individually racy-fresh —
        fine for telemetry readouts like ``oocore.MemoryBudget.collect``,
        which runs after the writers have joined anyway)."""
        step = _CACHE_LINE // 8
        return tuple(self._idx[i * step] for i in range(self.n))

    def add(self, i: int, delta: int = 1) -> None:
        """Single-writer increment (exactly one process may write slot i)."""
        off = i * (_CACHE_LINE // 8)
        self._idx[off] = self._idx[off] + delta

    def peek(self) -> Optional[tuple]:
        """Teardown-safe :meth:`snapshot` for outside observers (the live
        monitor samples these boards from its own thread, which may race
        the graph's cleanup): returns ``None`` instead of raising once
        the board is closed or its memoryview released mid-read."""
        if self._closed:
            return None
        try:
            return self.snapshot()
        except (ValueError, OSError):  # released buf / vanished segment
            return None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._idx.release()
        self._shm.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # pragma: no cover - interpreter-shutdown races
            pass

    def unlink(self) -> None:
        self.close()
        if self.owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass


def _attach_counters(name: str, n: int) -> ShmCounters:
    board = ShmCounters.__new__(ShmCounters)
    ShmCounters.__init__(board, n, name=name, _attach=True)
    return board


class ShmFlag:
    """A one-way cross-process flag in its own shared segment.

    Unlike the single-writer counters, *any* attached process may
    ``set()`` it: every writer stores the same value (1), so racing
    stores are idempotent and the usual single-writer discipline is not
    needed.  ``procgraph`` uses one per graph as the failure flag —
    vertices poll ``is_set()`` in their blocking loops and abort instead
    of wedging, and unlike ``multiprocessing.Event`` the flag pickles as
    a plain attach, so it can ride through queues to pooled workers.
    """

    def __init__(self, *, name: Optional[str] = None, _attach: bool = False):
        if _attach:
            self._shm = shared_memory.SharedMemory(name=name)
            self.owner = False
        else:
            self._shm = _segment(_CACHE_LINE, name)
            self.owner = True
        self.name = self._shm.name
        self._idx = self._shm.buf.cast("Q")
        if self.owner:
            self._idx[0] = 0
        self._closed = False

    def __reduce__(self):
        return (_attach_flag, (self.name,))

    def set(self) -> None:
        self._idx[0] = 1

    def is_set(self) -> bool:
        return self._idx[0] != 0

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._idx.release()
        self._shm.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # pragma: no cover - interpreter-shutdown races
            pass

    def unlink(self) -> None:
        self.close()
        if self.owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass


def _attach_flag(name: str) -> ShmFlag:
    flag = ShmFlag.__new__(ShmFlag)
    ShmFlag.__init__(flag, name=name, _attach=True)
    return flag
