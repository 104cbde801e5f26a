"""Rank processes: the port's form of the reference's device mesh.

The reference runs a mesh program as one SPMD ``shard_map`` over the
devices of a ``jax.sharding.Mesh``; an axis name inside it selects the
devices a collective spans.  The port runs one *rank process* per device
of the mesh, and an axis becomes a ``torch.distributed`` process group:

* :class:`RankPool` spawns ``world`` rank processes (the ``spawn`` start
  method: a fork after CUDA is initialised is unsafe), which meet through
  a ``file://`` store in a temporary directory (no fixed TCP port, so
  pools of concurrent test processes never collide), each bound to its
  device.  :meth:`RankPool.run` sends a picklable job to every rank at
  once, gathers the results in rank order with each rank's kernel
  launches, and fails the whole call if one rank fails.
* Inside a rank, a job receives its :class:`RankContext`: the rank, its
  device, the transport, and :meth:`RankContext.grid`, which makes the
  process groups of a ``(stage, worker)`` factorization — one per stage
  row and one per worker column, on every rank, in the same order.
  A :class:`Group` is what a reference function names by ``axis_name``.
  :func:`current` gives the rank's context to code that is not handed
  it (``repro_torch.parallel.context.mesh_context``).

The transport is explicit.  ``"nccl"`` (the default) needs a card per
rank.  ``"gloo"`` takes any layout, CPU ranks included: on CUDA ranks it
moves every tensor of an exchange to the host and back after it
(:meth:`RankContext.to_wire`, counted in ``RankContext.staged``).  More
ranks than cards without ``transport=`` raises :class:`LoweringError`
naming ``transport="gloo"``: nothing switches the transport silently.

:func:`simulated` makes the calling process play one rank of a pool that
does not exist, for the dry run (``repro_torch.launch.dryrun``): torch's
in-process ``"fake"`` process group stands behind every group, so a
collective on ``meta`` tensors completes and sends nothing, and
:func:`current` gives a :class:`RankContext` over it.

Jobs and results cross the pipe as ordinary pickles (tensors inline, by
value), so no shared-memory segment outlives a call.  :func:`pool` keeps
one pool per layout for the process, which the mesh programs share;
:func:`shutdown` (also run at interpreter exit) retires them all.
"""
from __future__ import annotations

import atexit
import datetime
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from contextlib import contextmanager
from multiprocessing.connection import wait as _wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..kernels import _build
from .skeleton import LoweringError

__all__ = ["TRANSPORTS", "RankPool", "RankContext", "Group", "card_count",
           "plan_ranks", "pool", "shutdown", "current", "simulated"]

TRANSPORTS = ("nccl", "gloo")
_GRACE_S = 10.0     # how long the other ranks may take to fail after one did
_TIMEOUT_S = 600.0  # a job, or a collective inside one, that takes longer hung


def card_count() -> int:
    """The CUDA cards this process sees."""
    return torch.cuda.device_count()


def plan_ranks(world: int, device: Any = None,
               transport: Optional[str] = None) -> Tuple[List[str], str]:
    """Each rank's device and the transport, or the refusal.

    ``device=None`` (or ``"cuda"``) spreads the ranks over the cards, rank
    r on ``cuda:(r % cards)``, and raises without a card; ``"cuda:k"``
    puts every rank on card k; ``"cpu"`` runs CPU ranks (the tests).
    ``transport=None`` is NCCL, which needs a card per rank: with more
    ranks than cards it raises :class:`LoweringError` naming
    ``transport="gloo"``."""
    if world < 1:
        raise LoweringError(f"a rank pool needs at least one rank, got {world}")
    dev = None if device is None else torch.device(device)
    if dev is None or (dev.type == "cuda" and dev.index is None):
        cards = card_count()
        if cards == 0:
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the ranks on the CPU")
        devices = [f"cuda:{r % cards}" for r in range(world)]
    elif dev.type == "cuda":
        cards = 1
        devices = [str(dev)] * world
    elif dev.type == "cpu":
        cards = 0
        devices = ["cpu"] * world
    else:
        raise LoweringError(f"no rank transport for device {dev}")
    if transport is not None and transport not in TRANSPORTS:
        raise LoweringError(f"unknown transport {transport!r} "
                            f"(have {TRANSPORTS})")
    if transport in (None, "nccl") and world > cards:
        where = "the CPU" if cards == 0 else f"{cards} card(s)"
        raise LoweringError(
            f"{world} ranks on {where}: NCCL needs a card of its own for "
            f"every rank; pass transport=\"gloo\" to stage each exchange "
            f"through the host (ranks may then share a card)")
    return devices, transport or "nccl"


# ---------------------------------------------------------------------------
# inside a rank
# ---------------------------------------------------------------------------
class Group:
    """The ranks one collective spans: the reference's ``axis_name``.

    ``ranks`` are the global ranks in axis order, ``rank`` this process's
    index among them (``lax.axis_index``), ``size`` their count
    (``axis_size``); ``pg`` is the ``torch.distributed`` group and ``ctx``
    the rank's :class:`RankContext` (its device and transport)."""

    def __init__(self, ctx: "RankContext", ranks: Sequence[int], pg: Any):
        self.ctx = ctx
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(ctx.rank)
        self.pg = pg

    def __repr__(self) -> str:
        return f"Group(ranks={self.ranks}, rank={self.rank})"


class RankContext:
    """What a job sees inside its rank process."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 transport: str):
        self.rank = rank
        self.world = world
        self.device = device
        self.transport = transport
        #: gloo over a CUDA device: every exchange goes through the host
        self.host_staged = transport == "gloo" and device.type == "cuda"
        #: tensors moved between the card and the host for an exchange
        #: during the current job (each direction counts)
        self.staged = 0
        self.world_group = Group(self, range(world), dist.group.WORLD)
        self._grids: Dict[Tuple[int, int], Tuple[Group, Group]] = {}

    def grid(self, n_stage: int, n_worker: int) -> Tuple[Group, Group]:
        """``(stage group, worker group)`` of this rank in a ``(n_stage,
        n_worker)`` factorization of the world: rank ``s * n_worker + w``
        is stage ``s``, worker ``w``.  The stage group is the worker
        column (the pipeline's chain), the worker group the stage row (a
        farm's workers).  Every rank makes every group, in the same order,
        on its first call with these sizes."""
        key = (n_stage, n_worker)
        if key not in self._grids:
            if n_stage * n_worker != self.world:
                raise LoweringError(
                    f"a ({n_stage}, {n_worker}) grid needs "
                    f"{n_stage * n_worker} ranks, the pool has {self.world}")
            rows = [list(range(s * n_worker, (s + 1) * n_worker))
                    for s in range(n_stage)]
            cols = [list(range(w, self.world, n_worker))
                    for w in range(n_worker)]
            row_pgs = [dist.new_group(r) for r in rows]
            col_pgs = [dist.new_group(c) for c in cols]
            s, w = divmod(self.rank, n_worker)
            self._grids[key] = (Group(self, cols[w], col_pgs[w]),
                                Group(self, rows[s], row_pgs[s]))
        return self._grids[key]

    def to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport sends it: contiguous, and moved to the
        host when gloo carries a CUDA tensor (counted in ``staged``)."""
        if self.host_staged and t.is_cuda:
            self.staged += 1
            return t.cpu()
        return t.contiguous()

    def recv_buffer(self, t: torch.Tensor) -> torch.Tensor:
        """An empty buffer that receives a tensor like ``t``: on the host
        when the exchange is host-staged."""
        dev = "cpu" if self.host_staged and t.is_cuda else t.device
        return torch.empty(t.shape, dtype=t.dtype, device=dev)

    def from_wire(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """A received tensor on ``device``: the move back to the card of a
        host-staged exchange (counted in ``staged``)."""
        if t.device == device:
            return t
        self.staged += 1
        return t.to(device)


_CURRENT: Optional[RankContext] = None


def current() -> Optional[RankContext]:
    """The :class:`RankContext` of this process when it is a rank (a job
    runs in it), else None."""
    return _CURRENT


@contextmanager
def simulated(world: int, rank: int = 0, *, device: Any = "meta",
              transport: str = "nccl"):
    """This process as rank ``rank`` of ``world``, with nothing sent: the
    dry run's rank.  Starts torch's ``"fake"`` process group in-process
    (every collective over it completes at once and moves no data, which
    suits ``meta`` tensors), makes :func:`current` the
    :class:`RankContext` over it — so ``parallel.context.mesh_context``
    builds its groups through :meth:`RankContext.grid` unchanged — and on
    exit destroys the group and restores the previous context.
    ``transport`` is the one whose rules the exchanges follow
    (``"gloo"``: 16-bit sums go as float32, ``parallel.context``), so the
    accounting of a run on NCCL and of the card's gloo ranks differ as the
    runs do.  ``device`` is the rank's device (``"meta"``)."""
    if transport not in TRANSPORTS:
        raise LoweringError(f"unknown transport {transport!r} "
                            f"(have {TRANSPORTS})")
    if dist.is_initialized():
        raise RuntimeError("a process group is already running here: a "
                           "simulated rank needs a process of its own")
    # an internal module of torch's own tests, imported only here
    from torch.testing._internal.distributed.fake_pg import FakeStore
    global _CURRENT
    prev = _CURRENT
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        _CURRENT = RankContext(rank, world, torch.device(device), transport)
        yield _CURRENT
    finally:
        _CURRENT = prev
        dist.destroy_process_group()


#: bytes a pipe message carries at most: a message goes as a count of
#: frames, then the frames.  A receiver reads a whole message with one
#: read call the size of the message, which some hosts serve very slowly
#: (``tools/pipe_frames.py`` times both forms).
_FRAME = 1 << 24


def _send_blob(conn, blob: bytes) -> None:
    view = memoryview(blob)
    n = max(1, -(-len(view) // _FRAME))
    conn.send_bytes(n.to_bytes(8, "little"))
    for i in range(n):
        conn.send_bytes(view[i * _FRAME:(i + 1) * _FRAME])


def _send(conn, msg: Any) -> None:
    _send_blob(conn, pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))


def _recv(conn) -> Any:
    n = int.from_bytes(conn.recv_bytes(), "little")
    if n == 1:
        return pickle.loads(conn.recv_bytes())
    buf = bytearray()
    for _ in range(n):
        buf += conn.recv_bytes()
    return pickle.loads(buf)


def _picklable(e: BaseException) -> BaseException:
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:  # any failure to round-trip: send its text instead
        return RuntimeError(f"{type(e).__name__}: {e}")


def _rank_main(rank: int, world: int, store: str, device: str,
               transport: str, conn) -> None:
    """A rank process: join the group, then run jobs until told to stop."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.set_num_threads(1)
    dist.init_process_group(transport, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    global _CURRENT
    try:
        ctx = _CURRENT = RankContext(rank, world, dev, transport)
        _send(conn, ("ready", None, None, 0))
        while True:
            msg = _recv(conn)
            if msg is None:
                break
            fn, args = msg
            before = _build.launch_counts()
            ctx.staged = 0
            try:
                out = fn(ctx, *args)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                after = _build.launch_counts()
                reply = ("ok", out, {k: after[k] - before[k] for k in after},
                         ctx.staged)
            except BaseException as e:  # reported to the caller, who raises
                reply = ("err", _picklable(e), traceback.format_exc(), 0)
            _send(conn, reply)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the caller's side
# ---------------------------------------------------------------------------
class RankPool:
    """``world`` rank processes, one per device of the mesh.

    ``device`` and ``transport`` as :func:`plan_ranks`.  On CUDA ranks the
    caller builds the kernels' libraries before the ranks start, so the
    ranks load them instead of running nvcc at once.  ``ready_s`` is the
    time from the first spawn to the last rank joining its group.
    ``launches`` sums the kernel launches the ranks report (name ->
    count; :meth:`reset_counts` zeroes it) and ``staged`` their host-staged
    moves.  A job that raised on some ranks only, a dead rank or a call
    past ``_TIMEOUT_S`` closes the pool and raises; a job that raised on
    every rank leaves it open."""

    def __init__(self, world: int, *, device: Any = None,
                 transport: Optional[str] = None):
        self.devices, self.transport = plan_ranks(world, device, transport)
        self.world = world
        self.launches: Dict[str, int] = dict.fromkeys(_build.LAUNCH_KEYS, 0)
        self.staged = 0
        self.ready_s: Optional[float] = None
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        self._dir: Optional[str] = None
        self._start()

    @property
    def closed(self) -> bool:
        return not self._procs

    @property
    def pids(self) -> List[int]:
        """The rank processes' pids, in rank order (none once closed)."""
        return [p.pid for p in self._procs]

    def _start(self) -> None:
        if self.devices[0].startswith("cuda"):
            _build.load_all()
        self._dir = tempfile.mkdtemp(prefix="repro-ranks-")
        store = os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        try:
            for r in range(self.world):
                ours, theirs = ctx.Pipe()
                p = ctx.Process(target=_rank_main, name=f"rank-{r}",
                                daemon=True,
                                args=(r, self.world, store, self.devices[r],
                                      self.transport, theirs))
                p.start()
                theirs.close()
                self._procs.append(p)
                self._conns.append(ours)
            self._gather()
        except BaseException:
            self.close()
            raise
        self.ready_s = time.perf_counter() - t0

    def reset_counts(self) -> None:
        self.launches = dict.fromkeys(_build.LAUNCH_KEYS, 0)
        self.staged = 0

    def run(self, fn: Callable, *args: Any,
            per_rank: Optional[Sequence[Any]] = None) -> List[Any]:
        """``fn(ctx, *args)`` on every rank at once — ``fn(ctx, *args,
        per_rank[r])`` on rank r when ``per_rank`` is given — and the
        results in rank order.  ``fn`` and its arguments must pickle
        (module-level functions, not lambdas)."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        if per_rank is not None and len(per_rank) != self.world:
            raise ValueError(f"per_rank has {len(per_rank)} entries for "
                             f"{self.world} ranks")
        msgs = [(fn, args + (() if per_rank is None else (per_rank[r],)))
                for r in range(self.world)]
        try:
            blobs = [pickle.dumps(m, protocol=pickle.HIGHEST_PROTOCOL)
                     for m in msgs]
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise LoweringError(
                f"a rank job must pickle (module-level functions, "
                f"functools.partial, or picklable objects — not lambdas or "
                f"closures): {e!r}") from e
        for conn, blob in zip(self._conns, blobs):
            _send_blob(conn, blob)
        replies = self._gather()
        for _, _, counts, staged in replies:
            for k, v in counts.items():
                self.launches[k] += v
            self.staged += staged
        return [r[1] for r in replies]

    def _gather(self) -> List[Tuple]:
        """One reply from every rank, in rank order; raises (closing the
        pool unless every rank failed alike) on a failure."""
        replies: Dict[int, Tuple] = {}
        deadline = time.monotonic() + _TIMEOUT_S
        failed: Optional[Tuple[int, Tuple, float]] = None  # rank, reply, until
        while len(replies) < self.world:
            left = deadline - time.monotonic()
            if failed is not None:
                left = min(left, failed[2] - time.monotonic())
            waiting = {self._conns[r]: r for r in range(self.world)
                       if r not in replies}
            ready = _wait(list(waiting), timeout=max(0.0, left))
            if not ready:
                break
            for conn in ready:
                r = waiting[conn]
                try:
                    replies[r] = _recv(conn)
                except (EOFError, OSError):
                    code = self._procs[r].exitcode
                    self.close()
                    raise RuntimeError(f"rank {r} died (exit code {code})")
                if replies[r][0] == "err" and failed is None:
                    failed = (r, replies[r], time.monotonic() + _GRACE_S)
        if failed is not None:
            r, (_, exc, tb, _), _ = failed
            if len(replies) < self.world:
                self.close()     # the others may wait in a collective forever
            exc.add_note(f"raised on rank {r} of {self.world}:\n{tb}")
            raise exc
        if len(replies) < self.world:
            missing = sorted(set(range(self.world)) - set(replies))
            self.close()
            raise TimeoutError(f"ranks {missing} did not answer within "
                               f"{_TIMEOUT_S} s")
        return [replies[r] for r in range(self.world)]

    def close(self) -> None:
        """Stop every rank (each destroys its process group), then remove
        the store."""
        for conn in self._conns:
            try:
                _send(conn, None)
            except (OSError, ValueError):
                pass
        until = time.monotonic() + 30
        for p in self._procs:
            p.join(timeout=max(0.0, until - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None
        for key, p in list(_POOLS.items()):
            if p is self:
                del _POOLS[key]


_POOLS: Dict[Tuple, RankPool] = {}


def pool(world: int, *, device: Any = None,
         transport: Optional[str] = None) -> RankPool:
    """The process's pool for this layout, started on first use (the mesh
    programs share it)."""
    devices, transport = plan_ranks(world, device, transport)
    key = (tuple(devices), transport)
    p = _POOLS.get(key)
    if p is None or p.closed:
        p = _POOLS[key] = RankPool(world, device=device, transport=transport)
    return p


def shutdown() -> None:
    """Close every pool :func:`pool` started (tests and interpreter exit)."""
    for p in list(_POOLS.values()):
        p.close()


atexit.register(shutdown)
