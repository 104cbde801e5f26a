"""Serving engine — continuous batching as the order-preserving farm,
running on the skeleton graph (``Source(requests) ∘ Farm(decode_step,
feedback=still_generating)``).

Counterpart of ``repro.launch.serve``, on the port's threads lowering.
The mapping from paper Sec. 3.1 to an inference engine:

  Emitter   = the **admitter**: pulls requests off an SPSC ring, assigns a
              monotone tag, a decode-batch slot from the SPMC ``PagePool``
              (one allocating entity — the admitter; the collector frees);
  Workers   = the decode step itself, advancing the whole (continuously
              re-filled) batch each tick;
  Collector = detokeniser: detects finished sequences, releases their
              slots, and emits results **in tag order**.

One tick is one ``decode_step`` over the batch: the tick token circulates
the farm's wrap-around ring while any admitted sequence is still
generating, and the loop-quiescence protocol ends the run.  Requests are
admitted into recycled slots mid-stream; per-slot ``start_pos`` masks each
request's attention to its own KV span.  Prompt ingestion is token by
token (one decode step per prompt token), as in the reference, so serving
runs ``decode_step`` only: plain PyTorch, no hand-written kernel.  The
engine owns its cache and zeroes a recycled slot in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import ARCHS
from ..core.allocator import PagePool
from ..core.obs import MetricsRegistry, Tracer
from ..core.sched import CostModel
from ..core.skeleton import Farm, Source, compose, lower
from ..core.spsc import SPSCQueue
from ..kernels.ops import resolve_device
from ..models.config import ModelConfig
from ..models.model import decode_step as model_decode
from ..models.model import init_cache, init_params

__all__ = ["Request", "ServeEngine"]

_TICK = object()  # the decode-tick token circulating the wrap-around ring


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    submitted: float = 0.0  # monotonic submit() timestamp (latency origin)
    tag: int = -1
    slot: int = -1
    start: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    fed: int = 0  # prompt tokens consumed


class ServeEngine:
    """Continuous-batching engine over ``decode_step`` on ``device``
    (``None``: the card).  ``params`` defaults to ``init_params(cfg,
    seed)``.

    ``slo=`` takes a :class:`~repro_torch.core.monitor.SLOMonitor` — after
    every ``run()`` its thresholds (p99 latency over the engine's
    ``serve.request_latency_us`` histogram, goodput in tokens/s) are
    checked; alerts land in ``slo.events``, in the registry's
    ``slo.alerts`` counter (and its ``watch()`` callbacks), and as
    ``alert`` instants on an ``slo-monitor`` trace lane
    (``engine.last_trace``), time-aligned with the run.

    The step feeds token ids only, so two families are refused here, at
    construction: audio (the reference's step raises the same error) and
    vlm (the reference's step carries no vision stream and fails on the
    missing ``vision_embeds``)."""

    def __init__(self, cfg: ModelConfig, *, max_batch: int = 4,
                 max_len: int = 256, seed: int = 0, params=None,
                 slo=None, device: Any = None):
        if cfg.family == "audio":
            raise NotImplementedError("audio serving uses frame embeddings")
        if cfg.family == "vlm":
            raise NotImplementedError(
                "vlm serving: the decode step carries no vision stream "
                "(batch['vision_embeds'])")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.params = params if params is not None else init_params(
            cfg, seed, device=self.device)
        self.cache = init_cache(cfg, max_batch, max_len, device=self.device)
        # SPMC pool: slots are the pages (admitter allocs, collector frees)
        self.pool = PagePool(max_batch, nfreers=1)
        self.in_q = SPSCQueue(1024)
        self._pending: deque = deque()             # admitted-to-graph queue
        self.active: Dict[int, Request] = {}       # slot -> request
        self.done: Dict[int, Request] = {}         # tag -> finished request
        self.emit_next = 0
        self.results: List[Request] = []
        self.cache_len = 0
        self.tag_counter = 0
        self.steps_run = 0
        self.metrics = MetricsRegistry()
        self._latency = self.metrics.histogram("serve.request_latency_us")
        self.last_report = None
        self.slo = slo
        self.tracer = None
        self.last_trace = None
        if slo is not None:
            if slo.registry is None:
                slo.registry = self.metrics
            self.tracer = Tracer()
            slo.bind(self.tracer)

    # -- emitter side --------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.submitted == 0.0:
            req.submitted = time.monotonic()
        self.in_q.push_wait(req)

    def _admit(self) -> None:
        while self.pool.available() or self.pool.drain():
            if self._pending:                      # streamed in via the graph
                nxt = self._pending.popleft()
            else:
                nxt = self.in_q.pop()
                if nxt is SPSCQueue._EMPTY:
                    return
            slot = self.pool.alloc()
            nxt.tag = self.tag_counter
            self.tag_counter += 1
            nxt.slot = slot
            nxt.start = self.cache_len
            self._reset_slot(slot)
            self.active[slot] = nxt

    def _reset_slot(self, slot: int) -> None:
        """Zero the recycled slot's cache state (SSM state must reset;
        attention K/V is masked by start_pos, zeroing is belt-and-braces).
        The reference's rule, kept for parity: in every leaf, the FIRST
        axis whose size equals ``max_batch`` is taken for the batch axis."""
        for leaf in self.cache.values():
            for ax in range(leaf.dim()):
                if leaf.shape[ax] == self.max_batch:
                    leaf.select(ax, slot).zero_()
                    break

    # -- one farm iteration ----------------------------------------------------
    def step(self) -> None:
        self._admit()
        if not self.active:
            return
        tokens = np.zeros((self.max_batch, 1), np.int64)
        start = np.zeros((self.max_batch,), np.int64)
        for slot, req in self.active.items():
            if req.fed < len(req.prompt):
                tokens[slot, 0] = req.prompt[req.fed]
            else:
                tokens[slot, 0] = req.generated[-1] if req.generated else 0
            start[slot] = req.start
        batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                 "start_pos": torch.from_numpy(start).to(self.device)}
        with torch.no_grad():
            logits, self.cache = model_decode(self.params, batch, self.cache,
                                              self.cache_len, self.cfg)
        self.cache_len += 1
        self.steps_run += 1
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        finished = []
        for slot, req in self.active.items():
            if req.fed < len(req.prompt):
                req.fed += 1          # still ingesting the prompt
                continue
            tok = int(nxt[slot])
            req.generated.append(tok)
            if (req.eos_id is not None and tok == req.eos_id) or \
               len(req.generated) >= req.max_new:
                finished.append(slot)
        # -- collector: free slots, emit in tag order ---------------------------
        for slot in finished:
            req = self.active.pop(slot)
            self.pool.free(slot, 0)
            self.done[req.tag] = req
        while self.emit_next in self.done:
            req = self.done.pop(self.emit_next)
            if req.submitted:
                self._latency.observe(
                    (time.monotonic() - req.submitted) * 1e6)
            self.results.append(req)
            self.emit_next += 1

    def _drain_submitted(self) -> List[Request]:
        """Everything submitted so far, in submission order (the stream the
        serving graph's Source replays)."""
        reqs: List[Request] = []
        while True:
            r = self.in_q.pop()
            if r is SPSCQueue._EMPTY:
                return reqs
            reqs.append(r)

    def run(self, *, max_steps: int = 10_000) -> List[Request]:
        """Serve everything submitted so far, by running the serving graph

            Source(requests) ∘ Farm(decode_step, feedback=still_generating)

        to loop quiescence on the threads lowering.  Request tasks flow
        from the Source through the farm's dispatch arbiter into the single
        decode worker (which owns params/cache); the worker admits them
        next tick.  A ``_TICK`` token circulates the wrap-around ring while
        anything is still generating; each pass runs one decode step over
        the whole continuous batch.  Results are emitted in tag order.  A
        run() cut short by ``max_steps`` or ``max_len`` leaves its batch
        active, and the next run() resumes it."""
        budget = [max_steps]
        # The graph and its vertices refer to each other, so the graph lives
        # until the garbage collector runs.  Its closures hold the engine
        # weakly: a finished engine, and the parameters it holds, go as soon
        # as the caller drops it.
        eng = weakref.proxy(self)

        def decode_step(task):
            if task is not _TICK:
                eng._pending.append(task)          # admitted on the next tick
                return ("enq",)
            eng._admit()
            if eng.active and eng.cache_len < eng.max_len and budget[0]:
                budget[0] -= 1
                eng.step()
            more = bool(eng.active or eng._pending or len(eng.in_q)) \
                and eng.cache_len < eng.max_len and budget[0] > 0
            return ("tick", more)

        tick_in_flight = [False]                   # touched only by the route

        def still_generating(result):
            if result[0] == "enq":
                if tick_in_flight[0]:
                    return None, []
                tick_in_flight[0] = True
                return None, [_TICK]
            _, more = result
            if more:
                tick_in_flight[0] = True   # seeded ticks arrive via Source
                return None, [_TICK]
            tick_in_flight[0] = False
            return None, []

        stream: List = self._drain_submitted()
        if self.active or self._pending:
            # a previous run() was truncated (budget / max_len): seed a
            # tick so the leftover batch resumes without new submissions
            stream.insert(0, _TICK)
        net = compose(Source(stream),
                      Farm(decode_step, feedback=still_generating,
                           scheduling=CostModel()))
        n_before = len(self.results)
        toks_before = sum(len(r.generated) for r in self.results)
        t0 = time.monotonic()
        prog = lower(net, "threads",
                     trace=self.tracer if self.tracer is not None else False)
        prog.to_graph().run_and_wait()
        wall = time.monotonic() - t0
        served = len(self.results) - n_before
        toks = sum(len(r.generated) for r in self.results) - toks_before
        reg = self.metrics
        reg.counter("serve.requests").inc(served)
        reg.counter("serve.tokens").inc(toks)
        reg.counter("serve.steps").inc(self.steps_run)
        if wall > 0:
            reg.gauge("serve.tokens_per_s").set(toks / wall)
        if self.slo is not None:
            # SLO pass before the final report, so last_report carries the
            # slo.alerts counter; each alert is an instant on the trace's
            # slo-monitor lane and a watch() firing of its own
            self.slo.check(self._latency,
                           goodput=(toks / wall) if wall > 0 else None)
        self.last_report = reg.finalize(reg.report(meta={
            "backend": "threads", "engine": "serve", "device": str(self.device),
            "requests": served, "tokens": toks, "wall_s": wall}))
        if self.tracer is not None:
            self.last_trace = self.tracer.trace()
        return self.results


def main():
    ap = argparse.ArgumentParser(description="Serve random requests with a "
                                 "smoke-sized model of the given arch.")
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args()
    cfg = ARCHS[args.arch].smoke()
    eng = ServeEngine(cfg, max_batch=4, max_len=256, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(3, 10))
        eng.submit(Request(rid=i, prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, plen)], max_new=args.max_new))
    results = eng.run()
    rep = eng.last_report
    lat = eng._latency
    print(f"[serve] {len(results)} requests, {rep.meta['tokens']} tokens, "
          f"{eng.steps_run} engine steps on {eng.device}, "
          f"{rep.gauges.get('serve.tokens_per_s', 0.0):.1f} tok/s; latency "
          f"p50={lat.p50 / 1e3:.1f}ms p99={lat.p99 / 1e3:.1f}ms")
    for r in results[:4]:
        print(f"  tag={r.tag} rid={r.rid} out={r.generated[:8]}")
    assert [r.tag for r in results] == sorted(r.tag for r in results), \
        "collector must emit in tag order"


if __name__ == "__main__":
    main()
