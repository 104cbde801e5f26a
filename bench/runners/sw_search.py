"""Protein database search (FastFlow, Sec. 4.2) as its users run it,
written against the port's public API.

Set-up draws the database from the seed (``gen.swissprot_db``), sorts it
longest first and packs it into chunks of ``chunk_subjects`` subjects,
each padded to its own longest subject (``sw_batch``'s input), on the
card, as a search node does once.  The window is one client in a closed
loop: each search builds the query's profile (``ops.build_profile``),
streams the chunks through ``core.TaskFarm(farm_workers,
preserve_order=True)`` with one ``sw_batch`` launch per chunk, scatters
the scores back to database order and copies them to the host; the next
query goes when the last score is in.  The window ends at the first
search boundary after ``seconds``.

``correct``: the scores of a sample of the window's searches (every
(length, regime) that ran, the rest drawn from the seed) at a sample of
subjects (the longest, the chunks' edges, the rest drawn from the seed),
in database order, against ``reference.sw`` on the same residues.  The
scores are integers in f32, so the comparison is exact.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, List

import numpy as np
import torch

from bench import gen
from bench.counts import work
from bench.harness import Check, Window
from bench.reference import sw as ref

SAMPLE_SUBJECTS = 384      # subjects compared per sampled search
LONGEST = 64               # of which the longest in the database
SAMPLE_SEARCHES = 48       # searches compared at most
# integer scores in f32: exact (PERF.md, "What decides correct")
LIMITS = {"score_gap": 0.0}


def _pack(flat: torch.Tensor, offs: np.ndarray, lens: np.ndarray, pad: int):
    """``sw_batch``'s (subjects (B, Dp) int32 padded with ``pad``, lengths
    (B,) int32) of the subjects at ``offs``, on ``flat``'s device."""
    dev = flat.device
    o = torch.as_tensor(offs, device=dev)
    n = torch.as_tensor(lens, device=dev)
    col = torch.arange(int(lens.max()), device=dev)[None, :]
    subj = torch.where(col < n[:, None],
                       flat[(o[:, None] + col).clamp(max=flat.numel() - 1)], pad)
    return subj.to(torch.int32).contiguous(), n.to(torch.int32)


def _score_chunk(sw, prof, q_len, go, ge, chunk):
    return sw.sw_batch(prof, chunk[0], chunk[1], gap_open=go, gap_extend=ge,
                       q_len=q_len)


def _search(core, ops, sw, st, query: torch.Tensor, go: float, ge: float):
    """One search: every subject's score, in database order, on the host."""
    prof, q_len = ops.build_profile(query, st["blosum"])
    farm = core.TaskFarm(st["workers"], preserve_order=True)
    farm.add_stream(st["chunks"])
    farm.add_worker(core.FnNode(functools.partial(_score_chunk, sw, prof,
                                                  q_len, go, ge)))
    flat = torch.cat(farm.run_and_wait())
    scores = torch.empty(st["n"], dtype=torch.float32, device=flat.device)
    scores[st["order_dev"]] = flat
    return scores.cpu()


def _inputs(env) -> Dict[str, Any]:
    """The database, its order, the query schedule and the subjects the
    check compares, all from the seed."""
    cfg, dev = env.config, env.device
    flat, lens = gen.swissprot_db(cfg["database"], env.seed, dev)
    n, C = lens.shape[0], cfg["chunk_subjects"]
    order = np.argsort(-lens, kind="stable")
    # the subjects the check compares: the longest, each chunk's first
    # and last, the rest drawn from the seed
    edges = list(order[:LONGEST]) + [order[c] for c in range(0, n, C)] \
        + [order[min(c + C, n) - 1] for c in range(0, n, C)]
    g = torch.Generator().manual_seed(gen.seed64(env.seed) ^ 0x5EED)
    return dict(flat=flat, lens=lens, n=n, order=order,
                offs=np.concatenate([[0], np.cumsum(lens)[:-1]]),
                residues=int(lens.sum()),
                sched=gen.QuerySchedule(env.traffic, env.seed),
                sample=ref.pick(n, [int(e) for e in edges], SAMPLE_SUBJECTS, g))


def setup(env) -> Dict[str, Any]:
    from repro_torch import core
    from repro_torch.kernels import ops, smith_waterman as sw
    cfg, dev = env.config, env.device
    st = _inputs(env)
    flat, lens, offs, order, n = st["flat"], st["lens"], st["offs"], st["order"], st["n"]
    A = ops.BLOSUM50.shape[0]
    C = cfg["chunk_subjects"]
    chunks = [_pack(flat, offs[order[c:c + C]], lens[order[c:c + C]], A)
              for c in range(0, n, C)]
    st.update(core=core, ops=ops, sw=sw, chunks=chunks,
              workers=cfg["farm_workers"], blosum=ops.BLOSUM50.to(dev),
              order_dev=torch.as_tensor(order, device=dev))
    # warm up: every query length of the mix on the smallest chunk, then
    # one whole search through the farm
    rng = np.random.default_rng([gen.seed64(env.seed), 3])
    for q in st["sched"].lengths():
        query = torch.as_tensor(rng.integers(0, gen.RESIDUES, q, dtype=np.int32),
                                device=dev)
        prof, q_len = ops.build_profile(query, st["blosum"])
        _score_chunk(sw, prof, q_len, 10.0, 2.0, chunks[-1])
    _search(core, ops, sw, st, query, 10.0, 2.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    env.log(f"sw_search: {n} subjects, {st['residues']} residues, "
            f"{len(chunks)} chunks of {C}, packed {sum(c[0].numel() for c in chunks) * 4 / 1e9:.3f} GB")
    return st


def window(st: Dict[str, Any], env) -> Window:
    core, ops, sw = st["core"], st["ops"], st["sw"]
    sample = st["sample"]
    lat: List[float] = []
    kept: List[torch.Tensor] = []
    ran: List[tuple] = []
    cells = 0
    env.tracer.start()
    launches0 = sw.launch_count()
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < env.seconds:
        t0 = time.perf_counter()
        q, go, ge, res = st["sched"](len(ran))
        query = torch.from_numpy(res).to(env.device)
        scores = _search(core, ops, sw, st, query, go, ge)
        lat.append(time.perf_counter() - t0)
        kept.append(scores[sample])
        ran.append((q, go, ge))
        cells += q * st["residues"]
    t_end = time.perf_counter()
    launches = sw.launch_count() - launches0
    env.tracer.stop()
    st.update(kept=kept, ran=ran)
    lat_ms = np.asarray(lat) * 1e3
    env.log(f"sw_search: {len(ran)} searches in {t_end - t_start:.3f} s; "
            f"latency ms median {np.median(lat_ms):.3f}, p95 "
            f"{np.percentile(lat_ms, 95):.3f} of {len(lat_ms)} samples; "
            f"{launches} launches")
    return Window(t_start=t_start, t_end=t_end, attempted=len(ran), failed=0,
                  end_to_end={"gcups": work.gcups(cells, t_end - t_start),
                              "search_p95_ms": float(np.percentile(lat_ms, 95))},
                  counters={"sw_cells": cells, "sw_launches": launches})


def _sampled_searches(ran: List[tuple], seed: int) -> List[int]:
    """Every (length, regime) that ran once, the rest drawn from the seed,
    at most SAMPLE_SEARCHES."""
    first: Dict[tuple, int] = {}
    for k, combo in enumerate(ran):
        first.setdefault(combo, k)
    g = torch.Generator().manual_seed(gen.seed64(seed) ^ 0xC0DE)
    return ref.pick(len(ran), sorted(first.values()), SAMPLE_SEARCHES, g).tolist()


def _reference(st, env, picked: List[int], dtype) -> torch.Tensor:
    sample = st["sample"].to(env.device)
    offs = torch.as_tensor(st["offs"], device=env.device)[sample]
    lens = torch.as_tensor(st["lens"], device=env.device)[sample]
    subjects = ref.gather_subjects(st["flat"], offs, lens, pad=0)
    queries, gaps = [], []
    for k in picked:
        q, go, ge, res = st["sched"](k)
        queries.append(torch.from_numpy(res))
        gaps.append((go, ge))
    return ref.sw_scores(queries, gaps, subjects, lens, dtype=dtype).float().cpu()


def check(st: Dict[str, Any], win: Window, env) -> List[Check]:
    st.pop("chunks")
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    picked = _sampled_searches(st["ran"], env.seed)
    got = torch.stack([st["kept"][k] for k in picked])
    t0 = time.perf_counter()
    want = _reference(st, env, picked, torch.float32)
    env.log(f"sw_search check: {len(picked)} searches x {got.shape[1]} subjects "
            f"against the reference in {time.perf_counter() - t0:.1f} s")
    return [Check("score_gap", ref.worst_gap(got, want), LIMITS["score_gap"])]


def control(env) -> Dict[str, Dict[str, float]]:
    """The control: the reference computed in bfloat16 put in the
    program's place, judged as a run is judged, over as many searches of
    the schedule as a run compares."""
    st = _inputs(env)
    ran = [st["sched"](k)[:3] for k in range(2 * SAMPLE_SEARCHES)]
    picked = _sampled_searches(ran, env.seed)
    got = _reference(st, env, picked, torch.bfloat16)
    want = _reference(st, env, picked, torch.float32)
    return {"control_bf16": {"score_gap": ref.worst_gap(got, want)}}
