#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Several paths, each through the entry points a user calls, each with the
kernel launch counts set to 0 just before it and read just after:

* the paper's application (Sec. 4.2): Smith-Waterman protein database
  search through an order-preserving farm, two ways: workers that score
  one (query, subject) pair per task (the paper's farm), and workers that
  score a length-sorted chunk of thousands of subjects per task, one
  launch of the hand-written CUDA kernel per chunk, over a database of a
  Swiss-Prot release's size;
* Zamba2-2.7B at full width (54 layers, bf16, random weights from a seed):
  ``prefill`` of 2 x 4096 tokens, which runs the flash-attention kernel in
  its 9 shared-attention blocks and the SSD scan (five CUDA kernels per
  call, counted as one launch) in its 45 Mamba2 blocks, then the
  ``ServeEngine`` serving 8 requests through ``decode_step`` (plain
  PyTorch, as in the reference);
* the moe, vlm and audio families at full width, depth cut to fit the
  card in bf16: Mixtral-8x7B (16 of 32 layers; prefill of 2 x 8192, two
  of its 4096-token windows, then 8 served requests), Llama-3.2-Vision-90B
  (25 of 100 layers; prefill of 2048 tokens cross-attending 1601 vision
  rows, then 16 decode steps) and MusicGen-medium (all 48 layers; prefill
  of 2 x 1500 frames, then 16 decode steps), every attention block of each
  prefill through the flash-attention kernel;
* training: Phi-3-mini-3.8B at full width (all 32 layers, bf16 parameters,
  f32 moments) through ``launch.train.train``, every attention block
  through the flash-attention kernel forward and its hand-written backward
  kernel; then Zamba2-2.7B at full width (all 54 layers), every Mamba2
  block through the SSD kernels and their hand-written backward kernels;
* keyed aggregation on the host runtime's two backends, threads and
  procs (spawned vertex processes over shared-memory rings): the chunked
  search's scores, one (2, 4096) int32 tensor per chunk on the card,
  reduced per length bucket by ``reduce_by_key`` (max and count); then
  the reference's largest out-of-core tier (a million rows, a million
  cold keys) through ``shard_reduce`` under a 1 MiB budget per partition;
* the self-tuning compile and the live monitor around the chunked search,
  a service level on the serving run, and the device backend
  (``lower(.., "mesh")``, one program per skeleton on the card) over the
  search's rows and subjects.

Phases, each on lines of its own; any failed check exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the five CUDA sources in ``src/repro_torch/kernels/csrc``, one
     nvcc each, all started together;
  3. SW kernel == plain PyTorch version on the card, exactly, on many shapes;
  4. the SW main path: a 4096-subject database through ``TaskFarm`` and
     through ``Pipeline(Farm, Stage)``, one subject per task; then the
     chunked search, which must reproduce those scores, over 2^19 subjects
     in chunks of 4096 (and 1024, 16384); launch counts of each path,
     order, scores, GCUPS and the card's busy share;
  5. SW kernel, plain-version and bound times at both paths' shapes (one
     subject; a chunk of 4096 subjects);
  6. FA and SSD kernels against their plain versions on many shapes (the
     bf16 FA kernel, wgmma with TMA loads, also on its edges: every head
     dim, ragged S and T, q_offset, S > T, GQA/MQA, windows, strided views;
     the SSD scan on its edges: one chunk, chunks of 8 to 1024, ragged
     row tiles, P = 16 with N = 128, P = 5 with N = 7, 64 chunks in the
     inter-chunk pass);
  7. the Zamba2 main path: prefill (9 FA + 45 SSD launches each), the
     f32 prefill-against-decode consistency check, serving;
  8. FA and SSD kernel, plain, bound and library times at the main path's
     shapes (FA also at every shape of phase 9's prefills), the FA
     kernel's TFLOP/s and share of its bound, and the SSD scan's time
     split by its five passes (torch.profiler);
  9. the moe, vlm and audio families: per model, prefill (FA launches
     16, 25 and 48; SSD and SW none), tokens/s, the prefill's device time
     by part (expert GEMMs, MoE dispatch, FA, the rest), serving (Mixtral)
     or decode steps after the prefill, and the f32 prefill-against-decode
     consistency check at a cut depth (Mixtral 2 layers over 4608 tokens,
     past its window; Llama-Vision one period of 5 layers; MusicGen all 48);
  10. training: the flash-attention backward kernel (three CUDA kernels
      per call, counted as one launch; bf16 on wgmma with TMA loads,
      reading the softmax statistics the forward saved) against its plain
      version on its edges and at Phi-3's shape, the forward's statistics
      against theirs, with kernel, plain, bound and library (SDPA's
      backward) times and the split by kernel; Phi-3-mini-3.8B trained at
      full width (all 32 layers, bf16 parameters, f32 moments, remat) through
      ``launch.train.train``, 5 steps of 2 x 4096 tokens: per-step ms,
      tokens/s, share of the FLOP bound, FA launches (64 forward with the
      remat recompute, 32 backward a step), the device time by part and
      the peak memory; at 2 layers the f32 gradients through the kernels
      against naive attention (bf16 must miss the limit) and a restart
      from a checkpoint after an injected failure, equal to an
      uninterrupted run; then the SSD backward (eight CUDA kernels per
      call, counted as one launch) against its plain version on phase 6's
      SSD cases, with kernel, per-kernel, plain and bound times at
      Zamba2's shape; Zamba2-2.7B trained at full width through
      ``launch.train.train`` as Phi-3 is (SSD launches 90 forward with
      the remat recompute and 45 backward a step, FA 18 and 9), and at 6
      layers its f32 gradients through the kernels against ssd_plain and
      naive attention (bf16 must miss the limit);
  11. keyed aggregation: the chunked search once more (q=1000, 10-2k,
      2^19 subjects, 128 launches), its (length bucket, score) chunks
      through ``reduce_by_key(bucket, "max")`` and ``"count"`` on threads
      and on procs (``ProcAccelerator``: 2 left and 2 right vertices; the
      shared-memory ring moves each CUDA chunk to the host), each equal
      to ``scatter_reduce``/``bincount`` on the card; then the
      out-of-core tier through ``shard_reduce`` on procs and on threads,
      each in a fresh interpreter, equal to a plain dict fold, with
      spills; wall, rows/s, spills, stalls, peak RSS and the host's CPU
      count; no vertex host or ``/dev/shm`` segment left;
  12. the self-tuning compile, the live monitor and the device backend:
      (a) the chunked search of phase 4 through ``lower(Farm(score_chunk,
      2), "threads", tune=True, tune_pilot=16, monitor=, metrics=True)``,
      called twice, equal to phase 4's scores bit for bit, with the
      profile, the retuned IR, ``analyze`` of the timeline and the run
      report; a monitored keyed max of phase 11's rows on procs; (b) phase
      7's serving carries ``slo=SLOMonitor(...)`` (its alerts print
      there); (c) ``lower(.., "mesh")`` on the card: Farm∘Farm at 2000
      items and 2^20 and a Feedback loop equal to threads, ``reduce_by_key``
      (max, count) of phase 11's 524,288 rows equal to
      ``scatter_reduce``/``bincount``, a device farm of SW scores over
      phase 4's 4096 subjects equal to its scores, and the tuned mesh plan;
  13. a ``kernels`` JSON line; the last line is the ``ok`` JSON.

Run from the root of a checkout:  python3 chip_smoke.py
"""
import contextlib
import gc
import json
import os
import re
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TIME_LIMIT_S = 1100           # the whole run, build included
DB_SIZE = 4096                # subjects of the one-subject farm's database
BIG_DB_SIZE = 1 << 19         # subjects of the chunked search: a Swiss-Prot release's scale
BIG_DB_SEED = 19              # its own seed
CHUNK = 4096                  # subjects per launch in the chunked search
CHUNK_SWEEP = [1024, 16384]   # more chunk sizes at q=1000 in the 10-2k regime
SMALL_CHUNK = 512             # chunked search of the 4096-subject database
MEAN_LEN = 352                # Swiss-Prot 57.5 mean sequence length
QUERY_LENS = [144, 497, 1000]  # P02232, P10635, P27895
REGIMES = [(10.0, "10-2k"), (5.0, "5-2k")]
GAP_EXTEND = 2.0
SAMPLE = 256                  # subjects checked against the plain version
TIMING_CHUNK = 4096           # subjects per launch in the chunk-shape timing rows
OPS_PER_CELL = 15             # f32 ops per (query lane, subject char), from the .cu
PEAK_F32 = 67e12              # H100 SXM f32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s
SOURCE = "src/repro_torch/kernels/csrc/smith_waterman.cu"
REPLACES = "src/repro/kernels/smith_waterman.py:52"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:30"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:36"
PEAK_BF16 = 989e12            # H100 SXM dense bf16 tensor-core rate, FLOP/s
MAIN_ARCH = "zamba2-2.7b"     # exactly as in src/repro_torch/configs
PREFILL_B, PREFILL_S = 2, 4096  # Zamba2's context; a multiple of chunk 256
CONSIST_S = 512               # the f32 prefill-against-decode prompt
# f32 prefill (kernels) against f32 decode (no kernel): max |logit diff|,
# logits up to ~4.3.  At full width the plain versions' f32 prefill ends
# ~4e-3 from the decode (printed below): the chunked SSD takes
# exp(cs_i - cs_j) of two cumulative log-decays that reach -1e3 and beyond,
# where an f32 sum keeps ~1e-4 of the difference, and 54 random layers
# carry it on.  The SSD kernels sum cs in float64, and their prefill ends
# closer (~7e-4).  A bf16 model moves the logits by ~2.5, so it fails the
# tolerance by 50x (checked below).
CONSIST_TOL = 5e-2
SERVE_REQS, SERVE_BATCH, SERVE_LEN, SERVE_NEW = 8, 4, 256, 16
# kernel against plain on the card: FA 2e-5 f32 / 2e-2 bf16 (the
# reference's, tests/test_kernels.py:93; softmax sums in another order);
# SSD 1e-4 with f32 products (tests/test_kernels.py:146; chunk sums of up
# to 256 terms in another order), 5e-2 with bf16 products (the reference's
# bf16 tolerance: a sum in another order can round an operand to its
# bf16 neighbour).  |kernel - plain| <= tol + tol * |plain| elementwise.
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# With f32 products, an SSD chunk longer than this is held against the
# plain version evaluated in float64 (compute_dtype=torch.float64): there
# the f32 plain version's cumulative log-decays, which reach -1e3, drift by
# about the tolerance themselves (tests/test_torch_ssm.py, the f64 witness).
SSD_WITNESS_CHUNK = 256
# The SSD kernels' cases (phase 6 forward, phase 10 backward):
SSD_CASES = [  # b, T, H, P, N, chunk, with h0
    (2, 64, 80, 64, 64, 8, False),
    (1, 256, 80, 64, 64, 64, True),
    (2, 512, 80, 64, 64, 256, True),
    (1, 512, 24, 64, 128, 256, False),
    (2, 96, 24, 64, 128, 32, True),
    (1, 48, 24, 64, 128, 16, False),
    (1, 128, 3, 16, 16, 128, True),
    # the five-pass kernel's edges: one chunk with P = 16, N = 128, H = 3;
    # ragged 64-row tiles (96), an odd chunk under one tile (15, scalar
    # staging), chunks of 1024, 64 chunks in the inter-chunk pass, and
    # P = 5, N = 7 (scalar staging of x, B, C and the state)
    (1, 256, 3, 16, 128, 256, False),
    (2, 192, 24, 64, 64, 96, True),
    (1, 45, 3, 8, 16, 15, True),
    (1, 1024, 8, 64, 64, 1024, True),
    (2, 2048, 24, 64, 128, 1024, False),
    (1, 4096, 8, 64, 64, 64, True),
    (1, 140, 3, 5, 7, 70, True),
    # the backward's ragged head groups and H·P slices (16 heads each):
    # H = 7, H·P = 280, P = 40
    (1, 256, 7, 40, 64, 128, True),
]
# The bf16 FA kernel's edges (B, H, Hkv, S, T, D, window, q_offset, causal):
# every head dim; S and T of 1, 63, 65, 257 and below its 128-row kv tile;
# S < T with q_offset = T - S; S > T; GQA and MQA; windows 1, 64 and 128.
FA_BF16_EDGES = [
    *[(1, 2, 1, 129, 200, d, None, 0, True) for d in (16, 32, 48, 64, 80,
                                                      96, 112, 128)],
    (2, 4, 2, 1, 1, 80, None, 0, True),
    (1, 4, 4, 63, 63, 80, None, 0, True),
    (1, 4, 4, 65, 65, 48, None, 0, True),
    (1, 4, 4, 257, 257, 80, None, 0, True),
    (1, 4, 2, 63, 65, 64, None, 2, True),
    (1, 4, 2, 65, 257, 80, None, 192, True),
    (1, 32, 8, 257, 4096, 80, None, 3839, True),
    (1, 4, 4, 257, 63, 80, None, 0, True),
    (1, 4, 4, 300, 77, 128, None, 0, True),
    (2, 8, 1, 200, 200, 80, None, 0, True),
    (1, 8, 2, 300, 300, 80, 1, 0, True),
    (1, 8, 2, 300, 300, 80, 64, 0, True),
    (1, 4, 4, 500, 500, 128, 128, 0, True),
    (1, 4, 1, 33, 1000, 64, 64, 967, True),
    (1, 2, 2, 100, 300, 80, None, 0, False),
]
FA_SIMT_MS = 7.8476           # the replaced SIMT bf16 kernel at the main shape (PERF.md §6)
# The bf16 FA kernel's timing rows (phase 8): every shape a prefill of
# phase 7 or 9 gives it (path, B, H, Hkv, S, T, D, causal, window).
MAIN_FA_PATH = "zamba2 prefill"
FA_SHAPES = [
    (MAIN_FA_PATH, PREFILL_B, 32, 32, PREFILL_S, PREFILL_S, 80, True, None),
    ("mixtral prefill", 2, 32, 8, 8192, 8192, 128, True, 4096),
    ("llama-vision self", 1, 64, 8, 2048, 2048, 128, True, None),
    ("llama-vision cross", 1, 64, 8, 2048, 1601, 128, False, None),
    ("musicgen prefill", 2, 32, 32, 1500, 1500, 64, True, None),
]
SSD_SERIAL_MS = 4.9933        # the replaced SSD kernel (chunks in order per (batch, head)) there
SSD_FWD_MS = 1.0636           # the SSD forward there before the backward's redesign (PERF.md §6)
SSD_KERNEL = re.compile(r"ssd_\w*kernel")   # the five passes' kernel names


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def gcups(qlen, db_cells, seconds):
    return qlen * db_cells / (seconds * 1e9)


def _watchdog(signum, frame):
    print(f"FAIL: chip_smoke exceeded {TIME_LIMIT_S} s", flush=True)
    procgraph = sys.modules.get("repro_torch.core.procgraph")
    if procgraph is not None:     # os._exit skips the pool's atexit hook
        procgraph.pool_shutdown()
    os._exit(1)


def make_db(rng, n):
    """Subjects drawn to Swiss-Prot 57.5's statistics, as the reference
    benchmark draws them: gamma(2, 176) lengths clipped to [2, 2000],
    residues 0-19."""
    lens = np.clip(rng.gamma(2.0, MEAN_LEN / 2.0, n).astype(int), 2, 2000)
    return [rng.integers(0, 20, int(n_)).astype(np.int32) for n_ in lens]


def make_big_db(n, seed):
    """``make_db``'s statistics at ``n`` subjects, drawn in bulk: (residues
    as one int32 array, lengths, start offsets)."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.gamma(2.0, MEAN_LEN / 2.0, n).astype(np.int64), 2, 2000)
    flat = rng.integers(0, 20, int(lens.sum()), dtype=np.int32)
    return flat, lens, np.concatenate([[0], np.cumsum(lens)[:-1]])


def pack_chunks(sw, subject_of, order, chunk, A, dev):
    """Subjects in ``order`` (longest first) packed into chunks of
    ``chunk``, each padded to its own longest subject, on the card."""
    return [sw.pack_subjects([subject_of(i) for i in order[c:c + chunk]], A, dev)
            for c in range(0, len(order), chunk)]


def chunked_search(core, sw, prof, q_len, go, chunks, order_dev, n):
    """The chunked search through the order-preserving farm: one
    ``sw_batch`` launch per chunk, scores scattered back to database order
    and brought to the host.  Returns (scores, wall seconds)."""
    farm = core.TaskFarm(2, preserve_order=True)
    farm.add_stream(chunks)
    farm.add_worker(core.FnNode(lambda ch: sw.sw_batch(
        prof, ch[0], ch[1], gap_open=go, gap_extend=GAP_EXTEND, q_len=q_len)))
    t0 = time.perf_counter()
    flat = torch.cat(farm.run_and_wait())
    scores = torch.empty(n, dtype=torch.float32, device=flat.device)
    scores[order_dev] = flat
    scores = scores.cpu()
    return scores, time.perf_counter() - t0


def cuda_ms(fn, iters, warmup):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_exact(dev, sw, ops, ref):
    """Kernel == plain on the card, exact, over query x subject x regime."""
    A = ops.BLOSUM50.shape[0]
    rng = np.random.default_rng(11)
    dlens = [1, 2, 17, 352, 511, 512, 513, 2000]
    cases, worst = 0, 0.0
    for qlen in [1, 24, 128, 129, 144, 497, 1000, 1024, 4000]:
        query = torch.as_tensor(rng.integers(0, 20, qlen).astype(np.int32),
                                device=dev)
        prof, q_len = ops.build_profile(query, ops.BLOSUM50.to(dev))
        subjects = [rng.integers(0, 20, n).astype(np.int32) for n in dlens]
        gappy = rng.integers(0, 20, 700).astype(np.int32)
        hole = rng.random(700) < 0.2
        gappy[hole] = rng.integers(A, A + 9, int(hole.sum()))  # chars >= A
        subjects += [gappy, np.full(40, A, np.int32)]          # + all padding
        subj, lens = sw.pack_subjects(subjects, A, dev)
        for go, ge in [(10.0, 2.0), (5.0, 2.0), (10.3, 2.1)]:
            got = sw.sw_batch(prof, subj, lens, gap_open=go, gap_extend=ge,
                              q_len=q_len)
            live = torch.arange(subj.shape[1], device=dev) < lens[:, None]
            want = sw.sw_plain(prof, torch.where(live, subj, A), go, ge, q_len)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            check(torch.equal(got, want),
                  f"kernel != plain at q={qlen} gaps={go}-{ge}: "
                  f"{got.tolist()} vs {want.tolist()}")
            # one subject alone, through the padded entry point (B = 1)
            one = ops.smith_waterman(query, torch.as_tensor(subjects[3],
                                                            device=dev),
                                     gap_open=go, gap_extend=ge)
            check(float(one) == float(want[3]),
                  f"smith_waterman != plain at q={qlen} gaps={go}-{ge}")
            cases += len(subjects) + 1
        print(f"exact q={qlen:5d} Qp={prof.shape[1]:5d}: "
              f"{len(subjects)} subjects x 3 regimes equal", flush=True)
    qs, ds = "HEAGAWGHEE", "PAWHEAE"
    m = ops.BLOSUM50.numpy()
    want = ref.sw_numpy(qs, ds, lambda a, b: float(
        m[ops.AA_ALPHABET.index(a), ops.AA_ALPHABET.index(b)]), 10.0, 2.0)
    got = float(ops.smith_waterman(ops.encode_seq(qs, dev),
                                   ops.encode_seq(ds, dev)))
    check(got == want, f"tiny case: kernel {got} != sw_numpy {want}")
    print(f"exact tiny case vs sw_numpy: {got} == {want}", flush=True)
    return cases + 1, worst


def phase_main_path(dev, sw, ops, core):
    """The search through the farm, as a user drives it."""
    rng = np.random.default_rng(0)
    db = make_db(rng, DB_SIZE)
    lens = [int(s.shape[0]) for s in db]
    db_cells = sum(lens)
    flat = torch.from_numpy(np.concatenate(db)).to(dev)      # one upload
    db_dev = list(flat.split(lens))
    torch.cuda.synchronize()
    print(f"main path, one subject per task: {DB_SIZE} subjects, {db_cells} "
          f"residues (one task costs ~1 ms of host work, so this path keeps "
          f"a cut of the database; the chunked search below runs "
          f"{BIG_DB_SIZE})", flush=True)
    queries = {q: torch.as_tensor(rng.integers(0, 20, q).astype(np.int32),
                                  device=dev) for q in QUERY_LENS}
    runs = {}
    reset_counts()                                # --- counted window ---
    for qlen, query in queries.items():
        for go, tag in REGIMES:
            times = []

            def align(s, query=query, go=go, times=times):
                t0 = time.perf_counter()
                v = float(ops.smith_waterman(query, s, gap_open=go,
                                             gap_extend=GAP_EXTEND))
                times.append(time.perf_counter() - t0)
                return v

            before = sw.launch_count()
            farm = core.TaskFarm(2, preserve_order=True)
            farm.add_stream(db_dev)
            farm.add_worker(core.FnNode(align))
            t0 = time.perf_counter()
            scores = farm.run_and_wait()
            wall = time.perf_counter() - t0
            runs[(qlen, tag)] = dict(scores=scores, wall=wall, times=times,
                                     launches=sw.launch_count() - before)
    q0, (go0, tag0) = QUERY_LENS[0], REGIMES[0]
    before = sw.launch_count()
    net = core.Pipeline(
        core.Farm(lambda s: float(ops.smith_waterman(
            queries[q0], s, gap_open=go0, gap_extend=GAP_EXTEND)),
            2, ordered=True),
        core.Stage(lambda s: round(s, 1)))
    t0 = time.perf_counter()
    piped = net.run_and_wait(db_dev)
    pipe_wall = time.perf_counter() - t0
    pipe_launches = sw.launch_count() - before
    total_launches = sw.launch_count()            # --- end of window ---

    A = ops.BLOSUM50.shape[0]
    subj_all, lens_all = sw.pack_subjects(db, A, dev)
    pick = np.sort(rng.choice(DB_SIZE, SAMPLE, replace=False))
    for (qlen, tag), r in runs.items():
        go = dict((t, g) for g, t in REGIMES)[tag]
        check(r["launches"] == DB_SIZE,
              f"q={qlen} {tag}: {r['launches']} launches for {DB_SIZE} tasks")
        scores = r["scores"]
        check(len(scores) == DB_SIZE and all(np.isfinite(scores))
              and min(scores) >= 0, f"q={qlen} {tag}: bad score list")
        prof, q_len = ops.build_profile(queries[qlen], ops.BLOSUM50.to(dev))
        # order: the farm's list equals one batched launch over the database
        batched = sw.sw_batch(prof, subj_all, lens_all, gap_open=go,
                              gap_extend=GAP_EXTEND, q_len=q_len)
        check(batched.tolist() == scores,
              f"q={qlen} {tag}: farm output order/scores differ from the "
              f"batched launch")
        sub = subj_all[torch.as_tensor(pick, device=dev)]
        live = torch.arange(sub.shape[1], device=dev) < \
            lens_all[torch.as_tensor(pick, device=dev)][:, None]
        want = sw.sw_plain(prof, torch.where(live, sub, A), go, GAP_EXTEND,
                           q_len)
        check(want.tolist() == [scores[i] for i in pick],
              f"q={qlen} {tag}: farm scores differ from sw_plain on the sample")
        t_us = np.asarray(r["times"]) * 1e6
        print(f"search q={qlen} {tag}: GCUPS={gcups(qlen, db_cells, r['wall']):.6f}"
              f" wall={r['wall']:.3f}s tasks={DB_SIZE} launches={r['launches']}"
              f" task_us min/avg/max={t_us.min():.1f}/{t_us.mean():.1f}/"
              f"{t_us.max():.1f} best={max(scores):.0f}", flush=True)
    check(pipe_launches == DB_SIZE,
          f"pipeline: {pipe_launches} launches for {DB_SIZE} tasks")
    check(piped == [round(s, 1) for s in runs[(q0, tag0)]["scores"]],
          "pipeline output differs from the farm's")
    print(f"pipeline Farm(align,2,ordered)->Stage(round) q={q0} {tag0}: "
          f"GCUPS={gcups(q0, db_cells, pipe_wall):.6f} wall={pipe_wall:.3f}s "
          f"launches={pipe_launches}", flush=True)
    expected = (len(runs) + 1) * DB_SIZE
    check(total_launches == expected,
          f"main path launched the kernel {total_launches} times, "
          f"expected {expected}")
    print(f"main path: {total_launches} kernel launches for {expected} tasks; "
          f"order and {SAMPLE}-subject sample equal sw_plain", flush=True)

    # The device time of the path's launches, issued back to back from one
    # thread on the tile-padded subjects (no host work between them), over
    # the farm's wall time: the share of the search the card was busy.
    tile = 512
    padded = [torch.nn.functional.pad(s, (0, -(-len(s) // tile) * tile - len(s)),
                                      value=A)[None] for s in db_dev]
    for qlen in QUERY_LENS:
        prof, q_len = ops.build_profile(queries[qlen], ops.BLOSUM50.to(dev))
        busy_ms = cuda_ms(lambda: [sw.sw_batch(
            prof, s, gap_open=go0, gap_extend=GAP_EXTEND, q_len=q_len)
            for s in padded], iters=1, warmup=0)
        wall = runs[(qlen, tag0)]["wall"]
        print(f"device busy share q={qlen} {tag0}: {busy_ms / 1e3 / wall:.4f} "
              f"(kernels {busy_ms / 1e3:.4f} s back to back, farm wall "
              f"{wall:.4f} s, {busy_ms / DB_SIZE * 1e3:.1f} us/launch)",
              flush=True)
        # the same tasks in a plain loop on one thread: the farm's own cost
        t0 = time.perf_counter()
        seq = [float(ops.smith_waterman(queries[qlen], s, gap_open=go0,
                                        gap_extend=GAP_EXTEND)) for s in db_dev]
        seq_wall = time.perf_counter() - t0
        check(seq == runs[(qlen, tag0)]["scores"],
              f"q={qlen}: plain loop differs from the farm")
        # ... and without the per-task float(): the host's enqueue cost
        t0 = time.perf_counter()
        outs = [ops.smith_waterman(queries[qlen], s, gap_open=go0,
                                   gap_extend=GAP_EXTEND) for s in db_dev]
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        drained = time.perf_counter() - t0
        check(torch.stack(outs).tolist() == seq,
              f"q={qlen}: unsynchronised loop differs")
        print(f"plain loop q={qlen} {tag0}: wall={seq_wall:.4f}s "
              f"({seq_wall / DB_SIZE * 1e6:.1f} us/task) vs farm "
              f"{wall / DB_SIZE * 1e6:.1f} us/task; without float(): host "
              f"enqueue {enq / DB_SIZE * 1e6:.1f} us/task, drained "
              f"{drained:.4f}s", flush=True)
    return total_launches, runs, db, queries


def phase_chunked(dev, sw, ops, core, runs, db, queries):
    """The chunked search: the database sorted by length, longest first,
    cut into chunks of subjects, one ``sw_batch`` launch per chunk through
    ``TaskFarm(2, preserve_order=True)``, scores back in database order.
    First on the one-subject farm's database (which it must reproduce),
    then on a database of ``BIG_DB_SIZE`` subjects."""
    t_phase = time.perf_counter()
    A = ops.BLOSUM50.shape[0]
    gaps = dict((t, g) for g, t in REGIMES)
    small_order = sorted(range(len(db)), key=lambda i: -len(db[i]))
    small = pack_chunks(sw, lambda i: db[i], small_order, SMALL_CHUNK, A, dev)
    small_dev = torch.as_tensor(small_order, device=dev)
    flat, lens, offs = make_big_db(BIG_DB_SIZE, BIG_DB_SEED)
    cells = int(lens.sum())
    order = np.argsort(-lens, kind="stable")
    big = {c: pack_chunks(sw, lambda i: flat[offs[i]:offs[i] + lens[i]], order,
                          c, A, dev) for c in [CHUNK] + CHUNK_SWEEP}
    order_dev = torch.as_tensor(order, device=dev)
    profs = {q: ops.build_profile(qt, ops.BLOSUM50.to(dev))
             for q, qt in queries.items()}
    torch.cuda.synchronize()
    setup = time.perf_counter() - t_phase
    print(f"chunked search: {BIG_DB_SIZE} subjects, {cells} residues "
          f"(seed {BIG_DB_SEED}, Swiss-Prot 57.5 statistics), sorted longest "
          f"first, chunks of {CHUNK} (and {CHUNK_SWEEP} at q={max(QUERY_LENS)} "
          f"{REGIMES[0][1]}), each padded to its own longest subject "
          f"({sum(c[0].numel() for c in big[CHUNK]) * 4 / 1e9:.3f} GB at "
          f"{CHUNK}); set-up {setup:.1f} s", flush=True)
    grid = [(q, tag, CHUNK) for q in QUERY_LENS for _, tag in REGIMES]
    grid += [(max(QUERY_LENS), REGIMES[0][1], c) for c in CHUNK_SWEEP]
    results = {}
    reset_counts()                                # --- counted window ---
    for qlen in QUERY_LENS:
        for go, tag in REGIMES:
            prof, q_len = profs[qlen]
            got, _ = chunked_search(core, sw, prof, q_len, go, small,
                                    small_dev, len(db))
            check(got.tolist() == runs[(qlen, tag)]["scores"],
                  f"q={qlen} {tag}: the chunked search (chunks of "
                  f"{SMALL_CHUNK}) differs from the one-subject farm")
    for qlen, tag, c in grid:
        prof, q_len = profs[qlen]
        before = sw.launch_count()
        scores, wall = chunked_search(core, sw, prof, q_len, gaps[tag], big[c],
                                      order_dev, BIG_DB_SIZE)
        results[(qlen, tag, c)] = dict(scores=scores, wall=wall,
                                       launches=sw.launch_count() - before)
    counts = read_counts()                        # --- end of window ---
    n_small = len(runs) * len(small)
    expected = n_small + sum(len(big[c]) for _, _, c in grid)
    check(counts == {"sw": expected, "fa": 0, "ssd": 0},
          f"chunked path launched {counts}, expected sw {expected}")
    print(f"chunked search of the {len(db)}-subject database in chunks of "
          f"{SMALL_CHUNK}: equal to the one-subject farm's scores in all "
          f"{len(runs)} runs ({n_small} launches)", flush=True)

    rng = np.random.default_rng(BIG_DB_SEED + 1)
    n_chunks = len(big[CHUNK])
    ends = [0, CHUNK - 1, CHUNK, 2 * CHUNK - 1, BIG_DB_SIZE - CHUNK,
            BIG_DB_SIZE - 1]                      # first and last of 3 chunks
    rest = np.setdiff1d(np.arange(BIG_DB_SIZE), ends)
    pick = order[np.sort(np.concatenate(
        [ends, rng.choice(rest, SAMPLE - len(ends), replace=False)]))]
    sample, sample_lens = sw.pack_subjects(
        [flat[offs[i]:offs[i] + lens[i]] for i in pick], A, dev)
    for (qlen, tag, c), r in results.items():
        scores = r["scores"]
        check(r["launches"] == len(big[c]),
              f"q={qlen} {tag} C={c}: {r['launches']} launches for "
              f"{len(big[c])} chunks")
        check(bool(torch.isfinite(scores).all()) and float(scores.min()) >= 0,
              f"q={qlen} {tag} C={c}: scores not finite or negative")
        if c == CHUNK:
            prof, q_len = profs[qlen]
            live = torch.arange(sample.shape[1], device=dev) < sample_lens[:, None]
            want = sw.sw_plain(prof, torch.where(live, sample, A), gaps[tag],
                               GAP_EXTEND, q_len)
            check(want.cpu().tolist() == scores[torch.as_tensor(pick)].tolist(),
                  f"q={qlen} {tag}: chunked scores differ from sw_plain on "
                  f"the {len(pick)}-subject sample")
        else:
            check(torch.equal(scores, results[(qlen, tag, CHUNK)]["scores"]),
                  f"q={qlen} {tag}: chunks of {c} and {CHUNK} differ")
        # the chunks' launches back to back from one thread, over the wall
        prof, q_len = profs[qlen]
        busy_ms = cuda_ms(lambda: [sw.sw_batch(
            prof, s, n, gap_open=gaps[tag], gap_extend=GAP_EXTEND, q_len=q_len)
            for s, n in big[c]], iters=1, warmup=0)
        r.update(busy_ms=busy_ms, gcups=gcups(qlen, cells, r["wall"]))
        print(f"chunked q={qlen} {tag} C={c}: GCUPS={r['gcups']:.3f} "
              f"wall={r['wall']:.4f}s chunks={len(big[c])} "
              f"launches={r['launches']} ms/chunk={busy_ms / len(big[c]):.4f} "
              f"busy share={busy_ms / 1e3 / r['wall']:.4f} (kernels "
              f"{busy_ms / 1e3:.4f} s back to back) best={float(scores.max()):.0f}",
              flush=True)
    for qlen in QUERY_LENS:
        one = runs[(qlen, REGIMES[0][1])]
        print(f"one-subject farm vs chunked q={qlen} {REGIMES[0][1]}: GCUPS "
              f"{gcups(qlen, sum(len(s) for s in db), one['wall']):.3f} "
              f"({DB_SIZE} subjects, {DB_SIZE} launches) vs "
              f"{results[(qlen, REGIMES[0][1], CHUNK)]['gcups']:.3f} "
              f"({BIG_DB_SIZE} subjects, {n_chunks} launches)", flush=True)
    print(f"chunked path: {expected} kernel launches, {len(pick)}-subject "
          f"sample equal to sw_plain, every score finite and >= 0; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del big, small, sample
    torch.cuda.empty_cache()
    main = results[(KEYED_Q, REGIMES[0][1], CHUNK)]
    return expected, {"scores": main["scores"], "wall": main["wall"]}


def phase_timing(dev, sw, ops):
    """Per-launch kernel time at the main path's shapes, the plain
    version's, and the bound: one subject per launch (the one-subject
    farm's shape, D=352 padded to the 512 tile) and a chunk of
    ``TIMING_CHUNK`` subjects of D=352 per launch (the chunked search's)."""
    rng = np.random.default_rng(5)
    A = ops.BLOSUM50.shape[0]
    rows = []
    for b, dp in ((1, 512), (TIMING_CHUNK, MEAN_LEN)):
        for qlen in (1000, 144):
            query = torch.as_tensor(rng.integers(0, 20, qlen).astype(np.int32),
                                    device=dev)
            prof, q_len = ops.build_profile(query, ops.BLOSUM50.to(dev))
            dlen = MEAN_LEN
            subj = torch.full((b, dp), A, dtype=torch.int32, device=dev)
            subj[:, :dlen] = torch.as_tensor(rng.integers(0, 20, (b, dlen))
                                             .astype(np.int32), device=dev)
            lens = torch.full((b,), dlen, dtype=torch.int32, device=dev)
            kern = cuda_ms(lambda: sw.sw_batch(
                prof, subj, lens, gap_open=10.0, gap_extend=GAP_EXTEND,
                q_len=q_len), iters=200 if b == 1 else 20,
                warmup=20 if b == 1 else 3)
            plain = cuda_ms(lambda: sw.sw_plain(
                prof, subj, 10.0, GAP_EXTEND, q_len),
                iters=3 if b == 1 else 2, warmup=1)
            cells = q_len * dlen * b
            t_ops = cells * OPS_PER_CELL / PEAK_F32
            t_bytes = (prof.numel() * 4 + subj.numel() * 4 + lens.numel() * 4
                       + b * 4) / PEAK_BYTES
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            rate = cells / (kern * 1e-3) / 1e9
            rows.append(dict(q=qlen, d=dlen, b=b, dp=dp, ms=kern,
                             plain_ms=plain, bound_ms=bound_ms,
                             bound_by=bound_by, share=bound_ms / kern,
                             gcups=rate))
            print(f"timing q={qlen} B={b} d={dlen} (Dp={dp}): kernel "
                  f"{kern:.6f} ms/launch, plain {plain:.3f} ms, bound "
                  f"{bound_ms:.6f} ms ({bound_by}), {bound_ms / kern:.4f} of "
                  f"the bound, kernel GCUPS {rate:.3f}, library: none (no "
                  f"PyTorch call computes SW)", flush=True)
    return rows


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import smith_waterman as sw
    from repro_torch.kernels import ssd_scan as ssd
    return {"sw": sw, "fa": fa, "ssd": ssd}


def reset_counts():
    for mod in _counters().values():
        mod.reset_launch_count()


def read_counts():
    return {name: mod.launch_count() for name, mod in _counters().items()}


def within(got, want, tol):
    """(max |got - want|, whether |got - want| <= tol + tol*|want| holds
    everywhere)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool((diff <= tol + tol * want.abs()).all()) and \
        bool(torch.isfinite(got).all())
    return float(diff.max()), ok


def kernel_name(mangled):
    """``sw_warp_kernel<32>`` from ptxas's mangled entry name: the first
    length-prefixed identifier ending in ``kernel``, with its integer and
    bool template arguments."""
    for m in re.finditer(r"\d+", mangled):
        run = m.group()
        for k in range(len(run)):    # a length may follow a hash's digits
            name = mangled[m.end():m.end() + int(run[k:])]
            if name.endswith("kernel") and name.isidentifier():
                rest = mangled[m.end() + len(name):].split("EEv")[0]
                args = [v if t == "i" else ("false", "true")[int(v)]
                        for t, v in re.findall(r"L([ib])(\d+)E", rest)]
                return name + (f"<{', '.join(args)}>" if args else "")
    return mangled


def ptxas_name(mangled):
    """``kernel_name``, with ``[bf16]`` after an instance of bf16 inputs."""
    return kernel_name(mangled) + ("[bf16]" if "nv_bfloat16" in mangled else "")


def phase_build(_build):
    t0 = time.perf_counter()
    _build.load_all()
    wall = time.perf_counter() - t0
    for name in _build.SOURCES:
        secs, log = _build.build_info(name)
        print(f"build {name}.cu: " + (log.splitlines()[0] if log.startswith("reused")
                                      else f"{secs:.1f} s nvcc"), flush=True)
        for entry, (regs, stores, loads) in _build.ptxas_usage(log).items():
            print(f"  ptxas: {ptxas_name(entry)}: {regs} registers, {stores} bytes "
                  f"spill stores, {loads} bytes spill loads", flush=True)
        for line in log.splitlines():
            if "arning" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    print(f"build: {len(_build.SOURCES)} sources in {wall:.1f} s wall "
          f"(one nvcc each, started together)", flush=True)


def phase_model_kernels(dev, fa, ssd):
    """FA and SSD kernels against their plain versions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    worst = {"fa": {}, "ssd": {}}
    fa_cases = [  # B, H, Hkv, S, T, D, window
        (1, 2, 2, 64, 64, 16, None),
        (2, 4, 2, 96, 160, 16, None),      # GQA, ragged, S < T
        (1, 8, 1, 128, 128, 64, None),     # MQA
        (2, 32, 32, 1, 1, 80, None),       # one row, one key
        (1, 32, 32, 257, 257, 80, None),   # ragged, equal
        (1, 4, 2, 300, 77, 80, None),      # S > T
        (2, 8, 8, 500, 500, 128, 128),     # window
        (1, 4, 1, 33, 1000, 128, 64),      # MQA, window, S << T
        (1, 8, 4, 200, 200, 64, 1),        # window 1: each row sees itself
    ]
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, Hkv, S, T, D, window in fa_cases:
            q, k, v = randn(B, H, S, D, dtype=dtype), \
                randn(B, Hkv, T, D, dtype=dtype), randn(B, Hkv, T, D, dtype=dtype)
            got = fa.flash_attention(q, k, v, causal=True, window=window)
            want = fa.fa_plain(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            err, ok = within(got, want, FA_TOL[dtype])
            check(ok and got.dtype == dtype,
                  f"FA kernel != plain at {(B, H, Hkv, S, T, D, window)} "
                  f"{dtype}: max err {err}")
            key = str(dtype).removeprefix("torch.")
            worst["fa"][key] = max(worst["fa"].get(key, 0.0), err)
            n += 1
        # the model's (B, S, H, D) layout, passed as (B, H, S, D) views
        q, k, v = (randn(2, 190, 32, 80, dtype=dtype) for _ in range(3))
        got = fa.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)))
        want = fa.fa_plain(*(t.transpose(1, 2) for t in (q, k, v)))
        torch.cuda.synchronize()
        err, ok = within(got, want, FA_TOL[dtype])
        check(ok and got.transpose(1, 2).is_contiguous(),
              f"FA kernel on the model's layout, {dtype}: max err {err}")
        n += 1
    # the bf16 (wgmma/TMA) kernel's edges, as tests/test_torch_gpu.py
    for B, H, Hkv, S, T, D, window, q_offset, causal in FA_BF16_EDGES:
        q = randn(B, H, S, D, dtype=torch.bfloat16)
        k, v = (randn(B, Hkv, T, D, dtype=torch.bfloat16) for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.fa_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, ok = within(got, want, FA_TOL[torch.bfloat16])
        check(ok, f"FA bf16 kernel != plain at {(B, H, Hkv, S, T, D)} {kw}: "
                  f"max err {err}")
        worst["fa"]["bfloat16"] = max(worst["fa"]["bfloat16"], err)
        n += 1
    print(f"fa kernel == plain on {n} cases: worst |err| f32 "
          f"{worst['fa']['float32']:.3e} (tol 2e-5 + 2e-5*|plain|), bf16 "
          f"{worst['fa']['bfloat16']:.3e} (tol 2e-2 + 2e-2*|plain|)", flush=True)

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for cd in (torch.float32, torch.bfloat16):
            for b, T, H, P, N, chunk, with_h0 in SSD_CASES:
                x = randn(b, T, H, P, dtype=dtype)
                dt = torch.nn.functional.softplus(randn(b, T, H)) * 0.1
                A = -torch.exp(randn(H))
                Bm, Cm = randn(b, T, N, dtype=dtype), randn(b, T, N, dtype=dtype)
                h0 = randn(b, H, P, N) if with_h0 else None
                y, h = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                                    compute_dtype=cd)
                witness = cd == torch.float32 and chunk > SSD_WITNESS_CHUNK
                y_p, h_p = ssd.ssd_plain(
                    x, dt, A, Bm, Cm, chunk, h0=h0,
                    compute_dtype=torch.float64 if witness else cd)
                torch.cuda.synchronize()
                ey, oky = within(y, y_p, SSD_TOL[cd])
                eh, okh = within(h, h_p, SSD_TOL[cd])
                check(oky and okh,
                      f"SSD kernel != plain{' (f64)' if witness else ''} at "
                      f"{(b, T, H, P, N, chunk, with_h0)} x {dtype} compute "
                      f"{cd}: max err y {ey} h {eh}")
                if witness:
                    y32, _ = ssd.ssd_plain(x, dt, A, Bm, Cm, chunk, h0=h0)
                    print(f"ssd chunk {chunk} {(b, T, H, P, N)} x {dtype}: "
                          f"max err y against the f64 plain: kernel {ey:.3e}, "
                          f"f32 plain {within(y32, y_p, SSD_TOL[cd])[0]:.3e}",
                          flush=True)
                key = "compute_" + str(cd).removeprefix("torch.")
                worst["ssd"][key] = max(worst["ssd"].get(key, 0.0), ey, eh)
                n += 1
    print(f"ssd kernel == plain on {n} cases (f64 plain for f32 products at "
          f"chunks over {SSD_WITNESS_CHUNK}): worst |err| f32 products "
          f"{worst['ssd']['compute_float32']:.3e} (tol 1e-4 + 1e-4*|plain|), "
          f"bf16 products {worst['ssd']['compute_bfloat16']:.3e} "
          f"(tol 5e-2 + 5e-2*|plain|)", flush=True)
    return worst


def _events_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def serve_requests(cfg, params, dev, rng, slo=None):
    """``SERVE_REQS`` requests of 16-64 prompt tokens through the
    ``ServeEngine`` on the threads farm: tags and request ids in order,
    ``SERVE_NEW`` tokens each, request 0 alone gives its batched tokens,
    and no kernel launched (serving runs ``decode_step`` only, as in the
    reference).  ``slo=`` goes to the engine (phase 12 (b)).  Returns
    (engine, wall seconds)."""
    from repro_torch.launch.serve import Request, ServeEngine
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                              int(rng.integers(16, 65)))]
               for _ in range(SERVE_REQS)]
    before = read_counts()
    eng = ServeEngine(cfg, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                      params=params, device=dev, slo=slo)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=SERVE_NEW))
    t0 = time.perf_counter()
    results = eng.run()
    serve_wall = time.perf_counter() - t0
    check(len(results) == SERVE_REQS, f"served {len(results)} of {SERVE_REQS}")
    check([r.tag for r in results] == list(range(SERVE_REQS)),
          f"tags out of order: {[r.tag for r in results]}")
    check([r.rid for r in results] == list(range(SERVE_REQS)),
          "requests out of submission order")
    check(all(len(r.generated) == SERVE_NEW for r in results),
          f"token counts {[len(r.generated) for r in results]}")
    solo = ServeEngine(cfg, max_batch=SERVE_BATCH, max_len=SERVE_LEN,
                       params=params, device=dev)
    solo.submit(Request(rid=0, prompt=prompts[0], max_new=SERVE_NEW))
    alone = solo.run()[0]
    check(alone.generated == results[0].generated,
          f"isolation: request 0 alone {alone.generated} != batched "
          f"{results[0].generated}")
    after = read_counts()
    check(after == before, f"serving launched kernels: {before} -> {after}")
    lat = eng._latency
    rep = eng.last_report
    print(f"serve {cfg.name} {SERVE_REQS} requests (prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, max_new "
          f"{SERVE_NEW}, max_batch {SERVE_BATCH}, max_len {SERVE_LEN}): "
          f"{rep.meta['tokens']} tokens in {eng.steps_run} decode steps, "
          f"{serve_wall:.3f} s, {rep.gauges['serve.tokens_per_s']:.2f} tokens/s; "
          f"latency p50 {lat.p50 / 1e3:.1f} ms p99 {lat.p99 / 1e3:.1f} ms; tags "
          f"in order; request 0 alone gives the same tokens; serving runs "
          f"decode_step only, so no kernel (as in the reference)", flush=True)
    return eng, serve_wall


def _step_batch(batch, t):
    """The inputs of position t (the vision stream goes with every step)."""
    return {k: v if k == "vision_embeds" else v[:, t:t + 1]
            for k, v in batch.items()}


def consistency(dev, cfg, batch, bf16_logits, launches):
    """f32 ``prefill`` through the kernels against f32 token-by-token
    ``decode_step`` (no kernel) from an empty cache, on the last logits,
    within ``CONSIST_TOL``; the bf16 model's prefill logits on ``batch``
    (``bf16_logits``: its draws the f32 model repeats unrounded) must miss
    it.  The f32 prefill must launch ``launches``."""
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    S = next(iter(batch.values())).shape[1]
    cfg32 = cfg.replace(dtype="float32")
    params = init_params(cfg32, 0, device=dev)     # the same draws, unrounded
    with torch.no_grad():
        before = read_counts()
        p_logits = prefill(params, batch, cfg32)[0]
        launched = {k: v - before[k] for k, v in read_counts().items()}
        check(launched == launches,
              f"{cfg.name} f32 prefill launched {launched}, expected {launches}")
        with _plain_versions():
            plain_logits = prefill(params, batch, cfg32)[0]
        cache = init_cache(cfg32, 1, S, device=dev)
        t0 = time.perf_counter()
        for t in range(S):
            d_logits, cache = decode_step(params, _step_batch(batch, t), cache,
                                          t, cfg32)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    err = float((p_logits - d_logits).abs().max())
    err_plain = float((plain_logits - d_logits).abs().max())
    err_kp = float((p_logits - plain_logits).abs().max())
    err_bf16 = float((bf16_logits - d_logits).abs().max())
    scale = float(d_logits.abs().max())
    print(f"consistency {cfg.name} ({cfg.n_layers} layers) f32, S={S}: max "
          f"|prefill - decode| last logits {err:.3e} (tol {CONSIST_TOL}, logits "
          f"up to {scale:.3f}); the plain versions' prefill is {err_plain:.3e} "
          f"from the decode and {err_kp:.3e} from the kernels'; the bf16 "
          f"prefill is {err_bf16:.3e} from the f32 decode, so bf16 fails the "
          f"tolerance; argmax prefill {int(p_logits.flatten(1).argmax(-1)[0])} "
          f"decode {int(d_logits.flatten(1).argmax(-1)[0])}; {S} decode steps "
          f"{dec_s:.2f} s", flush=True)
    check(bool(torch.isfinite(p_logits).all()), "f32 prefill logits not finite")
    check(err <= CONSIST_TOL,
          f"{cfg.name} f32 prefill vs decode: {err} > {CONSIST_TOL}")
    check(err_bf16 > CONSIST_TOL,
          f"{cfg.name} bf16 prefill vs f32 decode {err_bf16} is within "
          f"{CONSIST_TOL}: the tolerance would not catch bf16")
    del params, cache
    torch.cuda.empty_cache()


def phase_model_path(dev):
    """Zamba2-2.7B at full width: prefill through the kernels, the f32
    consistency check, serving through the ServeEngine."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    param_count, prefill)
    from repro_torch.models.model import segment_counts
    from repro_torch.tree import tree_leaves
    cfg = ARCHS[MAIN_ARCH]
    segs = segment_counts(cfg)
    g, inner = segs["groups"], segs["ssm_per_group"]     # 9 groups of 5 + 1
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_el = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.hdim}, d_ff {cfg.d_ff}, ssm heads "
          f"{cfg.ssm_heads} x {cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}, {cfg.dtype}; "
          f"{n_el} tensor elements ({n_bytes / 1e9:.3f} GB), param_count "
          f"{param_count(cfg)}; init {time.perf_counter() - t0:.1f} s",
          flush=True)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))
                            .astype(np.int64)).to(dev)
    torch.cuda.synchronize()

    reset_counts()                                   # --- counted window ---
    with torch.no_grad():
        (logits, cache), ms1 = _events_ms(
            lambda: prefill(params, {"tokens": toks}, cfg))
    c1 = read_counts()
    check(c1["fa"] == g and c1["ssd"] == g * inner and c1["sw"] == 0,
          f"one prefill launched {c1}, expected fa {g}, ssd {g * inner}")
    check(tuple(logits.shape) == (PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    kv = (g, PREFILL_B, PREFILL_S, cfg.n_kv_heads, cfg.hdim)
    want_shapes = {"h": (g, inner, PREFILL_B, cfg.ssm_heads, cfg.ssm_headdim,
                         cfg.ssm_state),
                   "conv": (g, inner, PREFILL_B, cfg.ssm_conv - 1,
                            cfg.d_inner + 2 * cfg.ssm_state),
                   "k": kv, "v": kv}
    check({k: tuple(v.shape) for k, v in cache.items()} == want_shapes,
          f"prefill cache shapes {[(k, tuple(v.shape)) for k, v in cache.items()]}")
    check(all(bool(torch.isfinite(v.float()).all()) for v in cache.values()),
          "prefill cache not finite")
    del cache
    with torch.no_grad():
        t0 = time.perf_counter()
        out = prefill(params, {"tokens": toks}, cfg)
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        del out
        _, ms3 = _events_ms(lambda: prefill(params, {"tokens": toks}, cfg))
    c3 = read_counts()
    check(c3["fa"] == 3 * g and c3["ssd"] == 3 * g * inner,
          f"three prefills launched {c3}, expected fa {3 * g}, "
          f"ssd {3 * g * inner}")
    ntok = PREFILL_B * PREFILL_S
    print(f"prefill B={PREFILL_B} S={PREFILL_S}: {ms1:.3f} ms (first, counted: "
          f"fa {c1['fa']}, ssd {c1['ssd']} launches), {ms3:.3f} ms steady "
          f"({ntok / ms3 * 1e3:.1f} tokens/s); host enqueue {enq * 1e3:.3f} ms "
          f"of {wall2 * 1e3:.3f} ms wall; logits finite, cache shapes ok",
          flush=True)
    # where the prefill's device time goes, by kernel name
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        prefill(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
    groups, names, stalled = {}, {}, 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if not us or ev.key.startswith(("cuda", "aten::", "Memcpy", "Memset")):
            continue
        name = ev.key
        if name.startswith("Command Buffer Full"):   # the host waiting, not a kernel
            stalled += us / 1e3
            continue
        low = name.lower()
        grp = ("fa_kernel" if "fa_kernel" in name or "fa_wgmma_kernel" in name else
               "ssd_*_kernel" if SSD_KERNEL.search(name) else
               "gemm" if any(g in low for g in ("gemm", "cutlass", "xmma",
                                                "cublas", "nvjet")) else
               "other")
        groups[grp] = groups.get(grp, 0.0) + us / 1e3
        names[name] = names.get(name, 0.0) + us / 1e3
    total = sum(groups.values())
    if total > 0:
        print("prefill device time by kernel (torch.profiler): " + ", ".join(
            f"{g} {t:.3f} ms ({t / total:.3f})" for g, t in
            sorted(groups.items(), key=lambda kv: -kv[1]))
            + f"; total {total:.3f} ms; the host waited {stalled:.3f} ms on a "
            f"full launch queue (\"Command Buffer Full\")", flush=True)
        print("prefill top kernels: " + "; ".join(
            f"{n[:60]} {t:.3f} ms" for n, t in
            sorted(names.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    else:
        print("prefill device time by kernel: the profiler saw no device "
              "time (not measured)", flush=True)
    reset_counts()

    # serving: 8 requests through the ServeEngine, bf16, full width, held
    # to a service level (phase 12 (b))
    from repro_torch.core.monitor import SLOMonitor
    slo = SLOMonitor(**SLO)
    eng, serve_wall = serve_requests(cfg, params, dev, rng, slo=slo)
    slo_readings(eng, slo)
    # the same decode step at the engine's batch, outside the farm
    cache = init_cache(cfg, SERVE_BATCH, SERVE_LEN, device=dev)
    one = {"tokens": torch.zeros((SERVE_BATCH, 1), dtype=torch.long, device=dev)}
    with torch.no_grad():
        for t in range(2):
            _, cache = decode_step(params, one, cache, t, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(2, 18):
            _, cache = decode_step(params, one, cache, t, cfg)
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        bare = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode_step(params, one, cache, 18, cfg)
            torch.cuda.synchronize()
    n_kernels = sum(ev.count for ev in prof.key_averages()
                    if getattr(ev, "device_time_total", 0)
                    and not ev.key.startswith(("cuda", "aten::",
                                               "Command Buffer Full")))
    print(f"decode_step alone, batch {SERVE_BATCH}: {bare / 16 * 1e3:.3f} ms/step "
          f"wall, host enqueue {enq / 16 * 1e3:.3f} ms/step, {n_kernels} device "
          f"kernels per step (torch.profiler); in the engine "
          f"{serve_wall / eng.steps_run * 1e3:.3f} ms/step", flush=True)
    del eng, cache

    # consistency: f32 prefill (kernels) against f32 decode (no kernel)
    prompt = {"tokens": toks[:1, :CONSIST_S]}
    with torch.no_grad():
        bf16_logits = prefill(params, prompt, cfg)[0]
    del params
    torch.cuda.empty_cache()
    consistency(dev, cfg, prompt, bf16_logits, {"sw": 0, "fa": g, "ssd": g * inner})
    return c1, {"prefill_ms": ms3, "first_prefill_ms": ms1}


@contextlib.contextmanager
def _plain_versions():
    """Route the model's attention and SSD calls to the kernels' plain
    versions on the card, for the consistency check only."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import attention, ssm

    def plain_ssd(x, dt, A, B, C, *, chunk, h0=None, compute_dtype=torch.float32):
        return ssd.ssd_plain(x, dt, A, B, C, min(chunk, x.shape[1]), h0=h0,
                             compute_dtype=compute_dtype)
    saved = attention.flash_attention, ssm.ssd_scan
    attention.flash_attention, ssm.ssd_scan = fa.fa_plain, plain_ssd
    try:
        yield
    finally:
        attention.flash_attention, ssm.ssd_scan = saved


def ssd_fwd_flops(b, T, H, P, N, l):
    """The SSD forward's operations: per (batch, chunk) C·Bᵀ over the causal
    pairs, and per head the gating (a multiply a pair), the diagonal
    product, the chunk's state and y_off (l·N·P multiply-adds each) and the
    state's update; 2 flops a multiply-add."""
    nc, tri = T // l, l * (l + 1) // 2
    return b * nc * (2 * N * tri + H * (tri + 2 * P * tri + 4 * l * N * P + 2 * P * N))


def ssd_bwd_flops(b, T, H, P, N, l):
    """The least operations of the SSD backward: per (batch, chunk) and head
    two products over the causal pairs (dy·uᵀ, G·dy) and four l·N·P ones (the
    state gradient, h_inᵀ·dy for dC and the y_off term, gᵀ·u for dB, g·B for
    du), and per chunk dS·B and dSᵀ·C over the causal pairs; 2 flops a
    multiply-add."""
    nc, tri = T // l, l * (l + 1) // 2
    return 2 * b * nc * (H * (2 * P * tri + 4 * l * N * P) + 2 * N * tri)


def ssd_bwd_tf32_flops(b, T, H, P, N, l, x_dtype, bc_dtype):
    """The least operations of the SSD backward as 3xTF32 products: each of
    ``ssd_bwd_flops``'s products once per TF32 term it needs, by the dtypes
    of its operands.  Two terms where one operand is bf16, whose low part
    is zero: dy·xᵀ (dt_j a column scale after it) with bf16 x; the state
    gradient C·dy, g·B, dS·B and dSᵀ·C with bf16 B and C.  Three where both
    are f32: G·dy and the dB/dC head terms h_inᵀ·dy and gᵀ·u (u = dt·x,
    whose dt differs by head along the H·P axis)."""
    nc, tri = T // l, l * (l + 1) // 2
    tx = 2 if x_dtype == torch.bfloat16 else 3
    tbc = 2 if bc_dtype == torch.bfloat16 else 3
    per_head = (tx + 3) * P * tri + (2 * tbc + 2 * 3) * l * N * P
    return 2 * b * nc * (H * per_head + 2 * tbc * N * tri)


def ssd_bwd_kernel_flops(b, T, H, P, N, l):
    """What the backward kernels do instead: the causal products over whole
    64 x 64 tiles and a fifth l·N·P product (C·h_in, which the forward
    computed but did not keep)."""
    nc, nt = T // l, -(-l // 64)
    pairs = nt * (nt + 1) // 2 * 64 * 64
    return 2 * b * nc * (H * (2 * P * pairs + 5 * l * N * P) + 2 * N * pairs)


def phase_model_timing(dev, fa, ssd):
    """FA and SSD at the main path's shapes: kernel, plain, bound, library."""
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {"fa_shapes": []}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i, (path, B, H, Hkv, S, T, D, causal, window) in enumerate(FA_SHAPES):
        # the model's layouts: q (B,S,H,D), k/v (B,T,Hkv,D), passed as views;
        # the main shape draws first from ``gen``, as the SSD inputs do after
        g = gen if path == MAIN_FA_PATH else \
            torch.Generator(device=dev).manual_seed(50 + i)
        q = torch.randn((B, S, H, D), generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        qv, kv, vv = (t.transpose(1, 2) for t in (q, k, v))
        kw = dict(causal=causal, window=window)
        got = fa.flash_attention(qv, kv, vv, **kw)
        want = fa.fa_plain(qv, kv, vv, **kw)
        torch.cuda.synchronize()
        err, ok = within(got, want, FA_TOL[torch.bfloat16])
        check(ok, f"FA kernel != plain at the {path} shape: {err}")
        del got
        kern = cuda_ms(lambda: fa.flash_attention(qv, kv, vv, **kw), iters=10,
                       warmup=2)
        plain = cuda_ms(lambda: fa.fa_plain(qv, kv, vv, **kw), iters=2, warmup=1)
        lib_kw, lib_args = {"enable_gqa": Hkv != H}, []
        if window:
            qpos = torch.arange(S, device=dev)[:, None]
            kpos = torch.arange(T, device=dev)[None, :]
            lib_kw["attn_mask"] = (kpos <= qpos) & (kpos > qpos - window)
            lib_args.append("attn_mask=<bool causal window mask>")
        elif causal:
            lib_kw["is_causal"] = True
            lib_args.append("is_causal=True")
        if Hkv != H:
            lib_args.append("enable_gqa=True")
        lib_name = f"scaled_dot_product_attention({', '.join(lib_args)})"
        try:
            lib = cuda_ms(lambda: sdpa(qv, kv, vv, **lib_kw), iters=10, warmup=2)
            lib_err = float((sdpa(qv, kv, vv, **lib_kw).float()
                             - want.float()).abs().max())
        except torch.cuda.OutOfMemoryError:
            lib, lib_err = None, None
            torch.cuda.empty_cache()
        pairs = fa_pairs(S, T, causal, window)
        flop = 4 * B * H * D * pairs
        t_ops = flop / PEAK_BF16
        t_bytes = 2 * (B * H * S * D + B * Hkv * T * D) * 2 / PEAK_BYTES
        row = dict(path=path, shape=f"B={B} H={H} Hkv={Hkv} S={S} T={T} D={D}"
                   f"{' causal' if causal else ' non-causal'}"
                   f"{f' window {window}' if window else ''} bf16",
                   ms=kern, plain_ms=plain, library_ms=lib, library=lib_name,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes", err=err)
        rows["fa_shapes"].append(row)
        lib_txt = (f"{lib:.4f} ms (|err| vs plain {lib_err:.3e})" if lib is not None
                   else "not measured (out of memory)")
        print(f"timing fa {path} {row['shape']}: kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{flop / 1e9:.2f} GFLOP at 989 TFLOP/s bf16; bytes "
              f"{t_bytes * 1e3:.4f} ms), {flop / (kern * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{row['bound_ms'] / kern:.4f} of the bound; library {lib_name} "
              f"{lib_txt}; kernel |err| vs plain {err:.3e}", flush=True)
        if path == MAIN_FA_PATH:
            rows["fa"] = row
            print(f"timing fa bf16 wgmma/TMA kernel at the {path} shape: "
                  f"{kern / lib:.3f}x the library's time; the SIMT kernel it "
                  f"replaced read {FA_SIMT_MS} ms ({FA_SIMT_MS / kern:.1f}x this "
                  f"one)", flush=True)
        del q, k, v, qv, kv, vv, want, lib_kw
        torch.cuda.empty_cache()

    b, T, Hs, P, N, l = PREFILL_B, PREFILL_S, 80, 64, 64, 256
    x = torch.randn((b, T, Hs, P), generator=gen, device=dev).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn((b, T, Hs), generator=gen,
                                                  device=dev)) * 0.1
    A = -torch.exp(torch.randn((Hs,), generator=gen, device=dev))
    Bm, Cm = (torch.randn((b, T, N), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    y, h = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=l)
    y_p, h_p = ssd.ssd_plain(x, dt, A, Bm, Cm, l)
    torch.cuda.synchronize()
    ey, oky = within(y, y_p, SSD_TOL[torch.float32])
    eh, okh = within(h, h_p, SSD_TOL[torch.float32])
    check(oky and okh, f"SSD kernel != plain at the main path's shape: {ey} {eh}")
    kern = cuda_ms(lambda: ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=l), iters=10, warmup=2)
    plain = cuda_ms(lambda: ssd.ssd_plain(x, dt, A, Bm, Cm, l), iters=3, warmup=1)
    flops = ssd_fwd_flops(b, T, Hs, P, N, l)
    t_ops = flops / PEAK_F32
    nbytes = (x.numel() * 2 + dt.numel() * 4 + A.numel() * 4 + 2 * Bm.numel() * 2
              + y.numel() * 4 + h.numel() * 4)
    t_bytes = nbytes / PEAK_BYTES
    rows["ssd"] = dict(ms=kern, plain_ms=plain, library_ms=None,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       err=max(ey, eh))
    print(f"timing ssd b={b} T={T} H={Hs} P={P} N={N} chunk={l} x bf16, f32 "
          f"products: kernel {kern:.4f} ms, plain {plain:.4f} ms, bound "
          f"{rows['ssd']['bound_ms']:.4f} ms ({rows['ssd']['bound_by']}: "
          f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s f32; {nbytes / 1e6:.1f} MB "
          f"{t_bytes * 1e3:.4f} ms), library: none (no PyTorch call computes "
          f"the SSD scan); kernel |err| vs plain y {ey:.3e} h {eh:.3e}",
          flush=True)
    print(f"timing ssd five-pass kernels: {flops / (kern * 1e-3) / 1e12:.1f} "
          f"TFLOP/s, {rows['ssd']['bound_ms'] / kern:.4f} of the bound; the "
          f"one-block-per-(batch, head) kernel it replaced read {SSD_SERIAL_MS} "
          f"ms ({SSD_SERIAL_MS / kern:.2f}x this one); {kern / SSD_FWD_MS:.4f} "
          f"of the {SSD_FWD_MS} ms read before the backward's redesign", flush=True)
    # one main-shape call split by pass (torch.profiler, device time)
    from torch.profiler import ProfilerActivity, profile
    reps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=l)
        torch.cuda.synchronize()
    passes = {}
    for ev in prof.key_averages():
        m = SSD_KERNEL.search(ev.key)
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        if m and us:
            passes[m.group(0)] = passes.get(m.group(0), 0.0) + us / 1e3 / reps
    if passes:
        print("timing ssd by pass (torch.profiler, ms per call): " + ", ".join(
            f"{k} {v:.4f}" for k, v in passes.items())
            + f"; sum {sum(passes.values()):.4f}", flush=True)
    else:
        print("timing ssd by pass: the profiler saw no device time (not "
              "measured)", flush=True)
    return rows


# phase 9: the moe, vlm and audio families at full width, bf16, random
# weights from seed 0, depth cut so the bf16 weights fit the card's 80 GB
# beside the activations: the path's name in the kernels line, the cut,
# layers kept, prefill batch and length, layers and prompt of the f32
# consistency check.  Mixtral prefills two windows,
# a multiple of its window of 4096: on a windowed model the reference's
# prefill keeps the last min(window, S) rows, and its decode then writes at
# cache_len % T, which evicts the wrong row when S is not a multiple of
# the window.  Its consistency prompt of 4608 runs past the window, so the
# kernel's window and the decode's rolling cache are both exercised.
FAMILY_RUNS = {
    "mixtral-8x7b": dict(path="mixtral", cut="16 of 32 layers", layers=16,
                         batch=2, seq=8192, consist_layers=2, consist_s=4608),
    "llama-3.2-vision-90b": dict(
        path="llama-vision", cut="25 of 100 layers: 5 whole periods of 4 self "
        "+ 1 cross blocks", layers=25, batch=1, seq=2048, consist_layers=5,
        consist_s=512),
    "musicgen-medium": dict(path="musicgen", cut="all 48 layers, nothing cut",
                            layers=48, batch=2, seq=1500, consist_layers=48,
                            consist_s=512),
}
FAMILY_DECODE = 16            # decode steps after the vlm and audio prefills
FAMILY_SEED = 9               # tokens, frames and vision embeddings
GEMM_NAMES = ("gemm", "cutlass", "xmma", "cublas", "nvjet")
MOE_SPANS = ("moe.apply", "moe.experts")    # profiler ranges of the MoE split


def family_batch(cfg, B, S, seed, dev):
    """The model's inputs, drawn with numpy: token ids, or frame embeddings
    (the audio stub frontend); vlm adds (B, vision_patches, vision_dim)
    vision embeddings (the vlm stub frontend)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        b = {"frames": torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model), dtype=np.float32))}
    else:
        b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        b["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_patches, cfg.vision_dim), dtype=np.float32))
    return {k: v.to(dev) for k, v in b.items()}


def fa_pairs(S, T, causal, window):
    """(query, key) pairs a flash-attention call must score: causal with
    q_offset 0, a sliding window of ``window`` keys, or all S x T."""
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def prefill_flops(cfg, B, S):
    """The matmul and attention FLOPs one ``prefill`` needs (unpadded heads,
    routed experts only, logits of the last position)."""
    d, H, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    proj = 2 * d * (2 * H * dh + 2 * kv * dh)            # q, k, v, o per row
    ffn = 2 * 3 * d * cfg.d_ff * (cfg.top_k if cfg.n_experts else 1) \
        + 2 * d * cfg.n_experts
    attn = 4 * B * H * dh * fa_pairs(S, S, True, cfg.sliding_window)
    kinds = cfg.layer_kinds()
    n_self = sum(k == "attn" for k in kinds)
    flops = n_self * (B * S * (proj + ffn) + attn)
    n_cross = sum(k == "cross" for k in kinds)
    if n_cross:
        P = cfg.vision_patches
        flops += 2 * B * P * cfg.vision_dim * d            # vision projection
        flops += n_cross * (B * S * (2 * d * 2 * H * dh + ffn)
                            + B * P * 2 * d * 2 * kv * dh
                            + 4 * B * H * dh * S * P)
    return flops + 2 * B * d * cfg.vocab_size * max(cfg.n_codebooks, 1)


@contextlib.contextmanager
def _moe_spans():
    """``torch.profiler`` ranges around each MoE block ("moe.apply") and
    each expert's SwiGLU inside it ("moe.experts"), for the prefill split."""
    from torch.profiler import record_function
    from repro_torch.models import model, moe
    saved = model.moe_apply, moe._expert_ffn

    def apply(*a, **kw):
        with record_function(MOE_SPANS[0]):
            return saved[0](*a, **kw)

    def experts(*a, **kw):
        with record_function(MOE_SPANS[1]):
            return saved[1](*a, **kw)
    model.moe_apply, moe._expert_ffn = apply, experts
    try:
        yield
    finally:
        model.moe_apply, moe._expert_ffn = saved


def _kernels_under(ev):
    """(name, us) of every kernel launched inside a profiled CPU range."""
    for k in ev.kernels:
        yield k.name, k.duration
    for ch in ev.cpu_children:
        yield from _kernels_under(ch)


def prefill_split(prof):
    """One profiled prefill's device time (ms) by part: FA, expert GEMMs,
    the experts' elementwise SwiGLU, the MoE dispatch (routing, sort,
    gather, per-expert counts, scatter-add), other GEMMs, the rest."""
    # the device side mirrors each range as an annotation: not a kernel
    kernels = [(ev.name, ev.device_time_total) for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.name not in MOE_SPANS]
    total = sum(us for _, us in kernels) / 1e3
    fa_ms = sum(us for n, us in kernels if "fa_kernel" in n
                or "fa_wgmma_kernel" in n) / 1e3
    gemm_ms = sum(us for n, us in kernels
                  if any(g in n.lower() for g in GEMM_NAMES)) / 1e3
    moe_k, exp_k = [], []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            if ev.name == MOE_SPANS[0]:
                moe_k += list(_kernels_under(ev))
            elif ev.name == MOE_SPANS[1]:
                exp_k += list(_kernels_under(ev))
    moe_ms = sum(us for _, us in moe_k) / 1e3
    exp_gemm = sum(us for n, us in exp_k
                   if any(g in n.lower() for g in GEMM_NAMES)) / 1e3
    exp_ms = sum(us for _, us in exp_k) / 1e3
    moe_gemm = sum(us for n, us in moe_k
                   if any(g in n.lower() for g in GEMM_NAMES)) / 1e3
    return {"total": total, "fa": fa_ms, "expert GEMMs": exp_gemm,
            "expert SwiGLU elementwise": exp_ms - exp_gemm,
            "dispatch": moe_ms - exp_ms,
            "other GEMMs": gemm_ms - moe_gemm,
            "rest": total - fa_ms - moe_ms - (gemm_ms - moe_gemm)}


def _pad_cache(cache, n):
    """A prefill's cache with ``n`` empty rows after its last, for decode
    steps past it (the reference's caches are allocated at max_len)."""
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n))
            for k, v in cache.items()}


def family_main_path(dev, arch, run):
    """One family at full width: ``prefill`` through the FA kernel (counted
    window), a steady prefill timed with CUDA events, its device time by
    part, then serving (moe) or decode steps after the prefill (vlm,
    audio), then the f32 consistency check at its cut depth."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, init_params, param_count, prefill
    from repro_torch.tree import tree_leaves
    base = ARCHS[arch]
    cfg = base.replace(n_layers=run["layers"])
    B, S = run["batch"], run["seq"]
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_el = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    extra = (f", {cfg.n_experts} experts top-{cfg.top_k}" if cfg.n_experts else "") \
        + (f", window {cfg.sliding_window}" if cfg.sliding_window else "") \
        + (f", cross-attention every {cfg.cross_attn_every} over "
           f"{cfg.vision_patches} x {cfg.vision_dim} vision rows"
           if cfg.cross_attn_every else "") \
        + (f", {cfg.n_codebooks} codebooks" if cfg.n_codebooks else "")
    print(f"model {arch} ({run['cut']}): d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads (padded to {cfg.n_heads_padded}) x {cfg.hdim}, "
          f"kv {cfg.n_kv_heads}, d_ff {cfg.d_ff}{extra}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {n_el} tensor elements ({n_bytes / 1e9:.3f} GB), "
          f"param_count {param_count(cfg)} of the full model's "
          f"{param_count(base)} ({param_count(base) * 2 / 1e9:.1f} GB in bf16); "
          f"init {init_s:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    batch = family_batch(cfg, B, S, FAMILY_SEED, dev)
    torch.cuda.synchronize()
    want = (B, cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks else \
        (B, cfg.vocab_size)

    reset_counts()                                   # --- counted window ---
    with torch.no_grad():
        (logits, cache), ms1 = _events_ms(lambda: prefill(params, batch, cfg))
    counts = read_counts()                           # --- end of window ---
    check(counts == {"sw": 0, "fa": cfg.n_layers, "ssd": 0},
          f"{arch} prefill launched {counts}, expected fa {cfg.n_layers}")
    check(tuple(logits.shape) == want and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits {tuple(logits.shape)} not {want} or not finite")
    T = min(S, cfg.sliding_window) if cfg.sliding_window else S
    kv = (B, T, cfg.n_kv_heads if cfg.n_kv_heads != cfg.n_heads
          else cfg.n_heads_padded, cfg.hdim)
    lead = (cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1) \
        if cfg.cross_attn_every else (cfg.n_layers,)
    check({k: tuple(v.shape) for k, v in cache.items()} ==
          {"k": lead + kv, "v": lead + kv}
          and all(bool(torch.isfinite(v.float()).all()) for v in cache.values()),
          f"{arch} prefill cache {[(k, tuple(v.shape)) for k, v in cache.items()]}")
    with torch.no_grad():
        t0 = time.perf_counter()
        out = prefill(params, batch, cfg)
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del out
        _, ms2 = _events_ms(lambda: prefill(params, batch, cfg))
    flops = prefill_flops(cfg, B, S)
    bound_ms = max(flops / PEAK_BF16, n_bytes / PEAK_BYTES) * 1e3
    ntok = B * S
    print(f"prefill {arch} B={B} S={S}: {ms1:.3f} ms (first, counted: fa "
          f"{counts['fa']} launches), {ms2:.3f} ms steady ({ntok / ms2 * 1e3:.1f} "
          f"tokens/s); host enqueue {enq * 1e3:.3f} ms of {wall * 1e3:.3f} ms "
          f"wall; bound {bound_ms:.3f} ms ({flops / 1e12:.2f} TFLOP at 989 "
          f"TFLOP/s bf16), {bound_ms / ms2:.4f} of it; logits {want} finite, "
          f"cache shapes ok", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), _moe_spans(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, batch, cfg)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    split = prefill_split(prof)
    if split["total"] > 0:
        print(f"prefill {arch} device time by part (torch.profiler): " + ", ".join(
            f"{k} {v:.3f} ms ({v / split['total']:.3f})" for k, v in split.items()
            if k != "total") + f"; total {split['total']:.3f} ms of a "
            f"{prof_wall:.3f} ms profiled wall (device idle share "
            f"{max(0.0, 1 - split['total'] / prof_wall):.4f})", flush=True)
    else:
        print(f"prefill {arch} device time by part: the profiler saw no "
              f"device time (not measured)", flush=True)
    del prof
    result = {"prefill_ms": ms2, "first_prefill_ms": ms1, "tokens_per_s":
              ntok / ms2 * 1e3, "bound_ms": bound_ms, "fa": counts["fa"],
              "split": split}

    if cfg.family == "moe":
        del cache
        eng, _ = serve_requests(cfg, params, dev, np.random.default_rng(0))
        result["serve_tokens_per_s"] = eng.last_report.gauges["serve.tokens_per_s"]
        del eng
    else:
        # decode steps after the prefill, the cache grown by FAMILY_DECODE rows
        cache = _pad_cache(cache, FAMILY_DECODE)
        steps = family_batch(cfg, B, FAMILY_DECODE, FAMILY_SEED + 1, dev)
        if cfg.family == "vlm":
            steps["vision_embeds"] = batch["vision_embeds"]
        before = read_counts()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(FAMILY_DECODE):
                logits, cache = decode_step(params, _step_batch(steps, t), cache,
                                            S + t, cfg)
                check(tuple(logits.shape) == want, f"{arch} decode logits shape")
            torch.cuda.synchronize()
            dec = (time.perf_counter() - t0) / FAMILY_DECODE
        check(read_counts() == before, f"{arch} decode launched a kernel")
        check(bool(torch.isfinite(logits).all()), f"{arch} decode logits not finite")
        result["decode_ms"] = dec * 1e3
        print(f"decode {arch} after the prefill: {FAMILY_DECODE} steps at "
              f"batch {B}, {dec * 1e3:.3f} ms/step, logits {want} finite, no "
              f"kernel (plain PyTorch, as in the reference)", flush=True)
        del cache

    # consistency at the check's depth: the bf16 model's logits first
    cfg_c = base.replace(n_layers=run["consist_layers"])
    prompt = family_batch(cfg_c, 1, run["consist_s"], FAMILY_SEED + 2, dev)
    if cfg_c.n_layers != cfg.n_layers:
        del params
        torch.cuda.empty_cache()
        params = init_params(cfg_c, 0, device=dev)
    with torch.no_grad():
        bf16_logits = prefill(params, prompt, cfg_c)[0]
    del params
    torch.cuda.empty_cache()
    consistency(dev, cfg_c, prompt, bf16_logits,
                {"sw": 0, "fa": cfg_c.n_layers, "ssd": 0})
    torch.cuda.empty_cache()
    return result


def phase_families(dev):
    """Phase 9: the moe, vlm and audio families at full width."""
    t_phase = time.perf_counter()
    results = {}
    for arch, run in FAMILY_RUNS.items():
        t0 = time.perf_counter()
        results[arch] = family_main_path(dev, arch, run)
        print(f"family {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"families phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


# phase 10: training.  Phi-3-mini-3.8B at full width (all 32 layers, bf16
# parameters, f32 moments, remat on) through ``launch.train.train``:
# TRAIN_STEPS steps of 2 x 4096 tokens from SyntheticLM seed 0, the first a
# warm-up, the last profiled, no checkpoint directory.  Then the f32
# gradient check and the restart at a cut depth of 2 layers (full width).
TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_B, TRAIN_S = 2, 4096
TRAIN_STEPS = 5               # step 0 warm-up, steps 1-3 timed, step 4 profiled
TRAIN_TIMED = (1, 2, 3)
TRAIN_PROFILED = 4
# f32 gradients of one train step through the FA kernels (forward and
# backward) against the same step with naive attention under autograd,
# 2 layers, 1 x 2048 tokens: every leaf within TRAIN_GRAD_TOL of its own
# largest |g|.  Sums run in other orders through two layers, the loss
# chunks and the optimizer's clip; the bf16 step misses it (checked).
TRAIN_GRAD_TOL = 1e-3
TRAIN_CUT = dict(layers=2, batch=1, seq=2048)
RESTART = dict(steps=5, ckpt_every=2, fail_at=3)
RESTART_TOL = 1e-4            # final loss, restarted against uninterrupted
FA_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
FA_BWD_KERNELS = 3            # kernels a backward launch runs (both dtypes)
# The bf16 forward's saved statistics (m in base 2, 1/l) against
# fa_stats_plain (f32 products of the same inputs): the sums run in
# another order and exp2 is the approximate one.
STATS_TOL = 1e-5
# The JAX package has no backward kernel: XLA differentiates the model's
# chunked_attention, whose gradient this kernel computes on the card.
FA_BWD_REPLACES = "src/repro/models/attention.py:81"
FA_BWD_SHAPE = (TRAIN_B, 32, 32, TRAIN_S, TRAIN_S, 96, True, None)
FA_BWD_MAIN = (*FA_BWD_SHAPE[:6], FA_BWD_SHAPE[7], 0, FA_BWD_SHAPE[6])
# The backward kernel's edges (B, H, Hkv, S, T, D, window, q_offset,
# causal): every head dim, GQA and MQA, a window, S < T with q_offset,
# S > T, the vision cross-attention's T = 1601, rows whose every key is
# masked (q_offset < 0; a window past T), and Phi-3's shape, each in f32
# and bf16.
FA_BWD_EDGES = [
    *[(1, 2, 1, 129, 200, d, None, 0, True) for d in (16, 32, 48, 64, 80,
                                                      96, 112, 128)],
    (2, 4, 2, 96, 160, 32, None, 0, True),
    (1, 8, 1, 128, 128, 64, None, 0, True),
    (2, 4, 4, 1, 1, 80, None, 0, True),
    (1, 4, 4, 200, 200, 96, 48, 0, True),
    (1, 2, 1, 77, 300, 128, None, 223, True),
    (1, 4, 4, 300, 77, 128, None, 0, True),
    (1, 2, 2, 100, 1601, 80, None, 0, False),
    (1, 2, 1, 70, 70, 16, None, -3, True),
    (1, 2, 2, 300, 100, 16, 30, 0, False),
    FA_BWD_MAIN,
]
# At Phi-3's shape in bf16, each gradient is also held to BF16_GRAD_REL of
# its own largest |plain| (one bf16 ulp of that element is at most 2^-7 of
# it) and to BF16_GRAD_REL in relative L2 norm.  FA_TOL's 2e-2 absolute
# term is about a typical |dv| there, so alone it would let half of dv go
# unchecked; the L2 norm would see such a half wrong at about 0.3.
BF16_GRAD_REL = 1e-2
TRAIN_SPANS = ("train.adamw", "train.ce")    # profiler ranges of the step split
# The SSD backward (eight CUDA kernels per call, counted as one launch)
# against ssd_backward_plain on SSD_CASES, both x dtypes and both compute
# dtypes: each gradient within SSD_TOL of its own max |plain| (float64 plain
# at chunks over SSD_WITNESS_CHUNK with f32 products), plus, where the
# gradient is stored in bf16 (dx, dB, dC of bf16 inputs), one bf16 spacing
# of the element, 2^-7 of |plain|: two f32 values a rounding apart can round
# to neighbouring bf16 values.  The JAX package has no backward kernel: XLA
# differentiates the model's ssd_chunked.
SSD_BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
SSD_BWD_REPLACES = "src/repro/models/ssm.py:66"
PEAK_TF32 = 495e12            # H100 SXM dense TF32 tensor-core rate, FLOP/s
BF16_SPACING = 2.0 ** -7
SSD_BWD_KERNEL = re.compile(r"ssd_bwd_\w*kernel")
SSD_BWD_SHAPE = (PREFILL_B, PREFILL_S, 80, 64, 64, 256)   # Zamba2's: b, T, H, P, N, chunk
# Zamba2-2.7B trained at full width (all 54 layers) as Phi-3 is; its f32
# gradient check at one group's depth (5 Mamba2 blocks and the shared
# attention block), full width, 1 x 2048 tokens, against ssd_plain and naive
# attention under autograd within TRAIN_GRAD_TOL.
HYBRID_ARCH = MAIN_ARCH
HYBRID_CUT = dict(layers=6, batch=1, seq=2048)


def free_device_memory():
    """Return what earlier models left to the card: the allocator's cached
    blocks.  A finished ``ServeEngine`` goes with its last reference (its
    serving graph holds it weakly); the collector still runs first, for
    any other cycle an earlier phase may have left around a tensor."""
    gc.collect()
    torch.cuda.empty_cache()


def _bwd_inputs(dev, dtype, B, H, Hkv, S, T, D, seed):
    """q, k, v, do as (B, H, rows, D) views of the model's (B, rows, H, D)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
             .transpose(1, 2) for _ in range(2))
    k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).to(dtype)
            .transpose(1, 2) for _ in range(2))
    return q, k, v, do


def _bf16_main_check(got, want):
    """Each bf16 gradient at Phi-3's shape against BF16_GRAD_REL of its own
    largest |plain| and in relative L2; returns the numbers, dv's median
    |plain| beside its limit."""
    out = {}
    for name, g, w in zip("qkv", got, want):
        g, w = g.float(), w.float()
        err = float((g - w).abs().max())
        limit = BF16_GRAD_REL * float(w.abs().max())
        rel_l2 = float((g - w).norm() / w.norm())
        median = float(w.abs().median())
        print(f"fa backward at Phi-3's shape, bf16 d{name}: max |diff| "
              f"{err:.3e} against the limit {limit:.3e} ({BF16_GRAD_REL} of "
              f"max |plain|), median |plain| {median:.3e}; relative L2 "
              f"{rel_l2:.3e} (limit {BF16_GRAD_REL})", flush=True)
        check(err <= limit and rel_l2 <= BF16_GRAD_REL,
              f"FA backward bf16 d{name} at Phi-3's shape: max |diff| {err} "
              f"(limit {limit}), relative L2 {rel_l2} (limit {BF16_GRAD_REL})")
        out.update({f"bf16 d{name} limit": limit, f"bf16 d{name} rel_l2": rel_l2,
                    f"bf16 d{name} median_abs": median})
    return out


def _bwd_split(call, reps=50):
    """(each backward kernel's share of the profiled device time, the
    profiled device ms of the ``reps`` calls) from torch.profiler.  A
    window of a few calls can lose most of its device records, so the
    window is long and the caller reports the coverage beside the shares."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        name = re.search(r"fa_bwd_\w*kernel", ev.key)
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        if name and us:
            split[name.group()] = split.get(name.group(), 0.0) + us
    total = sum(split.values())
    return {name: us / total for name, us in split.items()}, total / 1e3


def phase_fa_backward(dev, fa):
    """The FA backward kernel against fa_backward_plain on its edges (both
    dtypes; bf16 through the wgmma kernels with the statistics the forward
    saved) and at Phi-3's shape, where the forward's statistics are also
    held against fa_stats_plain; then kernel, plain, bound and library
    (SDPA's backward through autograd) times at that shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_o = 0.0
    main = {}
    cases = [(dt, e) for e in FA_BWD_EDGES for dt in (torch.float32, torch.bfloat16)]
    for i, (dtype, edge) in enumerate(cases):
        B, H, Hkv, S, T, D, window, q_offset, causal = edge
        q, k, v, do = _bwd_inputs(dev, dtype, B, H, Hkv, S, T, D, 70 + i)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        if dtype == torch.bfloat16:
            # the forward instance that writes the statistics (the train
            # step's) is held to the plain forward over the same tiles and
            # to the inference instance, bit for bit
            o, stats = fa.fa_forward_with_stats(q, k, v, **kw)
            o_plain = fa.fa_plain(q, k, v, kv_tile=fa.KV_TILE[dtype], **kw)
            same = torch.equal(o, fa.flash_attention(q, k, v, **kw))
            oerr, ook = within(o, o_plain, FA_TOL[dtype])
            check(ook and same,
                  f"FA forward writing the statistics at B={B} H={H} "
                  f"Hkv={Hkv} S={S} T={T} D={D} window={window} "
                  f"q_offset={q_offset} causal={causal}: o against fa_plain "
                  f"max |diff| {oerr} (tol 2e-2 + 2e-2*|plain|), equal to "
                  f"the inference launch: {same}")
            worst_o = max(worst_o, oerr)
            if edge == FA_BWD_MAIN:
                main["bf16 o"] = oerr
            del o_plain
        else:
            o, stats = fa.flash_attention(q, k, v, **kw), None
        got = fa.fa_backward(q, k, v, o, do, stats=stats, **kw)
        want = fa.fa_backward_plain(q, k, v, o, do, kv_tile=fa.KV_TILE[dtype], **kw)
        torch.cuda.synchronize()
        for name, g, w, x in zip("qkv", got, want, (q, k, v)):
            err, ok = within(g, w, FA_TOL[dtype])
            check(ok and g.dtype == x.dtype and g.stride() == x.stride(),
                  f"FA backward d{name} != plain at B={B} H={H} Hkv={Hkv} S={S} "
                  f"T={T} D={D} window={window} q_offset={q_offset} "
                  f"causal={causal} {dtype}: {err}")
            key = str(dtype).split(".")[1]
            worst[key] = max(worst[key], err)
            if edge == FA_BWD_MAIN:
                main[f"{key} d{name}"] = err
        if edge == FA_BWD_MAIN and dtype == torch.bfloat16:
            main.update(_bf16_main_check(got, want))
            plain_stats = fa.fa_stats_plain(q, k, kv_tile=fa.KV_TILE[dtype], **kw)
            serr, sok = within(stats, plain_stats, STATS_TOL)
            print(f"fa forward statistics at Phi-3's shape (m in base 2, 1/l, "
                  f"{stats.numel()} values) against fa_stats_plain: max |diff| "
                  f"{serr:.3e} (tol {STATS_TOL} + {STATS_TOL}*|plain|)", flush=True)
            check(sok, f"FA forward statistics != plain at Phi-3's shape: {serr}")
            main["bf16 stats"] = serr
            del plain_stats
        del q, k, v, do, o, got, want, stats
    print(f"fa backward kernel == plain on {len(cases)} cases (every head dim, "
          f"GQA/MQA, window, q_offset, S > T, T = 1601, rows with every key "
          f"masked, and Phi-3's shape), gradients in the inputs' dtypes and "
          f"layouts; max |err| f32 {worst['float32']:.3e} (tol 2e-5 + "
          f"2e-5*|plain|, SIMT), bf16 {worst['bfloat16']:.3e} (tol 2e-2 + "
          f"2e-2*|plain|, wgmma)", flush=True)
    print(f"fa forward writing the statistics == plain on the "
          f"{len(FA_BWD_EDGES)} bf16 cases (Phi-3's shape included): o max "
          f"|err| {worst_o:.3e} against fa_plain over the kernel's kv tiles "
          f"(tol 2e-2 + 2e-2*|plain|), and equal bit for bit to the "
          f"inference launch on every case", flush=True)

    B, H, Hkv, S, T, D, causal, window = FA_BWD_SHAPE
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, B, H, Hkv, S, T, D, 9)
    o, stats = fa.fa_forward_with_stats(q, k, v, causal=causal)
    fwd = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                  iters=10, warmup=2)
    fwd_stats = cuda_ms(lambda: fa.fa_forward_with_stats(q, k, v, causal=causal),
                        iters=10, warmup=2)
    kern = cuda_ms(lambda: fa.fa_backward(q, k, v, o, do, causal=causal,
                                          stats=stats), iters=10, warmup=2)
    plain = cuda_ms(lambda: fa.fa_backward_plain(
        q, k, v, o, do, causal=causal, kv_tile=fa.KV_TILE[torch.bfloat16],
        stats=stats), iters=2, warmup=1)
    split_reps = 50
    split, prof_ms = _bwd_split(lambda: fa.fa_backward(
        q, k, v, o, do, causal=causal, stats=stats), split_reps)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_ms, reps = 0.0, 5
    for i in range(reps + 1):
        out = sdpa(*leaves, is_causal=True)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out.backward(do)
        stop.record()
        torch.cuda.synchronize()
        if i:                          # the first is a warm-up
            lib_ms += start.elapsed_time(stop) / reps
        for t in leaves:
            t.grad = None
    pairs = fa_pairs(S, T, causal, window)
    flop = 5 * 2 * B * H * D * pairs
    flop7 = 7 * 2 * B * H * D * pairs
    t_ops = flop / PEAK_BF16
    nbytes = 2 * (3 * B * H * S * D + 2 * B * Hkv * T * D     # q, o, do; k, v
                  + B * H * S * D + 2 * B * Hkv * T * D)      # dq; dk, dv
    t_bytes = nbytes / PEAK_BYTES
    row = dict(ms=kern, plain_ms=plain, library_ms=lib_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               err=max(worst.values()), worst=worst, main_shape=main,
               forward_with_stats_err=worst_o,
               split_share=split, split_coverage=prof_ms / (split_reps * kern),
               forward_ms=fwd, forward_with_stats_ms=fwd_stats,
               tflops_7=flop7 / (kern * 1e-3) / 1e12,
               shape=f"B={B} H={H} Hkv={Hkv} S={S} T={T} D={D} causal bf16")
    print(f"timing fa backward {row['shape']}: kernel {kern:.4f} ms (one "
          f"launch of {FA_BWD_KERNELS} kernels, wgmma), plain {plain:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: 5 products, "
          f"{flop / 1e9:.2f} GFLOP at 989 TFLOP/s bf16; bytes "
          f"{t_bytes * 1e3:.4f} ms), {row['tflops_7']:.2f} TFLOP/s of the 7 "
          f"products it runs ({flop7 / 1e9:.2f} GFLOP), "
          f"{flop / (kern * 1e-3) / 1e12:.2f} TFLOP/s of the 5, "
          f"{row['bound_ms'] / kern:.4f} of the 5-product bound; library "
          f"scaled_dot_product_attention(is_causal=True) backward through "
          f"autograd {lib_ms:.4f} ms (the kernel takes {kern / lib_ms:.2f}x "
          f"its time)", flush=True)
    print(f"fa backward kernels at Phi-3's shape (share of the device time "
          f"torch.profiler saw over {split_reps} calls, "
          f"{prof_ms / (split_reps * kern):.4f} of their event-timed "
          f"{split_reps * kern:.3f} ms; times the event-timed "
          f"call): " + (", ".join(
              f"{n} {share:.4f} ({share * kern:.4f} ms)"
              for n, share in split.items())
              or "no device time seen (not measured)")
          + f"; forward {fwd:.4f} ms without the statistics, "
          f"{fwd_stats:.4f} ms writing them", flush=True)
    del q, k, v, do, o, stats, leaves, out
    torch.cuda.empty_cache()
    return row


def train_flops(cfg, B, S, params):
    """(FLOPs at the bf16 rate, FLOPs at the f32 rate) of one train step:
    6 x the parameters as applied (a block shared by several layers counted
    once a use; the embeddings included) x tokens plus the attention's
    forward (2) and backward (5) products of 2·D flops per unmasked pair, on
    the tensor cores; the SSD scan's forward and backward products on the
    f32 pipes, where its kernels run.  The remat recompute not counted."""
    from repro_torch.models import param_count
    from repro_torch.tree import tree_leaves
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("attn", "attn_shared") for k in kinds)
    n_ssm = sum(k == "ssm" for k in kinds)
    applied = param_count(cfg)
    if "shared_attn" in params:
        uses = sum(k == "attn_shared" for k in kinds)
        applied += (uses - 1) * sum(t.numel() for t in tree_leaves(params["shared_attn"]))
    pairs = fa_pairs(S, S, True, cfg.sliding_window)
    attn = 7 * 2 * cfg.hdim * pairs * B * cfg.n_heads * n_attn
    shape = (B, S, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
             min(cfg.ssm_chunk, S)) if n_ssm else None
    ssd_f32 = n_ssm * (ssd_fwd_flops(*shape) + ssd_bwd_flops(*shape)) if n_ssm else 0
    return 6 * applied * B * S + attn, ssd_f32, applied


def _timed_train_steps(record):
    """A ``wrap_step`` for ``launch.train.train``: each step timed by CUDA
    events and the host clock (the host's enqueue, then the wall to a
    synchronise), its FA and SSD launch counts, and step TRAIN_PROFILED under
    torch.profiler, where the program's own ranges (TRAIN_SPANS) mark the
    optimizer update and the cross entropy (forward and its recompute)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    def wrap(step_fn):
        def timed(params, opt, batch):
            i = len(record)
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
                if i == TRAIN_PROFILED else contextlib.nullcontext()
            f0, b0 = fa.launch_count(), fa.bwd_launch_count()
            s0, sb0 = ssd.launch_count(), ssd.bwd_launch_count()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            with prof:
                t0 = time.perf_counter()
                start.record()
                out = step_fn(params, opt, batch)
                stop.record()
                enq = time.perf_counter() - t0
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            record.append(dict(ms=start.elapsed_time(stop), enqueue_ms=enq * 1e3,
                               wall_ms=wall * 1e3, fa=fa.launch_count() - f0,
                               fa_bwd=fa.bwd_launch_count() - b0,
                               ssd=ssd.launch_count() - s0,
                               ssd_bwd=ssd.bwd_launch_count() - sb0,
                               metrics={k: float(v) for k, v in out[2].items()},
                               prof=prof if i == TRAIN_PROFILED else None))
            return out
        return timed
    return wrap


def train_split(prof):
    """One profiled train step's device time (ms) by part: FA forward (and
    its remat recompute), FA backward, the SSD forward (and its recompute)
    and backward, the optimizer update, the cross entropy's forward and
    recompute (its backward GEMMs count as GEMMs, its elementwise backward
    as the rest), the other GEMMs, the rest."""
    kernels = [(ev.name, ev.device_time_total) for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.name not in TRAIN_SPANS]
    total = sum(us for _, us in kernels) / 1e3
    fa_fwd = sum(us for n, us in kernels if "fa_kernel" in n
                 or "fa_wgmma_kernel" in n) / 1e3
    fa_bwd = sum(us for n, us in kernels if "fa_bwd_" in n) / 1e3
    ssd_bwd = sum(us for n, us in kernels if SSD_BWD_KERNEL.search(n)) / 1e3
    ssd_fwd = sum(us for n, us in kernels if SSD_KERNEL.search(n)) / 1e3 - ssd_bwd
    gemm = sum(us for n, us in kernels
               if any(g in n.lower() for g in GEMM_NAMES)) / 1e3
    spans = {name: [] for name in TRAIN_SPANS}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU and ev.name in spans:
            spans[ev.name] += list(_kernels_under(ev))
    if total > 0:
        check(all(spans.values()), f"profiled train step: no kernel under "
              f"the ranges {[n for n, k in spans.items() if not k]}")
    opt_ms = sum(us for _, us in spans[TRAIN_SPANS[0]]) / 1e3
    ce_ms = sum(us for _, us in spans[TRAIN_SPANS[1]]) / 1e3
    ce_gemm = sum(us for n, us in spans[TRAIN_SPANS[1]]
                  if any(g in n.lower() for g in GEMM_NAMES)) / 1e3
    other_gemm = gemm - ce_gemm
    return {"total": total, "GEMMs": other_gemm, "FA forward": fa_fwd,
            "FA backward": fa_bwd, "SSD forward": ssd_fwd,
            "SSD backward": ssd_bwd, "optimizer update": opt_ms,
            "cross-entropy": ce_ms,
            "rest": total - other_gemm - fa_fwd - fa_bwd - ssd_fwd - ssd_bwd
            - opt_ms - ce_ms}


def _grad_tree(params, batch, cfg):
    """(loss, [grad per leaf]) as the train step takes them."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.tree import tree_leaves
    loss, _, grads = loss_and_grads(params, batch, cfg)
    return float(loss), tree_leaves(grads)


def _worst_leaf(grads, want):
    """The worst leaf's max |g - w| / max |w|."""
    out = 0.0
    for g, w in zip(grads, want):
        out = max(out, float((g.float() - w).abs().max())
                  / max(float(w.abs().max()), 1e-30))
    return out


def train_consistency(dev, base):
    """f32 gradients of one step through the kernels against naive
    attention under autograd, 2 layers at full width; the bf16 step must
    miss the limit."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params
    cfg = base.replace(n_layers=TRAIN_CUT["layers"], dtype="float32")
    np_batch = SyntheticLM(cfg, TRAIN_CUT["batch"], TRAIN_CUT["seq"], seed=1)(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
    params = init_params(cfg, 0, device=dev)
    f0, b0 = fa.launch_count(), fa.bwd_launch_count()
    loss_k, g_k = _grad_tree(params, batch, cfg)
    torch.cuda.synchronize()
    launched = (fa.launch_count() - f0, fa.bwd_launch_count() - b0)
    check(launched == (2 * cfg.n_layers, cfg.n_layers),
          f"f32 train step launched fa {launched}, expected "
          f"({2 * cfg.n_layers}, {cfg.n_layers})")
    loss_n, g_n = _grad_tree(params, batch, cfg.replace(attn_impl="naive"))
    check(fa.launch_count() - f0 == 2 * cfg.n_layers,
          "the naive step launched the FA kernel")

    err32 = _worst_leaf(g_k, g_n)
    del params, g_k
    torch.cuda.empty_cache()
    p16 = init_params(cfg.replace(dtype="bfloat16"), 0, device=dev)
    loss_16, g_16 = _grad_tree(p16, batch, cfg.replace(dtype="bfloat16"))
    err16 = _worst_leaf(g_16, g_n)
    del p16, g_16, g_n
    torch.cuda.empty_cache()
    print(f"train consistency {cfg.name} ({cfg.n_layers} layers, full width) "
          f"f32, {TRAIN_CUT['batch']} x {TRAIN_CUT['seq']} tokens: gradients "
          f"through the FA kernels (forward {2 * cfg.n_layers} launches with "
          f"the remat recompute, backward {cfg.n_layers}) against naive "
          f"attention under autograd, worst leaf max |diff| / max |g| "
          f"{err32:.3e} (tol {TRAIN_GRAD_TOL}); losses {loss_k:.6f} / "
          f"{loss_n:.6f}; the bf16 step is {err16:.3e} from the f32 naive "
          f"gradients (loss {loss_16:.6f}), so bf16 fails the tolerance",
          flush=True)
    check(err32 <= TRAIN_GRAD_TOL,
          f"f32 kernel gradients vs naive: {err32} > {TRAIN_GRAD_TOL}")
    check(err16 > TRAIN_GRAD_TOL,
          f"bf16 gradients {err16} within {TRAIN_GRAD_TOL}: the tolerance "
          f"would not catch bf16")
    return err32, err16


def hybrid_train_consistency(dev, base):
    """f32 gradients of one Zamba2 step at one group's depth (full width)
    through the SSD and FA kernels, forward and backward, against the same
    step with ssd_plain and naive attention under autograd; the bf16 step
    must miss the limit."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import init_params
    cfg = base.replace(n_layers=HYBRID_CUT["layers"], dtype="float32")
    kinds = cfg.layer_kinds()
    n_attn, n_ssm = kinds.count("attn_shared"), kinds.count("ssm")
    np_batch = SyntheticLM(cfg, HYBRID_CUT["batch"], HYBRID_CUT["seq"], seed=1)(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
    params = init_params(cfg, 0, device=dev)

    def launched():
        return (fa.launch_count(), fa.bwd_launch_count(), ssd.launch_count(),
                ssd.bwd_launch_count())

    c0 = launched()
    loss_k, g_k = _grad_tree(params, batch, cfg)
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(launched(), c0))
    want = (2 * n_attn, n_attn, 2 * n_ssm, n_ssm)
    check(counts == want, f"f32 zamba2 step launched (fa, fa backward, ssd, "
          f"ssd backward) {counts}, expected {want}")
    c1 = launched()
    with _plain_versions():
        loss_n, g_n = _grad_tree(params, batch, cfg.replace(attn_impl="naive"))
    check(launched() == c1, "the plain step launched a kernel")
    err32 = _worst_leaf(g_k, g_n)
    del params, g_k
    torch.cuda.empty_cache()
    p16 = init_params(cfg.replace(dtype="bfloat16"), 0, device=dev)
    loss_16, g_16 = _grad_tree(p16, batch, cfg.replace(dtype="bfloat16"))
    err16 = _worst_leaf(g_16, g_n)
    del p16, g_16, g_n
    torch.cuda.empty_cache()
    print(f"train consistency {cfg.name} ({cfg.n_layers} layers: {n_ssm} Mamba2 "
          f"blocks and the shared attention block, full width) f32, "
          f"{HYBRID_CUT['batch']} x {HYBRID_CUT['seq']} tokens: gradients "
          f"through the SSD kernels (forward {2 * n_ssm} launches with the remat "
          f"recompute, backward {n_ssm}) and the FA kernels against ssd_plain "
          f"and naive attention under autograd, worst leaf max |diff| / max "
          f"|g| {err32:.3e} (tol {TRAIN_GRAD_TOL}); losses {loss_k:.6f} / "
          f"{loss_n:.6f}; the bf16 step is {err16:.3e} from the f32 plain "
          f"gradients (loss {loss_16:.6f}), so bf16 fails the tolerance",
          flush=True)
    check(err32 <= TRAIN_GRAD_TOL,
          f"f32 zamba2 kernel gradients vs plain: {err32} > {TRAIN_GRAD_TOL}")
    check(err16 > TRAIN_GRAD_TOL,
          f"bf16 zamba2 gradients {err16} within {TRAIN_GRAD_TOL}: the "
          f"tolerance would not catch bf16")
    return err32, err16


def train_restart(dev, base):
    """train() with checkpoints every RESTART['ckpt_every'] steps and an
    injected failure, then again from the checkpoint: the final loss must
    equal an uninterrupted run's."""
    import shutil
    import tempfile
    from repro_torch.launch.train import train
    from repro_torch.runtime import latest_step
    cfg = base.replace(n_layers=TRAIN_CUT["layers"])
    kw = dict(steps=RESTART["steps"], batch=TRAIN_CUT["batch"],
              seq=TRAIN_CUT["seq"], seed=0, log_every=100, device=dev)
    _, losses_a = train(cfg, ckpt_dir=None, **kw)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        try:
            train(cfg, ckpt_dir=tmp, ckpt_every=RESTART["ckpt_every"],
                  inject_failure_at=RESTART["fail_at"], **kw)
            check(False, "the injected failure did not raise")
        except RuntimeError as e:
            check("injected" in str(e), f"train failed otherwise: {e}")
        t_fail = time.perf_counter() - t0
        last = latest_step(tmp)
        check(last == RESTART["ckpt_every"], f"latest checkpoint {last}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _, losses_b = train(cfg, ckpt_dir=tmp, ckpt_every=100, **kw)
        t_resume = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*.npz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    err = abs(losses_a[-1] - losses_b[-1])
    print(f"train restart {cfg.name} ({cfg.n_layers} layers, full width, bf16, "
          f"f32 moments): {RESTART['steps']} steps of {TRAIN_CUT['batch']} x "
          f"{TRAIN_CUT['seq']}; failure injected at step {RESTART['fail_at']} "
          f"after the checkpoint at step {last} ({t_fail:.1f} s), resumed "
          f"({t_resume:.1f} s, {len(losses_b)} steps, {nbytes / 1e9:.2f} GB "
          f"of npz written in all); final loss {losses_b[-1]:.6f} against "
          f"{losses_a[-1]:.6f} uninterrupted, |diff| {err:.3e} (tol "
          f"{RESTART_TOL})", flush=True)
    check(len(losses_b) == RESTART["steps"] - last, "resumed the wrong step")
    check(err <= RESTART_TOL, f"restart final loss off by {err}")
    return err


def _ssd_grad_err(got, want):
    """(each gradient's max |got - want| / max |want|, less one bf16 spacing
    of the element where the gradient is stored in bf16; the largest
    max |got - want| of them; whether every value is finite)."""
    errs, abs_err, finite = {}, 0.0, True
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        if w is None:
            continue
        finite &= bool(torch.isfinite(g).all())
        diff = (g.double() - w.double()).abs()
        abs_err = max(abs_err, float(diff.max()))
        if g.dtype == torch.bfloat16:
            diff = (diff - BF16_SPACING * w.double().abs()).clamp(min=0)
        errs[name] = float(diff.max()) / max(float(w.abs().max()), 1e-30)
    return errs, abs_err, finite


def _ssd_inputs(dev, b, T, H, P, N, dtype, seed, with_h0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, T, H, P), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, T, H), generator=g,
                                                  device=dev)) * 0.1
    A = -torch.exp(torch.randn((H,), generator=g, device=dev))
    Bm, Cm = (torch.randn((b, T, N), generator=g, device=dev).to(dtype)
              for _ in range(2))
    h0 = torch.randn((b, H, P, N), generator=g, device=dev) if with_h0 else None
    dy = torch.randn((b, T, H, P), generator=g, device=dev)
    dh = torch.randn((b, H, P, N), generator=g, device=dev) if with_h0 else None
    return x, dt, A, Bm, Cm, h0, dy, dh


def phase_ssd_backward(dev, ssd):
    """The SSD backward kernels against ssd_backward_plain on SSD_CASES
    (both x dtypes, both compute dtypes; a cotangent on y and, with h0, on
    the final state), then kernel, per-kernel, plain and bound times at
    Zamba2's shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {"compute_float32": 0.0, "compute_bfloat16": 0.0}
    worst_abs = dict(worst)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for cd in (torch.float32, torch.bfloat16):
            for i, (b, T, H, P, N, l, with_h0) in enumerate(SSD_CASES):
                x, dt, A, Bm, Cm, h0, dy, dh = _ssd_inputs(
                    dev, b, T, H, P, N, dtype, 90 + i, with_h0)
                _, _, scratch = ssd.ssd_forward_with_scratch(
                    x, dt, A, Bm, Cm, chunk=l, h0=h0, compute_dtype=cd)
                got = ssd.ssd_backward(x, dt, A, Bm, Cm, l, dy, scratch,
                                       dh_final=dh, h0=h0, compute_dtype=cd)
                witness = cd == torch.float32 and l > SSD_WITNESS_CHUNK
                want = ssd.ssd_backward_plain(
                    x, dt, A, Bm, Cm, l, dy, dh_final=dh, h0=h0,
                    compute_dtype=torch.float64 if witness else cd)
                torch.cuda.synchronize()
                errs, abs_err, finite = _ssd_grad_err(got, want)
                err = max(errs.values())
                check(finite and err <= SSD_TOL[cd] and
                      [t.dtype for t in got[:5]] == [dtype, torch.float32,
                                                     torch.float32, dtype, dtype],
                      f"SSD backward != plain{' (f64)' if witness else ''} at "
                      f"{(b, T, H, P, N, l, with_h0)} x {dtype} compute {cd}: "
                      f"{errs} (tol {SSD_TOL[cd]} of each max |plain|)")
                key = "compute_" + str(cd).removeprefix("torch.")
                worst[key] = max(worst[key], err)
                worst_abs[key] = max(worst_abs[key], abs_err)
                n += 1
                del x, dt, A, Bm, Cm, h0, dy, dh, scratch, got, want
    print(f"ssd backward kernel == plain on {n} cases (f64 plain for f32 "
          f"products at chunks over {SSD_WITNESS_CHUNK}; dh with h0): worst "
          f"max |diff| / max |plain| over dx, ddt, dA, dB, dC, dh0: f32 "
          f"products {worst['compute_float32']:.3e} (tol 1e-4), bf16 products "
          f"{worst['compute_bfloat16']:.3e} (tol 5e-2), less one bf16 spacing "
          f"(2^-7 |plain|) where the gradient is stored in bf16; largest max "
          f"|diff| {worst_abs['compute_float32']:.3e} (f32 products), "
          f"{worst_abs['compute_bfloat16']:.3e} (bf16)", flush=True)

    b, T, H, P, N, l = SSD_BWD_SHAPE
    x, dt, A, Bm, Cm, _, dy, _ = _ssd_inputs(dev, b, T, H, P, N, torch.bfloat16,
                                             7, False)
    fwd = cuda_ms(lambda: ssd.ssd_forward_with_scratch(x, dt, A, Bm, Cm, chunk=l),
                  iters=10, warmup=2)
    _, _, scratch = ssd.ssd_forward_with_scratch(x, dt, A, Bm, Cm, chunk=l)
    got = ssd.ssd_backward(x, dt, A, Bm, Cm, l, dy, scratch)
    want = ssd.ssd_backward_plain(x, dt, A, Bm, Cm, l, dy)
    torch.cuda.synchronize()
    errs, main_abs, finite = _ssd_grad_err(got, want)
    check(finite and max(errs.values()) <= SSD_TOL[torch.float32],
          f"SSD backward != plain at Zamba2's shape: {errs}")
    del got, want

    def call():
        return ssd.ssd_backward(x, dt, A, Bm, Cm, l, dy, scratch)
    kern = cuda_ms(call, iters=10, warmup=2)
    plain = cuda_ms(lambda: ssd.ssd_backward_plain(x, dt, A, Bm, Cm, l, dy),
                    iters=2, warmup=1)
    from torch.profiler import ProfilerActivity, profile
    reps = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        m = SSD_BWD_KERNEL.search(ev.key)
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        if m and us:
            split[m.group()] = split.get(m.group(), 0.0) + us / 1e3 / reps
    flops = ssd_bwd_flops(b, T, H, P, N, l)
    tf32 = ssd_bwd_tf32_flops(b, T, H, P, N, l, x.dtype, Bm.dtype)
    done = ssd_bwd_kernel_flops(b, T, H, P, N, l)
    t_f32 = flops / PEAK_F32                          # the same work on the SIMT pipes
    t_ops = tf32 / PEAK_TF32                          # as the kernels run it: 3xTF32
    nc = T // l
    nbytes = (2 * x.numel() * 2 + dt.numel() * 4 * 2 + A.numel() * 4 * 2
              + 4 * Bm.numel() * 2 + dy.numel() * 4     # x, dx; dt, ddt; A, dA; B, C, dB, dC; dy
              + b * H * T * 8 + b * nc * l * l * 4 + b * nc * H * N * P * 4)  # cs, CBᵀ, states
    t_bytes = nbytes / PEAK_BYTES
    row = dict(ms=kern, plain_ms=plain, library_ms=None,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_f32_ms=max(t_f32, t_bytes) * 1e3, tf32_gflop=tf32 / 1e9,
               err=max(*worst_abs.values(), main_abs), worst=worst_abs,
               rel_err=max(*worst.values(), *errs.values()), worst_rel=worst,
               main_shape=errs, split=split, forward_with_scratch_ms=fwd,
               tflops=flops / (kern * 1e-3) / 1e12,
               kernel_tflops=done / (kern * 1e-3) / 1e12,
               shape=f"b={b} T={T} H={H} P={P} N={N} chunk={l} x bf16, f32 products")
    print(f"timing ssd backward {row['shape']}: kernel {kern:.4f} ms (one "
          f"launch of {len(ssd.BWD_KERNELS)} kernels), plain {plain:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: 3xTF32, "
          f"{tf32 / 1e9:.2f} GFLOP of TF32 terms, 2 a product with a bf16 "
          f"operand and 3 with two f32, at 495 TFLOP/s TF32; "
          f"{nbytes / 1e6:.1f} MB {t_bytes * 1e3:.4f} ms), "
          f"{row['bound_ms'] / kern:.4f} of it; f32 SIMT bound "
          f"{row['bound_f32_ms']:.4f} ms ({flops / 1e9:.2f} GFLOP at 67 TFLOP/s "
          f"f32), {row['bound_f32_ms'] / kern:.4f} of it; {row['tflops']:.2f} "
          f"TFLOP/s of the least work, {row['kernel_tflops']:.2f} TFLOP/s of "
          f"the {done / 1e9:.2f} GFLOP the kernels do; library: none (no "
          f"PyTorch call computes it); forward with its scratch {fwd:.4f} ms; "
          f"max |diff| / max |plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    from repro_torch.kernels import _build
    log = _build.build_info("ssd_scan_bwd")[1]
    regs = {ptxas_name(k): v for k, v in _build.ptxas_usage(log).items()}
    if not regs:
        print(f"ssd backward ptxas counts not available: "
              f"{(log.splitlines() or ['no build log'])[0]}"
              f" (the library was reused without its build log)", flush=True)
    configs = ssd.backward_kernel_configs(b, T, H, P, N, l, torch.bfloat16)
    row["kernel_configs"] = {}
    for name, grid, block, smem in configs:
        inst = {k: v for k, v in regs.items() if k.split("<")[0].split("[")[0] == name}
        row["kernel_configs"][name] = dict(grid=grid, block=block, smem=smem,
                                           ptxas=inst)
        print(f"ssd backward kernel {name} at Zamba2's shape: grid {grid}, block "
              f"{block}, {smem} B dynamic shared memory; ptxas (registers, spill "
              f"stores, spill loads) " + ", ".join(
                  f"{k} {v}" for k, v in inst.items()), flush=True)
    print(f"ssd backward kernels at Zamba2's shape (torch.profiler over {reps} "
          f"calls, ms per call): " + (
              ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; sum {sum(split.values()):.4f}, "
              f"{sum(split.values()) / kern:.4f} of the event-timed call (a "
              f"long window can lose device records)" if split else
              "no device time seen (not measured)"), flush=True)
    del x, dt, A, Bm, Cm, dy, scratch
    torch.cuda.empty_cache()
    return row


def train_main_path(dev, arch, per_step):
    """``arch`` at full width through ``launch.train.train``: TRAIN_STEPS
    steps of TRAIN_B x TRAIN_S tokens from SyntheticLM seed 0, no checkpoint
    directory; every step's launches must equal ``per_step`` (fa, fa_bwd,
    ssd, ssd_bwd).  Prints each step, the mean of the timed steps, the
    share of the FLOP bound, the peak memory and the device time by part."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.train import train
    from repro_torch.models import param_count
    cfg = ARCHS[arch]
    n = param_count(cfg)
    ssm = (f", ssm heads {cfg.ssm_heads} x {cfg.ssm_headdim}, state "
           f"{cfg.ssm_state}, chunk {cfg.ssm_chunk} ({cfg.ssm_compute_dtype} "
           f"products)" if cfg.ssm_state else "")
    print(f"model {arch} (all {cfg.n_layers} layers, full width): "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads x {cfg.hdim}, d_ff "
          f"{cfg.d_ff}{ssm}, vocab {cfg.vocab_size}, {cfg.dtype} parameters, "
          f"{cfg.optimizer_dtype} moments, remat {cfg.remat}, loss chunk "
          f"{cfg.loss_chunk}; {n} parameters: {n * 2 / 1e9:.3f} GB bf16, "
          f"moments {n * 8 / 1e9:.2f} GB f32, gradients {n * 2 / 1e9:.2f} GB "
          f"bf16, {n * 12 / 1e9:.2f} GB of state before activations", flush=True)
    record = []
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                   # --- counted window ---
    state, losses = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                          ckpt_dir=None, seed=0, log_every=1, device=dev,
                          wrap_step=_timed_train_steps(record))
    counts = read_counts()                           # --- end of window ---
    counts.update(fa_bwd=fa.bwd_launch_count(), ssd_bwd=ssd.bwd_launch_count())
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"sw": 0, **{k: v * TRAIN_STEPS for k, v in per_step.items()}}
    check(counts == want, f"train {arch} launched {counts}, expected {want}")
    check(len(record) == TRAIN_STEPS and all(
        all(r[k] == v for k, v in per_step.items()) for r in record),
        f"per-step launches {[{k: r[k] for k in per_step} for r in record]}, "
        f"expected {per_step}")
    check(all(np.isfinite(losses)) and all(
        np.isfinite(r["metrics"]["grad_norm"]) and r["metrics"]["grad_norm"] > 0
        for r in record), f"losses {losses} or grad norms not finite / zero")
    bf16_flops, f32_flops, applied = train_flops(cfg, TRAIN_B, TRAIN_S,
                                                 state["params"])
    bound_s = bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32
    ntok = TRAIN_B * TRAIN_S
    for i, r in enumerate(record):
        tag = ("warm-up" if i == 0 else "timed" if i in TRAIN_TIMED else
               "profiled" if i == TRAIN_PROFILED else "")
        m = r["metrics"]
        print(f"train step {i} ({tag}): {r['ms']:.3f} ms (CUDA events), "
              f"{ntok / r['ms'] * 1e3:.1f} tokens/s, {bound_s * 1e3 / r['ms']:.4f} "
              f"of the {bound_s * 1e3:.3f} ms FLOP bound; host enqueue "
              f"{r['enqueue_ms']:.3f} ms of {r['wall_ms']:.3f} ms wall; loss "
              f"{m['loss']:.6f} ce {m['ce']:.6f} grad_norm {m['grad_norm']:.6f} "
              f"lr {m['lr']:.3e}; FA launches {r['fa']} forward (with the "
              f"remat recompute) and {r['fa_bwd']} backward; SSD launches "
              f"{r['ssd']} forward and {r['ssd_bwd']} backward", flush=True)
    timed = [record[i]["ms"] for i in TRAIN_TIMED]
    step_ms = float(np.mean(timed))
    ssd_txt = (f", plus the SSD scan's forward and backward products, "
               f"{f32_flops / 1e12:.2f} TFLOP at 67 TFLOP/s f32" if f32_flops else "")
    print(f"train {arch} B={TRAIN_B} S={TRAIN_S}: {step_ms:.3f} ms/step "
          f"(mean of steps {TRAIN_TIMED}: {', '.join(f'{t:.3f}' for t in timed)}), "
          f"{ntok / step_ms * 1e3:.1f} tokens/s, {bound_s * 1e3 / step_ms:.4f} "
          f"of the FLOP bound ({bf16_flops / 1e12:.1f} TFLOP at 989 TFLOP/s "
          f"bf16: 6 x {applied} parameters as applied x {ntok} tokens plus "
          f"the attention's 2 + 5 products{ssd_txt}; remat not counted); peak "
          f"device memory {peak:.3f} GB; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}", flush=True)
    prof = record[TRAIN_PROFILED]["prof"]
    split = train_split(prof)
    wall = record[TRAIN_PROFILED]["wall_ms"]
    if split["total"] > 0:
        print(f"train step device time by part ({arch}, torch.profiler, step "
              f"{TRAIN_PROFILED}): " + ", ".join(
                  f"{k} {v:.3f} ms ({v / split['total']:.4f})"
                  for k, v in split.items() if k != "total")
              + f"; total {split['total']:.3f} ms of a {wall:.3f} ms profiled "
              f"wall, host enqueue {record[TRAIN_PROFILED]['enqueue_ms']:.3f} "
              f"ms; device idle share {max(0.0, 1 - split['total'] / wall):.4f}",
              flush=True)
    else:
        print("train step device time by part: the profiler saw no device "
              "time (not measured)", flush=True)
    del state, record, prof
    free_device_memory()
    return {"counts": counts, "step_ms": step_ms,
            "tokens_per_s": ntok / step_ms * 1e3,
            "bound_share": bound_s * 1e3 / step_ms, "peak_gb": peak,
            "split": split}


def phase_training(dev, fa, ssd):
    """Phase 10: the FA backward kernel, then Phi-3-mini-3.8B training at
    full width through ``train``, its f32 gradient check and the restart;
    then the SSD backward kernel and Zamba2-2.7B training at full width
    through ``train``, with its f32 gradient check at one group's depth."""
    from repro_torch.configs import ARCHS
    t_phase = time.perf_counter()
    bwd_row = phase_fa_backward(dev, fa)
    L = ARCHS[TRAIN_ARCH].n_layers
    phi = train_main_path(dev, TRAIN_ARCH, dict(fa=2 * L, fa_bwd=L, ssd=0, ssd_bwd=0))
    err32, err16 = train_consistency(dev, ARCHS[TRAIN_ARCH])
    restart_err = train_restart(dev, ARCHS[TRAIN_ARCH])
    print(f"phi3 training {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_hybrid = time.perf_counter()
    ssd_row = phase_ssd_backward(dev, ssd)
    kinds = ARCHS[HYBRID_ARCH].layer_kinds()
    n_attn, n_ssm = kinds.count("attn_shared"), kinds.count("ssm")
    zamba = train_main_path(dev, HYBRID_ARCH, dict(
        fa=2 * n_attn, fa_bwd=n_attn, ssd=2 * n_ssm, ssd_bwd=n_ssm))
    z32, z16 = hybrid_train_consistency(dev, ARCHS[HYBRID_ARCH])
    print(f"zamba2 training {time.perf_counter() - t_hybrid:.1f} s; training "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"bwd_row": bwd_row, "fa": phi["counts"]["fa"],
            "fa_bwd": phi["counts"]["fa_bwd"], "phi3": phi,
            "grad_err_f32": err32, "grad_err_bf16": err16,
            "restart_err": restart_err, "ssd_bwd_row": ssd_row,
            "zamba2": zamba, "zamba2_grad_err_f32": z32,
            "zamba2_grad_err_bf16": z16}


# ---------------------------------------------------------------------------
# phase 11: keyed aggregation on the host runtime's two backends
# ---------------------------------------------------------------------------
KEYED_Q = 1000                # the chunked search's query and gap regime
BUCKET = 32                   # a subject's length bucket: length // 32
KEYED_SLOT = 33 << 10         # ring slot: one (2, 4096) int32 chunk inline
KEYED_CAPACITY = 16           # ring slots between the scatter and the rows
KEYED_TIMEOUT = 300.0
# benchmarks/ooc_aggregation.py:62-64, the reference's "large" tier,
# nothing cut: rows, hot and cold keys (80/20), per-partition budget, the
# map-side combiner's bound, 2 x 2 vertices, rows per reader batch
OOC = dict(nrows=1_000_000, hot=1024, cold=1_000_000, budget=1 << 20,
           combine_limit=2 << 20, nleft=2, nright=2, batch_rows=8192)
OOC_TIMEOUT = 600.0


# Nodes of the phase, at module level: the procs backend's vertices are
# spawned interpreters that re-import this file and resolve them by name.
def explode_scores(chunk):
    """A (2, n) int32 tensor (length buckets, scores) -> its n
    ``(bucket, score)`` rows, one ``KeyBatch`` (one ring message per
    destination partition)."""
    from repro_torch.core import KeyBatch
    buckets, scores = chunk.tolist()
    return KeyBatch(zip(buckets, scores))


class SynthRows:
    """The reference benchmark's row source (benchmarks/ooc_aggregation.py):
    ``reader(lo, hi)`` -> ``(key, value)`` rows, ~80% on ``hot`` keys and
    ~20% over ``cold`` ones, the value a crc of the row id (the per-row
    decode cost), deterministic from the row index alone."""

    def __init__(self, nrows, hot, cold):
        self.nrows = nrows
        self.hot = hot
        self.cold = cold

    def __call__(self, lo, hi):
        import zlib
        crc = zlib.crc32
        hot, cold = self.hot, self.cold
        rows = []
        for i in range(lo, hi):
            h = (i * 2654435761) & 0xFFFFFFFF
            k = h % hot if h % 5 else hot + (h // 5) % cold
            rows.append((k, float(crc(b"row-%d" % i) & 0xFFFF)))
        return rows


def row_key(row):
    return row[0]


def row_stats(acc, row):
    """Seeded fold: (count, total) per key."""
    return (acc[0] + 1, acc[1] + row[1])


def merge_stats(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _rss_kb(pid="self"):
    """Resident set of a live process now, in KB (``/proc/<pid>/statm``);
    0 once it is gone or where the file is missing."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") // 1024
    except (OSError, IndexError, ValueError):
        return 0


def ooc_child(backend):
    """One run of the out-of-core tier on ``backend``, in a fresh
    interpreter: prints one JSON line with the wall time (the vertices'
    spawn included, as the reference benchmark counts it), the time to
    the last vertex's ready, the skeleton's spill and stall counts, the
    peak resident sets of this process and of its largest vertex process
    (sampled every 10 ms: ``ru_maxrss`` would carry the resident set that
    a spawned process's parent had when it forked) and whether the result
    equals a plain dict fold of the same rows."""
    import multiprocessing as mp
    import threading
    from repro_torch.core import lower, shard_reduce
    import_kb = _rss_kb()
    cfg = OOC
    reader = SynthRows(cfg["nrows"], cfg["hot"], cfg["cold"])
    skel = shard_reduce(reader, row_key, row_stats, init=(0, 0.0),
                        combine=merge_stats, nleft=cfg["nleft"],
                        nright=cfg["nright"], budget=cfg["budget"],
                        batch_rows=cfg["batch_rows"],
                        combine_limit=cfg["combine_limit"])
    # pool=False: every vertex process starts for this run and exits
    opts = {"pool": False} if backend == "procs" else {}
    peaks = {"self": import_kb}
    stop = threading.Event()

    def sample():
        while not stop.wait(0.01):
            for pid in ["self"] + [p.pid for p in mp.active_children()]:
                peaks[pid] = max(peaks.get(pid, 0), _rss_kb(pid))

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    g = lower(skel, backend, **opts).to_graph(None)
    g.run()
    if backend == "procs":
        g.wait_ready()
    ready = time.perf_counter() - t0
    out = g.wait(OOC_TIMEOUT)
    wall = time.perf_counter() - t0
    stop.set()
    sampler.join()
    self_kb = peaks.pop("self")
    t1 = time.perf_counter()
    want = {}
    for lo in range(0, cfg["nrows"], cfg["batch_rows"]):
        for k, v in reader(lo, min(lo + cfg["batch_rows"], cfg["nrows"])):
            c, t = want.get(k, (0, 0.0))
            want[k] = (c + 1, t + v)
    plain_s = time.perf_counter() - t1
    got = dict(out)
    print(json.dumps(dict(
        backend=backend, nrows=cfg["nrows"], wall_s=wall,
        ready_s=ready if backend == "procs" else 0.0, plain_s=plain_s,
        pairs=len(out), keys=len(want),
        equal=len(got) == len(out) and got == want,
        spills=skel.stats.spills, spill_bytes=skel.stats.spill_bytes,
        stalls=skel.stats.backpressure_stalls, self_kb=self_kb,
        vertex_kb=max(peaks.values(), default=0), import_kb=import_kb)),
        flush=True)


def _shm_segments():
    import glob
    return sorted(glob.glob("/dev/shm/fft_*"))


def _vertex_hosts():
    import multiprocessing as mp
    return [p.name for p in mp.active_children() if p.name.startswith("ff-")]


def keyed_aggregation(dev, sw, ops, core, queries, smi_line):
    """(a): the chunked search once more (q=1000, the 10-2k regime, all
    2^19 subjects, chunks of 4096), each chunk's (length bucket, score)
    as one int32 (2, 4096) tensor on the card, reduced per bucket by
    ``reduce_by_key(bucket, "max")`` and ``(bucket, "count")`` on threads
    and on procs (2 left, 2 right; the ring moves each chunk to the host)
    and held, exactly, against ``scatter_reduce`` and ``bincount`` on the
    card.  Returns the SW launches of the path and what phase 12 reuses
    (the chunks, their order, the profile and the scores' rows)."""
    t_phase = time.perf_counter()
    A = ops.BLOSUM50.shape[0]
    go = REGIMES[0][0]
    flat, lens, offs = make_big_db(BIG_DB_SIZE, BIG_DB_SEED)
    order = np.argsort(-lens, kind="stable")
    chunks = pack_chunks(sw, lambda i: flat[offs[i]:offs[i] + lens[i]], order,
                         CHUNK, A, dev)
    buckets = torch.as_tensor(lens[order] // BUCKET, dtype=torch.int32,
                              device=dev).split(CHUNK)
    prof, q_len = ops.build_profile(queries[KEYED_Q], ops.BLOSUM50.to(dev))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t_phase

    reset_counts()                                # --- counted window ---
    farm = core.TaskFarm(2, preserve_order=True)
    farm.add_stream(chunks)
    farm.add_worker(core.FnNode(lambda ch: sw.sw_batch(
        prof, ch[0], ch[1], gap_open=go, gap_extend=GAP_EXTEND, q_len=q_len)))
    t0 = time.perf_counter()
    scores = farm.run_and_wait()
    stream = [torch.stack([b, s.to(torch.int32)])
              for b, s in zip(buckets, scores)]
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    runs = {}
    for fold in ("max", "count"):
        skel = core.reduce_by_key(row_key, fold, nleft=2, nright=2,
                                  left=explode_scores)
        t0 = time.perf_counter()
        out = core.lower(skel, "threads")(stream)
        runs[("threads", fold)] = dict(out=out, wall=time.perf_counter() - t0,
                                       ready=0.0)
        t0 = time.perf_counter()
        acc = core.ProcAccelerator(skel, capacity=KEYED_CAPACITY,
                                   slot_size=KEYED_SLOT)
        ready = time.perf_counter() - t0
        t0 = time.perf_counter()
        for chunk in stream:
            acc.offload(chunk)
        out = acc.wait(KEYED_TIMEOUT)
        runs[("procs", fold)] = dict(out=out, wall=time.perf_counter() - t0,
                                     ready=ready)
    counts = read_counts()                        # --- end of window ---
    check(counts == {"sw": len(chunks), "fa": 0, "ssd": 0},
          f"keyed path launched {counts}, expected sw {len(chunks)}")

    allv = torch.cat(stream, dim=1)
    score_f = torch.cat(scores)
    check(bool(torch.isfinite(score_f).all()) and float(score_f.min()) >= 0
          and torch.equal(score_f, allv[1].float()),
          "keyed path: scores not finite, negative or not integer-valued")
    # the first subjects of the first and last chunks against sw_plain
    pick = np.concatenate([order[:32], order[-32:]])
    sample, sample_lens = sw.pack_subjects(
        [flat[offs[i]:offs[i] + lens[i]] for i in pick], A, dev)
    live = torch.arange(sample.shape[1], device=dev) < sample_lens[:, None]
    want_s = sw.sw_plain(prof, torch.where(live, sample, A), go, GAP_EXTEND,
                         q_len)
    check(want_s.tolist() == torch.cat([score_f[:32], score_f[-32:]]).tolist(),
          "keyed path: scores differ from sw_plain on the 64-subject sample")
    b_all = allv[0].long()
    nb = int(b_all.max()) + 1
    count = torch.bincount(b_all, minlength=nb)
    amax = torch.full((nb,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, b_all, allv[1], "amax", include_self=False)
    present = (count > 0).nonzero().flatten().tolist()
    want = {"max": dict(zip(present, amax[present].tolist())),
            "count": dict(zip(present, count[present].tolist()))}
    rows = allv.shape[1]
    ncpu = os.cpu_count()
    print(f"keyed aggregation: {len(chunks)} chunks of (2, {CHUNK}) int32 on "
          f"the card (length // {BUCKET}, score) from the chunked search "
          f"q={KEYED_Q} {REGIMES[0][1]} ({search_s:.4f} s, {counts['sw']} "
          f"launches), {rows} rows, {len(present)} buckets; set-up "
          f"{setup:.1f} s; procs rings slot_size={KEYED_SLOT} "
          f"capacity={KEYED_CAPACITY}, batch off; host CPUs {ncpu}; card "
          f"{smi_line}", flush=True)
    for (backend, fold), r in runs.items():
        got = {k: (v[1] if fold == "max" else v) for k, v in r["out"]}
        check(len(got) == len(r["out"]) and got == want[fold],
              f"keyed {fold} on {backend} differs from "
              f"{'scatter_reduce amax' if fold == 'max' else 'bincount'}")
        print(f"keyed {fold} on {backend}: equal to "
              f"{'scatter_reduce(amax)' if fold == 'max' else 'bincount'} "
              f"over {len(got)} buckets; wall {r['wall']:.4f} s, "
              f"{rows / r['wall']:.1f} rows/s"
              + (f" (vertices ready in {r['ready']:.2f} s before it)"
                 if backend == "procs" else ""), flush=True)
    print(f"keyed aggregation phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    ctx = dict(chunks=chunks, order=order, prof=prof, q_len=q_len, go=go,
               stream=stream, rows=allv, want=want)
    return counts["sw"], ctx


def ooc_aggregation(smi_line):
    """(b): the reference's largest out-of-core tier through ``shard_reduce``
    on procs and on threads, each in a fresh interpreter; both equal to a
    plain dict fold, both spilled."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cfg = OOC
    print(f"out-of-core tier (benchmarks/ooc_aggregation.py 'large', nothing "
          f"cut): {cfg['nrows']} rows, {cfg['hot']} hot + {cfg['cold']} cold "
          f"keys, budget {cfg['budget']} B x {cfg['nright']} partitions, "
          f"combine_limit {cfg['combine_limit']} B, {cfg['nleft']} x "
          f"{cfg['nright']} vertices, batch_rows {cfg['batch_rows']}; host "
          f"CPUs {os.cpu_count()}; card {smi_line}", flush=True)
    for backend in ("procs", "threads"):
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.ooc_child({backend!r})"],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=OOC_TIMEOUT + 120)
        check(proc.returncode == 0,
              f"out-of-core child ({backend}) failed:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        check(r["equal"], f"out-of-core {backend}: result differs from the "
                          f"plain dict fold")
        check(r["spills"] > 0, f"out-of-core {backend}: no spill")
        def kb(v):
            return f"{v} KB" if v else "not measured (no /proc/<pid>/statm)"

        peak = r["vertex_kb"] if backend == "procs" else r["self_kb"]
        where = (f"vertex processes ready {r['ready_s']:.2f} s into it; "
                 f"peak RSS of a vertex process {kb(peak)}"
                 if backend == "procs" else f"peak RSS of the process {kb(peak)}")
        if peak and r["import_kb"]:
            where += f", {peak - r['import_kb']} KB over the import's"
        print(f"out-of-core on {backend}: equal to the plain dict fold "
              f"({r['keys']} keys; the fold took {r['plain_s']:.3f} s); wall "
              f"{r['wall_s']:.3f} s, {r['nrows'] / r['wall_s']:.1f} rows/s, "
              f"spills {r['spills']} ({r['spill_bytes']} B), backpressure "
              f"stalls {r['stalls']}; {where} (sampled every 10 ms; the "
              f"process held {kb(r['import_kb'])} after importing "
              f"chip_smoke.py and repro_torch.core)", flush=True)


def phase_keyed(dev, sw, ops, core, queries, smi_line):
    """Phase 11: the host runtime's keyed shuffle and out-of-core folds,
    threads and procs, driven by the card's SW scores and by the
    reference's largest out-of-core tier.  Every vertex host is retired
    and every segment unlinked before it returns (this script leaves
    through ``os._exit``, which skips the pool's ``atexit`` hook)."""
    t_phase = time.perf_counter()
    try:
        launches, ctx = keyed_aggregation(dev, sw, ops, core, queries,
                                          smi_line)
    finally:
        core.pool_shutdown()
    ooc_aggregation(smi_line)
    left = _shm_segments()
    check(not left, f"shared-memory segments left behind: {left}")
    hosts = _vertex_hosts()
    check(not hosts, f"vertex hosts still running: {hosts}")
    print(f"phase 11: no segment left in /dev/shm, no vertex host running; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, ctx


# ---------------------------------------------------------------------------
# phase 12: the self-tuning compile, the live monitor and the device backend
# ---------------------------------------------------------------------------
TUNE_PILOT = 16               # chunks the tuned search profiles first
MONITOR_INTERVAL_S = 0.01
# Zamba2 serving's service level: the worst reading of phase 7's serving on
# an NVIDIA H100 80GB HBM3 at 700 W before this phase was added (p99
# 15474.9 ms, 8.27 tokens/s); an alert is a reading, not a failure
SLO = dict(p99_us=15_474_900.0, min_goodput=8.27)
MESH_SIZES = [2000, 1 << 20]  # benchmarks/skeleton_parity.py's items, then 2^20
MESH_STEADY = 3               # steady calls timed after the first
FEEDBACK_ITEMS = 20_000
MESH_KEYS = 63                # length buckets: 2000 // 32 + 1
KEY_BITS = 64                 # a row travels as score * 64 + bucket


def times3_plus1(x):
    return x * 3 + 1


def minus7(x):
    return x - 7


def double_plus1(x):
    return x * 2 + 1


def below64(x):
    return x < 64


def bucket_of(v):
    return v % KEY_BITS


def slo_readings(eng, slo):
    """Phase 12 (b): the serving run's SLO readings (phase 7's engine)."""
    reg = eng.metrics
    lane = eng.last_trace.lane("slo-monitor")
    instants = [(e[0], e[3]) for e in lane.events] if lane else []
    alerts = reg.counter("slo.alerts").value
    check(alerts == len(slo.events),
          f"slo.alerts {alerts} != {len(slo.events)} alerts")
    check(len(instants) == len(slo.events) and all(
        k == "alert" and a == ev for (k, a), ev in zip(instants, slo.events)),
        f"slo-monitor lane {instants} does not carry the alerts {slo.events}")
    lat = eng._latency
    print(f"phase 12 (b) serving slo: p99 <= {slo.p99_us / 1e3:.1f} ms and "
          f">= {slo.min_goodput} tokens/s (the earlier worst reading); "
          f"read p99 {lat.p99 / 1e3:.1f} ms, "
          f"{eng.last_report.gauges['serve.tokens_per_s']:.2f} tokens/s; "
          f"{len(slo.events)} alert(s): {json.dumps(slo.events)}; "
          f"slo.alerts {alerts}; slo-monitor lane instants "
          f"{json.dumps(instants)}", flush=True)


def _ir_text(skel):
    """A tuned IR as one line: kinds, widths, grains, capacities, batches."""
    kind = type(skel).__name__
    if kind == "Pipeline":
        return "Pipeline(" + ", ".join(_ir_text(s) for s in skel.stages) + ")"
    node = getattr(skel, "node", None) or (skel.worker_nodes[0]
                                           if kind == "Farm" else None)
    batch = getattr(node, "batch", None)
    return (f"{kind}(" + (f"nworkers={skel.nworkers}, " if kind == "Farm"
                          else "")
            + f"grain={skel.grain}, capacity={skel.capacity}"
            + (f", rebatched by {batch}" if batch else "") + ")")


def _monotone(frames, key, end):
    """``key`` over one call's frames: monotone, ending at ``end``.
    Returns (whether it holds, (first, last, frames sampled))."""
    vals = [fr["counters"][key] for fr in frames if key in fr["counters"]]
    ok = bool(vals) and vals[-1] == end and all(
        a <= b for a, b in zip(vals, vals[1:]))
    return ok, (vals[0], vals[-1], len(vals)) if vals else None


def tuned_search(dev, sw, core, ctx, main, smi_line):
    """(a) the chunked search of phase 4 through ``lower(.., "threads",
    tune=True, monitor=, metrics=True)``: a pilot of 16 chunks on an
    instrumented lowering, the retuned farm for the rest, then a second
    call straight through the tuned program; then one monitored keyed
    reduction of phase 11's rows on procs."""
    from repro_torch.core.monitor import Monitor, analyze
    prof, q_len, go = ctx["prof"], ctx["q_len"], ctx["go"]
    chunks = ctx["chunks"]
    order_dev = torch.as_tensor(ctx["order"], device=dev)

    def score_chunk(ch):
        return sw.sw_batch(prof, ch[0], ch[1], gap_open=go,
                           gap_extend=GAP_EXTEND, q_len=q_len)

    def search(prog):
        t0 = time.perf_counter()
        flat = torch.cat(prog(chunks))
        scores = torch.empty(BIG_DB_SIZE, dtype=torch.float32, device=dev)
        scores[order_dev] = flat
        scores = scores.cpu()
        return scores, time.perf_counter() - t0

    mon = Monitor(interval_s=MONITOR_INTERVAL_S)
    reset_counts()                                # --- counted window ---
    tp = core.lower(core.Farm(score_chunk, 2, ordered=True), "threads",
                    tune=True, tune_pilot=TUNE_PILOT, monitor=mon,
                    metrics=True)
    first, wall1 = search(tp)
    n_first = len(mon.timeline)
    second, wall2 = search(tp)
    counts = read_counts()                        # --- end of window ---
    n = len(chunks)
    check(counts == {"sw": 2 * n, "fa": 0, "ssd": 0},
          f"tuned search launched {counts}, expected sw {2 * n}")
    check(torch.equal(first, main["scores"]) and torch.equal(second, first),
          "tuned search: scores differ from phase 4's chunked search")
    check(mon.errors == 0, f"monitor absorbed {mon.errors} sampling errors")
    frames = mon.timeline.frames()
    ok1, span1 = _monotone(frames[:n_first], "items_out", n - TUNE_PILOT)
    ok2, span2 = _monotone(frames[n_first:], "items_out", n)
    spans = [span1, span2]
    check(ok1 and ok2, f"items_out not monotone to {n - TUNE_PILOT} (first "
                       f"call, after the pilot) and {n} (second): {spans}")
    p = tp.profile
    print(f"phase 12 (a) tuned search: q={KEYED_Q} {REGIMES[0][1]}, {n} chunks "
          f"of {CHUNK}; scores equal phase 4's bit for bit in both calls; "
          f"{counts['sw']} SW launches; card {smi_line}", flush=True)
    print(f"tuned profile: handoff_us={p.handoff_us:.3f} pilot_items="
          f"{p.pilot_items}; " + "; ".join(
              f"{sp.kind}@{sp.path} width {sp.width}: service_us="
              f"{sp.service_us:.3f} (ewma {sp.service_ewma_us:.3f}) items "
              f"{sp.items} queue_high_water={sp.queue_high_water}"
              for sp in p.stages), flush=True)
    before, after = _ir_text(tp.skeleton), _ir_text(tp.tuned_skeleton)
    fused = type(tp.tuned_skeleton) is not type(tp.skeleton)
    print(f"retuned IR: {before} -> {after}; fused: {fused}; rebatched: "
          f"{'rebatched' in after}", flush=True)
    print("analyze(monitor.timeline): "
          + json.dumps(analyze(mon.timeline).to_json()), flush=True)
    rep = tp.tuned.last_report
    print(f"monitor: {len(mon.timeline)} frames, errors {mon.errors}, "
          f"items_out per call {spans}; run report (second call): counters "
          f"{json.dumps({k: v for k, v in rep.counters.items() if not k.startswith('mesh.')})} "
          f"farms {json.dumps(rep.farms)} queues {json.dumps(rep.queues)} "
          f"meta {json.dumps(rep.meta)}", flush=True)
    print(f"tuned search wall: first call (pilot + tuned rest) {wall1:.4f} s, "
          f"second call {wall2:.4f} s; phase 4's untuned farm {main['wall']:.4f}"
          f" s", flush=True)

    # one monitored keyed reduction of phase 11's rows on procs
    stream = [c.cpu() for c in ctx["stream"]]
    mon2 = Monitor(interval_s=MONITOR_INTERVAL_S)
    skel = core.reduce_by_key(row_key, "max", nleft=2, nright=2,
                              left=explode_scores)
    t0 = time.perf_counter()
    try:
        prog = core.lower(skel, "procs", metrics=True, monitor=mon2,
                          capacity=KEYED_CAPACITY, slot_size=KEYED_SLOT,
                          timeout=KEYED_TIMEOUT)
        out = prog(stream)
    finally:
        core.pool_shutdown()
    wall = time.perf_counter() - t0
    got = {k: v[1] for k, v in out}
    check(len(got) == len(out) and got == ctx["want"]["max"],
          "monitored keyed max on procs differs from scatter_reduce amax")
    check(mon2.errors == 0, f"procs monitor absorbed {mon2.errors} errors")
    left = _shm_segments()
    check(not left, f"shared-memory segments left behind: {left}")
    hosts = _vertex_hosts()
    check(not hosts, f"vertex hosts still running: {hosts}")
    last = mon2.timeline.frames()[-1]["counters"] if len(mon2.timeline) else {}
    print(f"monitored keyed max on procs: equal to scatter_reduce(amax) over "
          f"{len(got)} buckets; {wall:.2f} s with the vertices' spawn; "
          f"{len(mon2.timeline)} frames, errors 0, last counters "
          f"{json.dumps(last)}; report queues "
          f"{json.dumps(prog.last_report.queues)} pool "
          f"{json.dumps(prog.last_report.pool)}; no segment, no vertex host "
          f"left", flush=True)
    return counts["sw"]


def _lane_spans(prog):
    lane = prog.last_trace.lane("mesh-program")
    return [(e[0], round((e[2] - e[1]) * 1e3, 3) if e[2] else None,
             e[3] if len(e) > 3 else None) for e in lane.events]


def device_backend(dev, sw, ops, core, ctx, runs, db, queries):
    """(c) ``lower(.., "mesh")`` on the card: Farm∘Farm at 2000 items and
    2^20, a Feedback loop, the keyed reduction of phase 11's rows, and a
    device farm of SW scores.  Returns the SW launches of the farm."""
    pipe = core.Pipeline(core.Farm(times3_plus1, 2, ordered=True),
                         core.Farm(minus7, 2, ordered=True))
    mesh = core.lower(pipe, "mesh", trace=True, metrics=True)
    threads = core.lower(pipe, "threads")
    for n in MESH_SIZES:
        xs = list(range(n))
        t0 = time.perf_counter()
        want = threads(xs)
        t_threads = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = mesh(xs)
        t_first = time.perf_counter() - t0
        check(got == want, f"mesh Farm∘Farm at {n} items differs from threads")
        steady = []
        for _ in range(MESH_STEADY):
            t0 = time.perf_counter()
            check(mesh(xs) == want, f"mesh Farm∘Farm at {n}: steady call differs")
            steady.append(time.perf_counter() - t0)
        calls = [e[2] - e[1] for e in mesh.last_trace.lane("mesh-program").events
                 if e[0] == "call"][-MESH_STEADY:]
        print(f"mesh Farm∘Farm (3x+1, x-7) at {n} items: equal to threads; "
              f"threads {t_threads:.4f} s ({t_threads / n * 1e6:.3f} us/item), "
              f"mesh first call {t_first:.4f} s, steady "
              f"{min(steady):.4f}-{max(steady):.4f} s "
              f"({min(steady) / n * 1e6:.3f} us/item), of which the device "
              f"program (upload, stages, download) {min(calls) * 1e3:.3f}-"
              f"{max(calls) * 1e3:.3f} ms and the rest host packing and "
              f"unpacking", flush=True)
    print(f"mesh program: mesh.compiles {mesh.metrics.counter('mesh.compiles').value}, "
          f"mesh.calls {mesh.metrics.counter('mesh.calls').value}; lane "
          f"mesh-program (kind, ms, args): {json.dumps(_lane_spans(mesh))}",
          flush=True)

    fb = core.Feedback(double_plus1, below64, max_trips=32)
    xs = [i % 61 for i in range(FEEDBACK_ITEMS)]
    t0 = time.perf_counter()
    want = core.lower(fb, "threads")(xs)
    t_threads = time.perf_counter() - t0
    fbm = core.lower(fb, "mesh", metrics=True)
    t0 = time.perf_counter()
    got = fbm(xs)
    t_mesh = time.perf_counter() - t0
    check(got == want, "mesh Feedback differs from threads")
    print(f"mesh Feedback (2x+1 while < 64, max_trips 32) at {FEEDBACK_ITEMS} "
          f"items: equal to threads; threads {t_threads:.4f} s, mesh first "
          f"call {t_mesh:.4f} s", flush=True)

    # the keyed reduction of phase 11's rows, each as score * 64 + bucket
    rows = ctx["rows"]
    items = (rows[1].long() * KEY_BITS + rows[0].long()).tolist()
    for fold in ("max", "count"):
        prog = core.lower(core.reduce_by_key(bucket_of, fold, nkeys=MESH_KEYS),
                          "mesh", trace=True, metrics=True)
        walls = []
        for _ in range(2):                        # first call, then steady
            t0 = time.perf_counter()
            out = prog(items)
            walls.append(time.perf_counter() - t0)
            got = {k: (v // KEY_BITS if fold == "max" else v) for k, v in out}
            check(len(got) == len(out) and got == ctx["want"][fold],
                  f"mesh keyed {fold} differs from "
                  f"{'scatter_reduce amax' if fold == 'max' else 'bincount'}")
        calls = [e[2] - e[1] for e in prog.last_trace.lane("mesh-program").events
                 if e[0] == "call"]
        print(f"mesh keyed {fold} over {len(items)} rows, nkeys {MESH_KEYS}: "
              f"equal to {'scatter_reduce(amax)' if fold == 'max' else 'bincount'}"
              f" over {len(got)} buckets in both calls; " + ", ".join(
                  f"{what} call wall {w:.4f} s = device program {c:.4f} s + "
                  f"packing and unpacking {w - c:.4f} s"
                  for what, w, c in zip(("first", "second"), walls, calls))
              + f"; mesh.compiles {prog.metrics.counter('mesh.compiles').value}",
              flush=True)

    # a device farm of SW scores: phase 4's database, one row a subject
    A = ops.BLOSUM50.shape[0]
    prof, q_len = ops.build_profile(queries[KEYED_Q], ops.BLOSUM50.to(dev))
    go = REGIMES[0][0]
    padded, _ = sw.pack_subjects(db, A, "cpu")

    def score_rows(x):
        y = torch.zeros_like(x)
        y[:, 0] = sw.sw_batch(prof, x.contiguous(), gap_open=go,
                              gap_extend=GAP_EXTEND, q_len=q_len).to(torch.int32)
        return y

    farm = core.lower(core.Farm(score_rows, 2, ordered=True), "mesh",
                      trace=True, metrics=True)
    rows_in = list(padded.numpy())
    reset_counts()                                # --- counted window ---
    t0 = time.perf_counter()
    out = farm(rows_in)
    wall = time.perf_counter() - t0
    counts = read_counts()                        # --- end of window ---
    check(counts == {"sw": 1, "fa": 0, "ssd": 0},
          f"device SW farm launched {counts}, expected sw 1")
    got = [float(r[0]) for r in out]
    check(got == runs[(KEYED_Q, REGIMES[0][1])]["scores"],
          "device SW farm differs from phase 4's scores")
    call = next(e for e in farm.last_trace.lane("mesh-program").events
                if e[0] == "call")
    print(f"device SW farm: {len(db)} subjects padded to {padded.shape[1]} "
          f"residues, one row each, q={KEYED_Q} {REGIMES[0][1]}: equal to "
          f"phase 4's scores bit for bit; {counts['sw']} launch; wall "
          f"{wall:.4f} s, device program {call[2] - call[1]:.4f} s", flush=True)

    tp = core.lower(pipe, "mesh", tune=True, tune_pilot=256)
    xs = list(range(MESH_SIZES[0]))
    check(tp(xs) == threads(xs), "tuned mesh program differs from threads")
    from repro_torch.core.autotune import plan_mesh
    plan = plan_mesh(tp.profile, pipe)
    check(plan == {"factorization": (1, 1)} and
          (tp.tuned.n_stage, tp.tuned.n_worker) == (1, 1),
          f"tuned mesh plan {plan}, mesh {(tp.tuned.n_stage, tp.tuned.n_worker)}")
    print(f"lower(.., \"mesh\", tune=True): plan {plan} on "
          f"{torch.cuda.device_count()} card(s); profile "
          + "; ".join(f"{sp.kind}@{sp.path} {sp.service_us:.3f} us"
                      for sp in tp.profile.stages), flush=True)
    return counts["sw"]


def phase_device_backend(dev, sw, ops, core, ctx, main, runs, db, queries,
                         smi_line):
    """Phase 12: (a) the tuned, monitored chunked search and a monitored
    keyed reduction on procs; (b) ran in phase 7 (serving with ``slo=``);
    (c) the device backend on the card.  Returns the SW launches of the
    tuned search and of the device farm."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tuned = tuned_search(dev, sw, core, ctx, main, smi_line)
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    farm = device_backend(dev, sw, ops, core, ctx, runs, db, queries)
    t_c = time.perf_counter() - t0
    print(f"phase 12: (a) {t_a:.1f} s, (c) {t_c:.1f} s; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return tuned, farm


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("FAIL: run from the root of a checkout (src/repro_torch missing)")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 1
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(TIME_LIMIT_S)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")

    from repro_torch import core
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import smith_waterman as sw
    from repro_torch.kernels import ssd_scan as ssd
    phase_build(_build)

    cases, worst = phase_exact(dev, sw, ops, ref)
    t0 = time.perf_counter()
    launches, runs, db, queries = phase_main_path(dev, sw, ops, core)
    print(f"one-subject farm phase {time.perf_counter() - t0:.1f} s", flush=True)
    chunked_launches, chunked_main = phase_chunked(dev, sw, ops, core, runs,
                                                   db, queries)
    rows = phase_timing(dev, sw, ops)

    model_worst = phase_model_kernels(dev, fa, ssd)
    model_launches, _ = phase_model_path(dev)
    model_rows = phase_model_timing(dev, fa, ssd)
    families = phase_families(dev)
    training = phase_training(dev, fa, ssd)
    keyed_launches, keyed_ctx = phase_keyed(dev, sw, ops, core, queries,
                                            smi_line)
    tuned_launches, farm_launches = phase_device_backend(
        dev, sw, ops, core, keyed_ctx, chunked_main, runs, db, queries,
        smi_line)

    main_row = next(r for r in rows if r["b"] == TIMING_CHUNK and r["q"] == 1000)
    kernels = [{
        "name": "sw", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches + chunked_launches + keyed_launches
        + tuned_launches + farm_launches,
        "launches_by_path": {"one-subject farm": launches,
                             "chunked search": chunked_launches,
                             "keyed aggregation": keyed_launches,
                             "tuned chunked search": tuned_launches,
                             "device farm": farm_launches},
        "max_abs_err": worst, "exact_cases": cases,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": f"B={TIMING_CHUNK} subjects of D={MEAN_LEN}, q=1000",
        "shapes": [{k: r[k] for k in ("q", "b", "d", "dp", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "share")}
                   for r in rows],
    }]
    for name, source, replaces, shape in (
            ("fa", FA_SOURCE, FA_REPLACES,
             f"B={PREFILL_B} H=32 S=T={PREFILL_S} D=80 causal bf16"),
            ("ssd", SSD_SOURCE, SSD_REPLACES,
             f"b={PREFILL_B} T={PREFILL_S} H=80 P=64 N=64 chunk=256 f32 products")):
        r = model_rows[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": model_launches[name],
            "max_abs_err": max([r["err"], *model_worst[name].values()]),
            "max_abs_err_by_type": model_worst[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": shape, "launches_per": "one zamba2-2.7b prefill",
        }
        if name == "fa":
            by_path = {"zamba2 prefill": model_launches["fa"]}
            by_path.update({f"{FAMILY_RUNS[a]['path']} prefill": f["fa"]
                            for a, f in families.items()})
            by_path["phi3 train"] = training["fa"]
            by_path["zamba2 train"] = training["zamba2"]["counts"]["fa"]
            shapes = model_rows["fa_shapes"]
            entry.update(
                launches=sum(by_path.values()), launches_by_path=by_path,
                launches_per=f"one prefill of each path and {TRAIN_STEPS} "
                             f"phi3 and zamba2 train steps (forward and remat "
                             f"recompute)",
                max_abs_err=max(entry["max_abs_err"], *(x["err"] for x in shapes),
                                training["bwd_row"]["forward_with_stats_err"]),
                forward_with_stats_max_abs_err=training["bwd_row"][
                    "forward_with_stats_err"],
                shapes=[{k: x[k] for k in ("path", "shape", "ms", "plain_ms",
                                           "bound_ms", "bound_by", "library_ms",
                                           "library")} for x in shapes])
        else:
            by_path = {"zamba2 prefill": model_launches["ssd"],
                       "zamba2 train": training["zamba2"]["counts"]["ssd"]}
            entry.update(
                launches=sum(by_path.values()), launches_by_path=by_path,
                launches_per=f"one zamba2-2.7b prefill and {TRAIN_STEPS} "
                             f"zamba2 train steps (forward and remat recompute)")
        kernels.append(entry)
    r = training["bwd_row"]
    kernels.append({
        "name": "fa_bwd", "route": "cuda", "source": FA_BWD_SOURCE,
        "replaces": FA_BWD_REPLACES,
        "replaces_what": "XLA's gradient of chunked_attention: the JAX "
                         "package has no backward kernel",
        "launches": training["fa_bwd"] + training["zamba2"]["counts"]["fa_bwd"],
        "launches_by_path": {"phi3 train": training["fa_bwd"],
                             "zamba2 train": training["zamba2"]["counts"]["fa_bwd"]},
        "launches_per": f"{TRAIN_STEPS} phi3 and {TRAIN_STEPS} zamba2 train steps",
        "kernels_per_launch": FA_BWD_KERNELS,
        "kernels": "bf16: fa_bwd_delta_kernel, fa_bwd_dkdv_wgmma_kernel, "
                   "fa_bwd_dq_wgmma_kernel (wgmma + TMA, the forward's "
                   "statistics); f32: fa_bwd_stats_kernel, fa_bwd_dkdv_kernel, "
                   "fa_bwd_dq_kernel (SIMT)",
        "max_abs_err": r["err"], "max_abs_err_by_type": r["worst"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "library": "scaled_dot_product_attention(is_causal=True) backward "
                   "through autograd",
        "shape": r["shape"],
        "main_shape_check": r["main_shape"],
        "split_share": r["split_share"], "split_coverage": r["split_coverage"],
        "tflops_7_products": r["tflops_7"],
        "forward_ms": r["forward_ms"],
        "forward_with_stats_ms": r["forward_with_stats_ms"],
    })
    r = training["ssd_bwd_row"]
    kernels.append({
        "name": "ssd_bwd", "route": "cuda", "source": SSD_BWD_SOURCE,
        "replaces": SSD_BWD_REPLACES,
        "replaces_what": "XLA's gradient of ssd_chunked: the JAX package has "
                         "no backward kernel",
        "launches": training["zamba2"]["counts"]["ssd_bwd"],
        "launches_by_path": {"zamba2 train": training["zamba2"]["counts"]["ssd_bwd"]},
        "launches_per": f"{TRAIN_STEPS} zamba2 train steps",
        "kernels_per_launch": len(ssd.BWD_KERNELS),
        "kernels": "ssd_bwd_ds_kernel (dS per head group, dcs partials), "
                   "ssd_bwd_ds_sum_kernel (the groups' dS summed in order), "
                   "ssd_bwd_state_kernel (each chunk's state gradient), "
                   "ssd_bwd_pass_kernel (reverse inter-chunk pass), "
                   "ssd_bwd_bc_heads_kernel (dB, dC head terms per H·P slice), "
                   "ssd_bwd_bc_kernel (dS·B, dSᵀ·C and the slices' sum), "
                   "ssd_bwd_dx_kernel (dx, x·du, s_j, the y_off term), "
                   "ssd_bwd_cumsum_kernel (f64 reverse cumsum, ddt, dA); "
                   "products on the tensor cores as 3xTF32 (mma.sync)",
        "kernel_configs": r["kernel_configs"],
        "max_abs_err": r["err"], "max_abs_err_by_type": r["worst"],
        "max_rel_err": r["rel_err"], "max_rel_err_by_type": r["worst_rel"],
        "max_rel_err_is": "max |kernel - plain| / max |plain| per gradient, "
                          "less one bf16 spacing where stored in bf16",
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "bound_is": "3xTF32: the least products "
        "at 2 TF32 terms where an operand is bf16, 3 where both are f32, at "
        "495 TFLOP/s", "bound_tf32_gflop": r["tf32_gflop"],
        "bound_f32_ms": r["bound_f32_ms"],
        "library_ms": None,
        "library": "none: no PyTorch call computes the SSD backward",
        "shape": r["shape"], "main_shape_check": r["main_shape"],
        "split_ms": r["split"], "tflops": r["tflops"],
        "kernel_tflops": r["kernel_tflops"],
        "forward_with_scratch_ms": r["forward_with_scratch_ms"],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except CheckFailed as e:
        print(f"FAIL: {e}", flush=True)
        rc = 1
    except Exception:
        traceback.print_exc()
        print("FAIL: exception", flush=True)
        rc = 1
    sys.stdout.flush()
    os._exit(rc)
