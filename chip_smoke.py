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
  search's rows and subjects;
* the same mesh programs over 4 rank processes sharing the card (gloo,
  staged through the host: the machine has one card), the device
  channels between them, and ring attention at Phi-3-mini's attention
  shape with every hop through the flash-attention kernel.

Phases, each on lines of its own; any failed check exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the six CUDA sources in ``src/repro_torch/kernels/csrc``, one
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
     split by its five passes (torch.profiler); the Mamba2 mixer's
     gated-norm kernels against their plain versions and timed at
     zamba2-train-4k's shape, then one Zamba2-7B train step at full width
     over its first 12 layers with remat, which must launch them 24
     forward and 12 backward;
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
  13. multi-rank on the card: 4 rank processes on ``cuda:0`` over gloo
      (``repro_torch.core.ranks``): (a) ``ring_send``, ``chain_send``,
      ``RingChannel`` and ``double_buffered_ring`` of a (4096, 1024) bf16
      block, each equal to its permutation, ms per hop; (b) ``lower(..,
      "mesh", devices=4, transport="gloo")``: Farm∘Farm at 2000 and 2^20
      items at factorization (1, 4) and (2, 2) and the Feedback loop, equal
      to threads and phase 12, and the SW device farm over phase 4's
      subjects at 4 workers (4 launches gathered from the ranks); (c) the
      keyed max and count of phase 11's rows over 4 ranks; (d) ring
      attention, B=1 S=16384 H=32 D=96 bf16 causal, 10 FA launches, against
      the same ring through the plain hop in float32 (each row's relative
      L2 error within ``RING_REL_TOL``, which three planted faults of the
      merge must exceed), the ring's time split into its kernels and its
      exchanges, and at S=2048 with a window of 512 against ``fa_plain``.
      Its times are one card time-sliced by 4 processes, not multi-GPU
      speeds;
  14. the sharded model on the same 4 ranks as a 2×2 (data × model) mesh
      (``repro_torch.parallel``): (a) ``ef_int8_psum`` of a (3072, 8192)
      f32 leaf a rank within the reference's bounds; (b) Phi-3-mini-3.8B at
      full width, 2 layers: the bf16 loss (4 × 2048) within rtol 3e-3 of
      one device, the f32 gradients (2 × 512) gathered with ``gather_tree``
      within 1e-3 of each leaf's max of the one-device ones, and two
      planted faults (``SHARD_FAULTS``) that must fail that check; (c)
      Mixtral-8x7B at full width, 1 layer: the MoE block through
      ``local_gather``, ``a2a`` and ``ring`` with nothing dropped, each row
      within 2e-2 relative L2 of the one-device dropless dispatch, and the
      loss; (d) Mamba2-130M whole: the bf16 loss and its SSD forward and
      backward launches; (e) ``train(mesh=make_test_mesh(2, 2))`` for 3
      steps against one-device ``train``; FA and SSD launches gathered from
      the ranks.  Then no rank process, rank store or ``/dev/shm`` entry of
      a rank left.  Its times too are one card shared by 4 processes;
  15. serving and gradients over the mesh, and the dry run, on the same 4
      ranks: (a) ring attention's gradient (``RingAttentionFn``, the FA
      backward kernel each hop of a second ring) at Phi-3-mini's attention
      width — causal and window 512 at S=2048 against the one-device
      float32 ``fa_backward_plain`` (row-wise relative L2 within
      ``RING_REL_TOL``, 10 FA backward launches a ring, three planted
      faults that must fail), and S=16384 against the one-device bf16
      ``flash_attention`` gradient, with the backward ring's time split;
      (b) sharded ``prefill`` and ``decode_step`` on the 2×2 mesh of
      Phi-3-mini (2 layers) and Mamba2-130M (whole), bf16 (4 × 2048, 8
      steps) and f32 (4 × 512, 4 steps), each rank's logits rows and the
      gathered cache against one device, and a planted fault; (c) the
      dry run's accounting (``launch.dryrun._account``) of a Phi-3 train
      and decode cell on the 2×2 mesh over gloo, whose argument bytes and
      collective tally must equal the real ranks'; (d) the dry run's
      production table (80 records, the meta device).  Times are one card
      shared by 4 processes;
  16. a ``kernels`` JSON line; the last line is the ``ok`` JSON.

Run from the root of a checkout:  python3 chip_smoke.py
"""
import contextlib
import functools
import gc
import glob
import itertools
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
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
# (Qp, B) of the SW kernel-alone sweep beside the block kernel's crossover
# (PERF.md): Qp past the warp kernel's 1024 rows, B on both sides of it
SW_SWEEP = ([1152, 4096, 8192], [1, 8, 132, 133, 4096])
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


def _stop_children():
    """Kill every process this script started that is still running (the
    rank processes, pooled vertex hosts): ``os._exit`` skips the pools'
    ``atexit`` hooks."""
    import multiprocessing as mp
    procgraph = sys.modules.get("repro_torch.core.procgraph")
    if procgraph is not None:     # retire the idle pooled hosts first
        procgraph.pool_shutdown()
    for p in mp.active_children():
        p.kill()
        p.join(timeout=10)


def _watchdog(signum, frame):
    print(f"FAIL: chip_smoke exceeded {TIME_LIMIT_S} s", flush=True)
    _stop_children()
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
    for qlen in [1, 24, 128, 129, 144, 497, 1000, 1024, 4000, 5147]:
        query = torch.as_tensor(rng.integers(0, 20, qlen).astype(np.int32),
                                device=dev)
        prof, q_len = ops.build_profile(query, ops.BLOSUM50.to(dev))
        subjects = [rng.integers(0, 20, n).astype(np.int32) for n in dlens]
        gappy = rng.integers(0, 20, 700).astype(np.int32)
        hole = rng.random(700) < 0.2
        gappy[hole] = rng.integers(A, A + 9, int(hole.sum()))  # chars >= A
        subjects += [gappy, np.full(40, A, np.int32)]          # + all padding
        batches = [sw.pack_subjects(subjects, A, dev)]
        if prof.shape[1] > sw.WARP_QP:   # the block kernel, then the strips
            more = [rng.integers(0, 20, n).astype(np.int32) for n in
                    rng.integers(1, 700, sw.STRIP_MIN_B - len(subjects))]
            batches.append(sw.pack_subjects(subjects + more, A, dev))
        paths = [sw._sw_path(prof.shape[1], s.shape[0]) for s, _ in batches]
        for (subj, lens), (go, ge) in itertools.product(
                batches, [(10.0, 2.0), (5.0, 2.0), (10.3, 2.1)]):
            got = sw.sw_batch(prof, subj, lens, gap_open=go, gap_extend=ge,
                              q_len=q_len)
            live = torch.arange(subj.shape[1], device=dev) < lens[:, None]
            want = sw.sw_plain(prof, torch.where(live, subj, A), go, ge, q_len)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            check(torch.equal(got, want),
                  f"kernel != plain at q={qlen} B={subj.shape[0]} "
                  f"gaps={go}-{ge}: {got.tolist()} vs {want.tolist()}")
            # one subject alone, through the padded entry point (B = 1)
            one = ops.smith_waterman(query, torch.as_tensor(subjects[3],
                                                            device=dev),
                                     gap_open=go, gap_extend=ge)
            check(float(one) == float(want[3]),
                  f"smith_waterman != plain at q={qlen} gaps={go}-{ge}")
            cases += subj.shape[0] + 1
        print(f"exact q={qlen:5d} Qp={prof.shape[1]:5d}: "
              f"{' + '.join(f'{s.shape[0]} subjects ({p})' for (s, _), p in zip(batches, paths))}"
              f" x 3 regimes equal", flush=True)
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
    check(counts == {"sw": expected, "fa": 0, "ssd": 0, "gated_norm": 0},
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
    ``TIMING_CHUNK`` subjects of D=352 per launch (the chunked search's),
    at queries of the warp kernel (1000, 144) and of the long ones (1500,
    4000: the block kernel at one subject, the strip kernel at a chunk);
    then the kernel alone over ``SW_SWEEP``, the path each shape takes."""
    rng = np.random.default_rng(5)
    A = ops.BLOSUM50.shape[0]
    rows = []
    for b, dp in ((1, 512), (TIMING_CHUNK, MEAN_LEN)):
        for qlen in (1000, 144, 1500, 4000):
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
            print(f"timing q={qlen} B={b} d={dlen} (Dp={dp}): "
                  f"{sw._sw_path(prof.shape[1], b)} kernel "
                  f"{kern:.6f} ms/launch, plain {plain:.3f} ms, bound "
                  f"{bound_ms:.6f} ms ({bound_by}), {bound_ms / kern:.4f} of "
                  f"the bound, kernel GCUPS {rate:.3f}, library: none (no "
                  f"PyTorch call computes SW)", flush=True)
    for qp, b in itertools.product(*SW_SWEEP):
        prof, q_len = ops.build_profile(torch.as_tensor(
            rng.integers(0, 20, qp).astype(np.int32), device=dev),
            ops.BLOSUM50.to(dev))
        subj = torch.as_tensor(rng.integers(0, 20, (b, MEAN_LEN))
                               .astype(np.int32), device=dev)
        lens = torch.full((b,), MEAN_LEN, dtype=torch.int32, device=dev)
        kern = cuda_ms(lambda: sw.sw_batch(
            prof, subj, lens, gap_open=10.0, gap_extend=GAP_EXTEND,
            q_len=q_len), iters=5 if b == TIMING_CHUNK else 20, warmup=2)
        print(f"timing sweep Qp={qp} B={b} d={MEAN_LEN}: "
              f"{sw._sw_path(qp, b)} kernel {kern:.6f} ms/launch, kernel "
              f"GCUPS {q_len * MEAN_LEN * b / (kern * 1e-3) / 1e9:.3f}",
              flush=True)
    return rows


def reset_counts():
    from repro_torch.kernels import _build
    _build.reset_launch_counts()


def read_counts():
    """Forward launches by counter: sw, fa, ssd, gated_norm."""
    from repro_torch.kernels import _build
    return {k: v for k, v in _build.launch_counts().items()
            if not k.endswith("_bwd")}


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
    consistency(dev, cfg, prompt, bf16_logits,
                {"sw": 0, "fa": g, "ssd": g * inner, "gated_norm": 0})
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


FA224 = (8, 32, 4096, 224)    # Zamba2-7B's training attention: B, H, S = T, D
FA224_FWD = "forward (with statistics)"


def fa224_timing(dev, fa):
    """The D = 224 kernels (Zamba2-7B's shared attention; scale (D/2)^-0.5,
    causal, bf16) at the training shape.  First one sequence at S = T =
    4096 with all 32 heads against the plain versions over the kernel's kv
    tiles: the statistics-writing forward's output (FA_TOL) and statistics
    (1e-5 + 1e-5·|plain|), the backward's dq, dk, dv (FA_TOL).  Then each
    timed at the whole shape against its bound (operations: 2 and 5
    products of 2·D FLOPs per causal pair at 989 TFLOP/s; bytes: q, k, v,
    o, and the backward's do and gradients, once each), the plain version
    (a sequence at a time) and the library's
    ``scaled_dot_product_attention(is_causal=True, scale=(D/2)^-0.5)``,
    forward, and backward through autograd."""
    B, H, S, D = FA224
    scale = (D / 2) ** -0.5
    kw = dict(causal=True, scale=scale)
    tol, kv = FA_TOL[torch.bfloat16], fa.kv_tile(torch.bfloat16, D)
    g = torch.Generator(device=dev).manual_seed(224)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    one = [t[:1] for t in (q, k, v, do)]
    o1, st1 = fa.fa_forward_with_stats(*one[:3], **kw)
    err_f, ok_f = within(o1, fa.fa_plain(*one[:3], kv_tile=kv, **kw), tol)
    err_s, ok_s = within(st1, fa.fa_stats_plain(*one[:2], kv_tile=kv, **kw), 1e-5)
    got = fa.fa_backward(*one[:3], o1, one[3], stats=st1, **kw)
    want = fa.fa_backward_plain(*one[:3], o1, one[3], kv_tile=kv, stats=st1, **kw)
    torch.cuda.synchronize()
    errs = [within(a, b, tol) for a, b in zip(got, want)]
    check(ok_f and ok_s and all(ok for _, ok in errs),
          f"FA D=224 != plain at (1, {H}, {S}, {D}): forward {err_f}, statistics "
          f"{err_s}, backward {[e for e, _ in errs]}")
    del o1, st1, got, want
    o, stats = fa.fa_forward_with_stats(q, k, v, **kw)
    per = H * S                                  # statistics rows a sequence
    fwd = cuda_ms(lambda: fa.fa_forward_with_stats(q, k, v, **kw), iters=10, warmup=2)
    bwd = cuda_ms(lambda: fa.fa_backward(q, k, v, o, do, stats=stats, **kw),
                  iters=10, warmup=2)
    plain_fwd = cuda_ms(lambda: [fa.fa_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                             kv_tile=kv, **kw) for i in range(B)],
                        iters=2, warmup=1)
    plain_bwd = cuda_ms(lambda: [fa.fa_backward_plain(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], o[i:i + 1], do[i:i + 1], kv_tile=kv,
        stats=stats[:, i * per:(i + 1) * per], **kw) for i in range(B)],
        iters=2, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_name = "scaled_dot_product_attention(is_causal=True, scale=(D/2)^-0.5)"
    lib_fwd = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, scale=scale),
                      iters=10, warmup=2)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_bwd, reps = 0.0, 5
    for i in range(reps + 1):
        out = sdpa(*leaves, is_causal=True, scale=scale)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out.backward(do)
        stop.record()
        torch.cuda.synchronize()
        if i:                          # the first is a warm-up
            lib_bwd += start.elapsed_time(stop) / reps
        for t in leaves:
            t.grad = None
    del out, leaves
    pairs = fa_pairs(S, S, True, None)
    shape = f"B={B} H={H} Hkv={H} S={S} T={S} D={D} causal scale (D/2)^-0.5 bf16"
    rows = {}
    for name, ms, plain, lib, products, tensors, err in (
            (FA224_FWD, fwd, plain_fwd, lib_fwd, 2, 4, err_f),
            ("backward", bwd, plain_bwd, lib_bwd, 5, 8, max(e for e, _ in errs))):
        flop = products * 2 * B * H * D * pairs
        t_ops, t_bytes = flop / PEAK_BF16, tensors * B * H * S * D * 2 / PEAK_BYTES
        rows[name] = dict(
            path=f"zamba2-7b train, {name}", shape=shape, ms=ms, plain_ms=plain,
            library_ms=lib, library=lib_name + (" backward through autograd"
                                                if products == 5 else ""),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes", err=err)
        print(f"timing fa224 {name} {shape}: kernel {ms:.4f} ms, bound "
              f"{rows[name]['bound_ms']:.4f} ms ({flop / 1e9:.2f} GFLOP at 989 "
              f"TFLOP/s; bytes {t_bytes * 1e3:.4f} ms), "
              f"{flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{rows[name]['bound_ms'] / ms:.4f} of the bound; plain (a sequence "
              f"at a time) {plain:.4f} ms; library {rows[name]['library']} "
              f"{lib:.4f} ms; |err| vs plain at (1, {H}, {S}, {D}) {err:.3e}"
              + (f", statistics {err_s:.3e}" if products == 2 else ""), flush=True)
    del q, k, v, do, o, stats
    torch.cuda.empty_cache()
    return rows


GN_SHAPE = (8, 4096, 112, 64, 2, 7424)   # zamba2-train-4k: B, T, H, P, G, xBC's width
GN_SOURCE = "src/repro_torch/kernels/csrc/gated_norm.cu"


def gated_norm_timing(dev, gn):
    """The Mamba2 mixer's gated-norm kernels (Zamba2-7B's epilogue after the
    SSD; x a slice of xBC, bf16 x, z and out) at zamba2-train-4k's shape.
    First one sequence against the plain versions: the forward's output
    within one bf16 spacing, the backward's dy, dx, dz within 1e-5 of
    their largest entry and dD, dgnorm within 1e-4, each beside one
    storage spacing (``tests/test_torch_gpu.py``'s ``_gn_close``).  Then
    each timed at the whole shape against its bound (bytes: the forward
    reads y f32, x and z and writes out and r; the backward reads do, y, x,
    z and r and writes dy f32, dx, dz, dD and dgnorm, once each, at 3.35
    TB/s), and the plain versions: ``gated_rmsnorm_plain`` and
    ``gated_rmsnorm_backward_plain``, and the eager expression's autograd
    backward, the path the kernels replace.  No PyTorch call computes the
    epilogue."""
    B, T, H, P, G, width = GN_SHAPE
    di = H * P
    g = torch.Generator(device=dev).manual_seed(33)
    y = torch.randn((B, T, H, P), generator=g, device=dev)
    xbc = torch.randn((B, T, width), generator=g, device=dev).to(torch.bfloat16)
    x = xbc[..., :di].reshape(B, T, H, P)
    z, do = ((torch.randn((B, T, di), generator=g, device=dev) * s).to(torch.bfloat16)
             for s in (2.0, 1.0))
    D = torch.randn((H,), generator=g, device=dev)
    gnorm = 1 + 0.1 * torch.randn((di,), generator=g, device=dev)
    eps = 1e-5
    one = [t[:1] for t in (y, x, z, do)]
    out1, r1 = gn.gated_rmsnorm_forward(one[0], one[1], one[2], D, gnorm, G, eps)
    got = gn.gated_rmsnorm_backward(one[3], one[0], one[1], one[2], D, gnorm, r1, G)
    want_out = gn.gated_rmsnorm_plain(one[0], one[1], one[2], D, gnorm, G, eps)
    want = gn.gated_rmsnorm_backward_plain(one[0], one[1], one[2], D, gnorm, G, eps,
                                           one[3])
    torch.cuda.synchronize()

    def close(u, w, tol):
        spacing = 2.0 ** -7 if u.dtype == torch.bfloat16 else 2.0 ** -23
        u, w = u.float(), w.float()
        rel = float(((u - w).abs() - spacing * w.abs()).clamp_min(0).max()
                    / w.abs().max())
        return rel, rel <= tol

    errs = {"out": close(out1, want_out, 0.0)}
    errs.update({n: close(u, w, tol) for n, u, w, tol in zip(
        ("dy", "dx", "dz", "dD", "dgnorm"), got, want, (1e-5, 1e-5, 1e-5, 1e-4, 1e-4))})
    check(all(ok for _, ok in errs.values()),
          f"gated norm != plain at (1, {T}, {H}, {P}), G={G}: {errs}")
    del out1, r1, got, want_out, want
    out, r = gn.gated_rmsnorm_forward(y, x, z, D, gnorm, G, eps)
    fwd = cuda_ms(lambda: gn.gated_rmsnorm_forward(y, x, z, D, gnorm, G, eps),
                  iters=20, warmup=3)
    bwd = cuda_ms(lambda: gn.gated_rmsnorm_backward(do, y, x, z, D, gnorm, r, G),
                  iters=20, warmup=3)
    plain_fwd = cuda_ms(lambda: gn.gated_rmsnorm_plain(y, x, z, D, gnorm, G, eps),
                        iters=3, warmup=1)
    plain_bwd = cuda_ms(lambda: gn.gated_rmsnorm_backward_plain(
        y, x, z, D, gnorm, G, eps, do), iters=3, warmup=1)
    leaves = [t.detach().clone().requires_grad_() for t in (y, z, D, gnorm)]
    xl = x.detach().clone().requires_grad_()
    eager_bwd, reps = 0.0, 3
    for i in range(reps + 1):
        o = gn.gated_rmsnorm_plain(leaves[0], xl, leaves[1], leaves[2], leaves[3], G, eps)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        o.backward(do)
        stop.record()
        torch.cuda.synchronize()
        if i:                          # the first is a warm-up
            eager_bwd += start.elapsed_time(stop) / reps
        for t in leaves + [xl]:
            t.grad = None
    del o, leaves, xl
    n, rows_g = B * T * di, B * T * G
    shape = f"B={B} T={T} H={H} P={P} G={G}, x a slice of a {width}-wide xBC, bf16"
    rows = {}
    for name, ms, plain, nbytes in (
            ("forward", fwd, plain_fwd, n * (4 + 2 + 2 + 2) + rows_g * 4),
            ("backward", bwd, plain_bwd, n * (2 + 4 + 2 + 2 + 4 + 2 + 2) + rows_g * 4
             + (di + H) * 4)):
        bound = nbytes / PEAK_BYTES * 1e3
        rows[name] = dict(path=f"zamba2-7b train, gated norm {name}", shape=shape,
                          ms=ms, plain_ms=plain, bound_ms=bound, bound_by="bytes",
                          library_ms=None, err=max(e for e, _ in errs.values()))
        print(f"timing gated norm {name} {shape}: kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s), "
              f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, {bound / ms:.4f} of the "
              f"bound; plain {plain:.4f} ms"
              + (f"; the eager expression's autograd backward {eager_bwd:.4f} ms"
                 if name == "backward" else "")
              + "; library: none (no PyTorch call computes the epilogue)", flush=True)
    print(f"gated norm kernels vs plain at (1, {T}, {H}, {P}), G={G}: "
          + ", ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
          + " (beyond one storage spacing, of the largest entry)", flush=True)
    rows["eager_bwd_ms"] = eager_bwd
    del y, xbc, x, z, do, out, r
    torch.cuda.empty_cache()
    return rows


GN_TRAIN_LAYERS = 12    # Zamba2-7B's first 12 layers: hybrid 6 and 11, both memory blocks
GN_TRAIN_SEQ = 4096


def gated_norm_main_path(dev):
    """One Zamba2-7B train step at its published widths, cut to its first
    GN_TRAIN_LAYERS layers, through ``launch.train.train`` (bf16 parameters,
    f32 moments, remat, 1 x GN_TRAIN_SEQ tokens from SyntheticLM seed 0):
    the zamba2 family's path, which zamba2-train-4k runs at 36 layers and
    8 sequences.  Every mixer must launch the gated-norm forward kernel
    twice (the forward and the remat recompute) and the backward once:
    2 x n_layers and n_layers, counted from 0 at the step's start."""
    from repro_torch.configs.zamba2_7b import CONFIG
    from repro_torch.kernels import gated_norm as gn
    from repro_torch.launch.train import train
    cfg = CONFIG.replace(n_layers=GN_TRAIN_LAYERS, remat=True, loss_chunk=1024)
    L = cfg.n_layers
    free_device_memory()
    t0 = time.perf_counter()
    reset_counts()                                   # --- counted window ---
    state, losses = train(cfg, steps=1, batch=1, seq=GN_TRAIN_SEQ, ckpt_dir=None,
                          seed=0, log_every=1, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()                           # --- end of window ---
    counts["gated_norm_bwd"] = gn.bwd_launch_count()
    wall = time.perf_counter() - t0
    check((counts["gated_norm"], counts["gated_norm_bwd"]) == (2 * L, L),
          f"zamba2-7b train step ({L} layers) launched gated norm "
          f"{counts['gated_norm']} forward, {counts['gated_norm_bwd']} backward; "
          f"expected {2 * L} and {L}")
    check(all(np.isfinite(losses)), f"zamba2-7b train step loss {losses} not finite")
    print(f"zamba2-7b train step at full width, {L} layers "
          f"({cfg.layer_kinds().count('hybrid')} hybrid), remat, 1 x {GN_TRAIN_SEQ} "
          f"tokens, through launch.train.train: gated norm {counts['gated_norm']} "
          f"forward and {counts['gated_norm_bwd']} backward launches (2 x {L} and "
          f"{L}); all launches {counts}; loss {losses[0]:.6f}; {wall:.1f} s with "
          f"the initialisation", flush=True)
    del state
    free_device_memory()
    return {"forward": counts["gated_norm"], "backward": counts["gated_norm_bwd"],
            "n_layers": L}


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
    """A prefill's cache with ``n`` empty rows after its last in each k/v
    leaf (an SSM state as it is), for decode steps past it (the
    reference's caches are allocated at max_len)."""
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n))
            if k in ("k", "v") else v for k, v in cache.items()}


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
    check(counts == {"sw": 0, "fa": cfg.n_layers, "ssd": 0, "gated_norm": 0},
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
                {"sw": 0, "fa": cfg_c.n_layers, "ssd": 0, "gated_norm": 0})
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
    optimizer update and the cross entropy (its forward, and its backward
    with the recompute nested inside)."""
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
    and backward, the optimizer update, the cross entropy (its forward, and
    its backward with the recompute, each kernel once: the outermost of
    nested ranges), the other GEMMs, the rest."""
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
            up = ev.cpu_parent
            while up is not None and up.name != ev.name:
                up = up.cpu_parent
            if up is None:
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
    want = {"sw": 0, "gated_norm": 0,
            **{k: v * TRAIN_STEPS for k, v in per_step.items()}}
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
    check(counts == {"sw": len(chunks), "fa": 0, "ssd": 0, "gated_norm": 0},
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
    check(counts == {"sw": 2 * n, "fa": 0, "ssd": 0, "gated_norm": 0},
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
    wants = {}                                    # phase 13 holds its ranks to these
    for n in MESH_SIZES:
        xs = list(range(n))
        t0 = time.perf_counter()
        want = wants[n] = threads(xs)
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
    wants["feedback"] = want
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
    check(counts == {"sw": 1, "fa": 0, "ssd": 0, "gated_norm": 0},
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
    return counts["sw"], wants


def phase_device_backend(dev, sw, ops, core, ctx, main, runs, db, queries,
                         smi_line):
    """Phase 12: (a) the tuned, monitored chunked search and a monitored
    keyed reduction on procs; (b) ran in phase 7 (serving with ``slo=``);
    (c) the device backend on the card.  Returns the SW launches of the
    tuned search and of the device farm, and (c)'s threads outputs."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tuned = tuned_search(dev, sw, core, ctx, main, smi_line)
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    farm, wants = device_backend(dev, sw, ops, core, ctx, runs, db, queries)
    t_c = time.perf_counter() - t0
    print(f"phase 12: (a) {t_a:.1f} s, (c) {t_c:.1f} s; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return tuned, farm, wants


# phase 13: the mesh programs, the channels and ring attention over 4 rank
# processes sharing the card (a machine with one card: NCCL
# refuses two ranks on one card, so the exchanges go over gloo through the
# host; their times are one card time-sliced by 4 processes)
RANKS = 4
RANK_TRANSPORT = "gloo"
RANK_LABEL = (f"one card time-sliced by {RANKS} rank processes, exchanges "
              f"over {RANK_TRANSPORT} staged through the host: not a "
              f"multi-GPU speed")
CHANNEL_SHAPE = (4096, 1024)  # a bf16 block of 8 MiB
CHANNEL_REPS = 5              # timed ring hops
RING_ARCH = "phi3-mini-3.8b"  # its attention: 32 heads (and kv heads) of 96
RING_B, RING_S = 1, 16384     # sequence-sharded 4096 a rank
RING_SEED = 13
RING_CHECK = dict(S=2048, window=512)   # the windowed check against fa_plain
# The ring against float32 references on the same bf16 inputs: for every
# (batch, position, head) row, ||ring - reference|| / ||reference|| over the
# head dim.  A sound ring differs by the bf16 rounding of each hop's output
# and of the result (2^-9 of a row, relative, at most 2^-8 of each entry);
# the limit sits between the sound readings and the planted faults'.
RING_REL_TOL = 1e-2
# Planted faults of the merge, each a substitution in ring_attention.py's
# text, run in the ranks beside the real module: each must fail the limit.
RING_FAULTS = {
    "merge in base e": (
        "torch.exp2(m - m_new), torch.exp2(m_h - m_new) * l_h",
        "torch.exp(m - m_new), torch.exp(m_h - m_new) * l_h"),
    "q_offset hops weighted 10% high": (
        "torch.exp2(m_h - m_new) * l_h",
        "torch.exp2(m_h - m_new) * l_h * (1.1 if h else 1.0)"),
    "the hop from one rank back dropped": (
        "if causal and src > me:", "if causal and (src > me or h == 1):"),
}


def _channel_block(rank, gen, dev):
    """Rank ``rank``'s block of generation ``gen``: integers below 251,
    exact in bf16, different for every (rank, generation)."""
    n = CHANNEL_SHAPE[0] * CHANNEL_SHAPE[1]
    v = (torch.arange(n, device=dev) * 7 + rank * 31 + gen * 13) % 251
    return v.to(torch.bfloat16).reshape(CHANNEL_SHAPE)


def channel_job(ctx):
    """Phase 13 (a), in each rank: every channel of ``dchannel`` against
    the permutation it must give, bit for bit, then timed ring hops."""
    from repro_torch.core import dchannel
    grp, r, n, dev = ctx.world_group, ctx.rank, ctx.world, ctx.device
    left = (r - 1) % n
    x = _channel_block(r, 0, dev)
    ok = {"ring_send": torch.equal(dchannel.ring_send(x, grp),
                                   _channel_block(left, 0, dev))}
    want = _channel_block(r - 1, 0, dev) if r else torch.zeros_like(x)
    ok["chain_send"] = torch.equal(dchannel.chain_send(x, grp), want)
    chan = dchannel.RingChannel(grp, capacity=2)
    slots, arrived = chan.init(x), []
    for gen in range(4):
        got, slots = chan.step(slots, _channel_block(r, gen, dev))
        arrived.append(got)
    want = [x, x, _channel_block(left, 0, dev), _channel_block(left, 1, dev)]
    ok["RingChannel(capacity=2)"] = all(torch.equal(a, w)
                                        for a, w in zip(arrived, want))
    ok["double_buffered_ring"] = dchannel.double_buffered_ring(
        lambda hop, carry, block: (carry and torch.equal(
            block, _channel_block((r - hop) % n, 0, dev)), None), x, True, grp)
    torch.cuda.synchronize()
    staged, t0 = ctx.staged, time.perf_counter()
    y = x
    for _ in range(CHANNEL_REPS):
        y = dchannel.ring_send(y, grp)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / CHANNEL_REPS
    ok["timed ring"] = torch.equal(
        y, _channel_block((r - CHANNEL_REPS) % n, 0, dev))
    return ok, ms, (ctx.staged - staged) / CHANNEL_REPS


def score_rows_on_rank(prof, q_len, go, x):
    """The device farm's worker in a rank: column 0 of each row of padded
    residues becomes its SW score (``prof`` arrives on the host)."""
    from repro_torch.kernels import smith_waterman as sw
    y = torch.zeros_like(x)
    y[:, 0] = sw.sw_batch(prof.to(x.device), x.contiguous(), gap_open=go,
                          gap_extend=GAP_EXTEND, q_len=q_len).to(torch.int32)
    return y


def _ring_inputs(S, dev):
    """q, k, v of the ring at sequence length S, the same in every process
    (a seeded generator on the card)."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[RING_ARCH]
    gen = torch.Generator(device=dev).manual_seed(RING_SEED)
    return [torch.randn((RING_B, S, h, cfg.head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
            for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]


def _ring_error(got, want):
    """``got`` against the float32 ``want``, both (B, S, H, D): the largest
    relative L2 error of a row over the head dim, and the two sums of
    squares of the relative Frobenius error (summed over the ranks)."""
    dd = (got.float() - want).square().sum(-1)
    rr = want.square().sum(-1)
    return {"row_max": float((dd / rr.clamp_min(1e-30)).sqrt().max()),
            "dd": float(dd.sum()), "rr": float(rr.sum())}


def _ring_shard(ctx, S):
    """This rank's q, k, v shards of the ring at sequence length S."""
    s = S // ctx.world
    own = slice(ctx.rank * s, (ctx.rank + 1) * s)
    return [t[:, own].contiguous() for t in _ring_inputs(S, ctx.device)]


def _ring_reference(ra, q, k, v, grp, window):
    """The ring through the plain hop in float32 on the bf16 inputs
    (timed): the reference every FA ring is held against."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ra.ring_attention_plain(q.float(), k.float(), v.float(), group=grp,
                                  causal=True, window=window)
    torch.cuda.synchronize()
    return ref, (time.perf_counter() - t0) * 1e3


def ring_attention_job(ctx, S, window, keep_out):
    """Phase 13 (d), in each rank: this rank's shard through
    ``ring_attention`` (the FA kernel each hop), timed and held against
    the float32 plain-hop ring; with ``keep_out`` the output shard too."""
    import importlib
    ra = importlib.import_module("repro_torch.parallel.ring_attention")
    q, k, v = _ring_shard(ctx, S)
    grp = ctx.world_group
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ra.ring_attention(q, k, v, group=grp, causal=True, window=window)
    torch.cuda.synchronize()
    res = {"ms": (time.perf_counter() - t0) * 1e3, "staged": ctx.staged,
           "finite": bool(torch.isfinite(out).all())}
    ref, res["plain_ms"] = _ring_reference(ra, q, k, v, grp, window)
    res.update(_ring_error(out, ref))
    if keep_out:
        res["out"] = out.cpu()
    return res


def _faulty_ring_module(ra, fault, faults=None):
    """``ring_attention.py`` with the planted fault ``fault`` (of
    ``faults``, ``RING_FAULTS`` by default) substituted into its text, as
    a module of its own beside the real one."""
    import inspect
    import types
    old, new = (RING_FAULTS if faults is None else faults)[fault]
    src = inspect.getsource(ra)
    if src.count(old) != 1:
        raise RuntimeError(f"planted fault {fault!r}: {old!r} is not once "
                           f"in {ra.__file__}")
    mod = types.ModuleType(ra.__name__ + "_planted")
    mod.__package__ = ra.__package__
    exec(compile(src.replace(old, new), ra.__file__, "exec"), mod.__dict__)
    return mod


def ring_probe_job(ctx, S):
    """Phase 13 (d) beside the main path, in each rank: the planted faults
    held against the float32 reference, and the FA ring's time split into
    its parts: this rank's hops through the kernel with no exchange, and
    the K/V circulating with no body."""
    import importlib
    from repro_torch.core import dchannel
    ra = importlib.import_module("repro_torch.parallel.ring_attention")
    q, k, v = _ring_shard(ctx, S)
    grp, s, me = ctx.world_group, S // ctx.world, ctx.rank
    ref, _ = _ring_reference(ra, q, k, v, grp, None)
    res = {"faults": {}}
    for fault in RING_FAULTS:
        out = _faulty_ring_module(ra, fault)._ring_fa(
            q, k, v, group=grp, causal=True, window=None)
        res["faults"][fault] = _ring_error(out, ref)
    del ref
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for src in range(me + 1):
        ra._fa_hop(q, k, v, causal=True, window=None, q_offset=(me - src) * s)
    torch.cuda.synchronize()
    res["kernels_ms"] = (time.perf_counter() - t0) * 1e3
    staged = ctx.staged
    t0 = time.perf_counter()
    dchannel.double_buffered_ring(lambda h, c, b: (c, None), (k, v), None,
                                  grp)
    torch.cuda.synchronize()
    res["exchange_ms"] = (time.perf_counter() - t0) * 1e3
    res["exchange_staged"] = ctx.staged - staged
    return res


def _rank_hosts():
    import multiprocessing as mp
    return [p.name for p in mp.active_children() if p.name.startswith("rank-")]


def _rank_stores():
    return set(glob.glob(os.path.join(tempfile.gettempdir(), "repro-ranks-*")))


def _rank_leftovers(pids, stores_before):
    """What the phase's rank processes could leave behind: a ``/dev/shm``
    entry whose name carries one of their pids, and a rank store
    directory made during the phase (entries of other processes on the
    machine are not looked at)."""
    pat = re.compile(r"(?<!\d)(%s)(?!\d)" % "|".join(map(str, pids)))
    shm = [e for e in os.listdir("/dev/shm") if pids and pat.search(e)]
    return sorted(shm) + sorted(_rank_stores() - stores_before)


def phase_ring_attention(pool, dev, where, label):
    """Phase 13 (d): ring attention at Phi-3-mini's attention width over
    the pool's ranks, held against the float32 plain-hop ring, the
    planted faults, the time split, and the windowed check.  Returns the
    FA launches the ranks made on the main path."""
    reset_counts()                                # --- counted window ---
    pool.reset_counts()
    t0 = time.perf_counter()
    res = pool.run(ring_attention_job, RING_S, None, False)
    wall = time.perf_counter() - t0
    here, there = read_counts(), dict(pool.launches)   # --- end of window ---
    n_fa = RANKS * (RANKS + 1) // 2
    check(there["fa"] == n_fa and not any(here.values()),
          f"ring attention launched {there} in the ranks and {here} here; "
          f"expected fa {n_fa} in the ranks (1 + 2 + ... + {RANKS})")
    row_max = max(r["row_max"] for r in res)
    fro = (sum(r["dd"] for r in res) / sum(r["rr"] for r in res)) ** 0.5
    check(all(r["finite"] for r in res) and row_max <= RING_REL_TOL,
          f"ring attention through the FA kernel differs from the float32 "
          f"plain-hop ring: a row by {row_max:.3e} relative (limit "
          f"{RING_REL_TOL})")
    fa_launches = there["fa"]
    from repro_torch.configs import ARCHS
    cfg = ARCHS[RING_ARCH]
    print(f"phase 13 (d) ring attention ({where}): {RING_ARCH}'s attention, "
          f"B={RING_B} S={RING_S} (sequence-sharded {RING_S // RANKS} a rank) "
          f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} D={cfg.head_dim} bf16 "
          f"causal; {fa_launches} FA launches gathered from the ranks; "
          f"against the float32 plain-hop ring on the same bf16 inputs: "
          f"worst row relative L2 {row_max:.3e} (limit {RING_REL_TOL}), "
          f"relative Frobenius {fro:.3e}; ms by rank, FA ring "
          f"{json.dumps([round(r['ms'], 3) for r in res])}, float32 plain "
          f"ring {json.dumps([round(r['plain_ms'], 3) for r in res])}; host "
          f"moves by rank {json.dumps([r['staged'] for r in res])}; call "
          f"wall {wall:.3f} s; {label}", flush=True)
    probes = pool.run(ring_probe_job, RING_S)
    for fault in RING_FAULTS:
        f_max = max(p["faults"][fault]["row_max"] for p in probes)
        f_fro = (sum(p["faults"][fault]["dd"] for p in probes)
                 / sum(p["faults"][fault]["rr"] for p in probes)) ** 0.5
        check(f_max > RING_REL_TOL, f"planted fault '{fault}' passes the "
              f"ring check ({f_max:.3e} <= {RING_REL_TOL})")
        print(f"phase 13 (d) planted fault '{fault}' ({where}): worst row "
              f"relative L2 {f_max:.3e} against the limit {RING_REL_TOL} "
              f"(fails it, as it must), relative Frobenius {f_fro:.3e}",
              flush=True)
    print(f"phase 13 (d) ring attention's time split ({where}): ms by rank, "
          f"its hops through the FA kernel with no exchange "
          f"{json.dumps([round(p['kernels_ms'], 3) for p in probes])}, the "
          f"K/V circulating with no body "
          f"{json.dumps([round(p['exchange_ms'], 3) for p in probes])} "
          f"({probes[0]['exchange_staged']} host moves a rank); the FA ring "
          f"above {json.dumps([round(r['ms'], 3) for r in res])}; {label}",
          flush=True)
    S, window = RING_CHECK["S"], RING_CHECK["window"]
    res = pool.run(ring_attention_job, S, window, True)
    got = torch.cat([r["out"] for r in res], dim=1).to(dev)
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (t.transpose(1, 2).float() for t in _ring_inputs(S, dev))
    torch.backends.cuda.matmul.allow_tf32 = False
    want = fa.fa_plain(q, k, v, causal=True, window=window).transpose(1, 2)
    err = _ring_error(got, want)
    ring_max = max(r["row_max"] for r in res)
    check(err["row_max"] <= RING_REL_TOL and ring_max <= RING_REL_TOL,
          f"windowed ring attention at S={S}: a row differs by "
          f"{err['row_max']:.3e} from the float32 fa_plain and by "
          f"{ring_max:.3e} from the float32 plain-hop ring (limit "
          f"{RING_REL_TOL})")
    print(f"phase 13 (d) ring attention at S={S}, window {window} ({where}): "
          f"hops two and three ranks back see no key (zero weight in the "
          f"merge); worst row relative L2 against the float32 fa_plain over "
          f"the whole sequence {err['row_max']:.3e}, against the float32 "
          f"plain-hop ring {ring_max:.3e} (limit {RING_REL_TOL}); {label}",
          flush=True)
    return fa_launches


def phase_ranks(dev, sw, ops, core, ctx, runs, db, queries, wants, smi_line):
    """Phase 13: (a) the device channels, (b) ``lower(.., "mesh",
    devices=4, transport="gloo")`` — Farm∘Farm at (1, 4) and (2, 2), a
    Feedback loop, the SW device farm — (c) the keyed mesh program, and
    (d) ring attention at Phi-3-mini's attention shape, all over 4 rank
    processes on the card.  Returns the kernel launches the ranks made on
    the counted paths (the SW farm's and the ring's)."""
    from repro_torch.core import ranks
    free_device_memory()
    t_phase = time.perf_counter()
    stores_before = _rank_stores()
    where = f"world {RANKS}, transport {RANK_TRANSPORT}"
    label = f"{RANK_LABEL}; card {smi_line}"
    pool = ranks.pool(RANKS, transport=RANK_TRANSPORT)
    check(pool.devices == ["cuda:0"] * RANKS,
          f"ranks on {pool.devices}, expected all on cuda:0")
    print(f"phase 13 ({where}): {RANKS} ranks on {pool.devices} ready in "
          f"{pool.ready_s:.2f} s (spawn, torch import, CUDA context, "
          f"process group); {label}", flush=True)

    # (a) the channels
    t0 = time.perf_counter()
    out = pool.run(channel_job)
    wall = time.perf_counter() - t0
    for r, (ok, _, _) in enumerate(out):
        bad = [k for k, v in ok.items() if not v]
        check(not bad, f"rank {r}: {bad} gave the wrong permutation")
    mib = CHANNEL_SHAPE[0] * CHANNEL_SHAPE[1] * 2 / 2 ** 20
    print(f"phase 13 (a) channels ({where}): ring_send, chain_send, "
          f"RingChannel(capacity=2), double_buffered_ring of a "
          f"{CHANNEL_SHAPE} bf16 block ({mib:.0f} MiB) equal to their "
          f"permutations bit for bit on every rank; ms per ring hop, "
          f"staging included, by rank "
          f"{json.dumps([round(o[1], 3) for o in out])} with "
          f"{out[0][2]:.0f} host moves a hop a rank; call wall {wall:.3f} s; "
          f"{label}", flush=True)

    # (b) the skeleton mesh program over the ranks
    pipe = core.Pipeline(core.Farm(times3_plus1, 2, ordered=True),
                         core.Farm(minus7, 2, ordered=True))
    for fact in ((1, RANKS), (2, RANKS // 2)):
        prog = core.lower(pipe, "mesh", devices=RANKS,
                          transport=RANK_TRANSPORT, factorization=fact,
                          trace=True)
        walls = []
        for n in MESH_SIZES:
            xs = list(range(n))
            t0 = time.perf_counter()
            got = prog(xs)
            walls.append(time.perf_counter() - t0)
            check(got == wants[n], f"mesh Farm∘Farm {fact} over {RANKS} "
                  f"ranks at {n} items differs from threads and phase 12")
        print(f"phase 13 (b) mesh Farm∘Farm (3x+1, x-7) factorization "
              f"{fact} ({where}): equal to threads and to phase 12's "
              f"one-device mesh at " + ", ".join(
                  f"{n} items (call wall {w:.4f} s)"
                  for n, w in zip(MESH_SIZES, walls))
              + f"; lane {json.dumps(_lane_spans(prog))}; {label}",
              flush=True)
    fb = core.Feedback(double_plus1, below64, max_trips=32)
    xs = [i % 61 for i in range(FEEDBACK_ITEMS)]
    fbm = core.lower(fb, "mesh", devices=RANKS, transport=RANK_TRANSPORT)
    t0 = time.perf_counter()
    check(fbm(xs) == wants["feedback"],
          f"mesh Feedback over {RANKS} ranks differs from threads")
    print(f"phase 13 (b) mesh Feedback at {FEEDBACK_ITEMS} items ({where}, "
          f"{fbm.n_worker} workers): equal to threads; call wall "
          f"{time.perf_counter() - t0:.4f} s; {label}", flush=True)

    # (b) the SW device farm: phase 4's database, one row a subject
    A = ops.BLOSUM50.shape[0]
    prof, q_len = ops.build_profile(queries[KEYED_Q], ops.BLOSUM50.to(dev))
    go = REGIMES[0][0]
    padded, _ = sw.pack_subjects(db, A, "cpu")
    farm = core.lower(core.Farm(functools.partial(
        score_rows_on_rank, prof.cpu(), q_len, go), RANKS, ordered=True),
        "mesh", devices=RANKS, transport=RANK_TRANSPORT)
    rows_in = list(padded.numpy())
    reset_counts()                                # --- counted window ---
    pool.reset_counts()
    t0 = time.perf_counter()
    out = farm(rows_in)
    wall = time.perf_counter() - t0
    here, there = read_counts(), dict(pool.launches)   # --- end of window ---
    check(there["sw"] == RANKS and not any(here.values()),
          f"SW device farm over {RANKS} ranks launched {there} in the ranks "
          f"and {here} here; expected sw {RANKS} in the ranks, one each")
    check([float(r[0]) for r in out] == runs[(KEYED_Q, REGIMES[0][1])]["scores"],
          f"SW device farm over {RANKS} ranks differs from phase 4's scores")
    sw_launches = there["sw"]
    print(f"phase 13 (b) SW device farm ({where}): {len(db)} subjects, "
          f"q={KEYED_Q} {REGIMES[0][1]}, {farm.n_worker} workers: equal to "
          f"phase 4's scores bit for bit; {sw_launches} SW launches gathered "
          f"from the ranks; call wall {wall:.4f} s; {label}", flush=True)

    # (c) the keyed mesh program over the ranks
    rows = ctx["rows"]
    items = (rows[1].long() * KEY_BITS + rows[0].long()).tolist()
    for fold in ("max", "count"):
        prog = core.lower(core.reduce_by_key(bucket_of, fold, nkeys=MESH_KEYS),
                          "mesh", devices=RANKS, transport=RANK_TRANSPORT)
        t0 = time.perf_counter()
        out = prog(items)
        wall = time.perf_counter() - t0
        got = {k: (v // KEY_BITS if fold == "max" else v) for k, v in out}
        check(len(got) == len(out) and got == ctx["want"][fold],
              f"keyed {fold} over {RANKS} ranks differs from "
              f"{'scatter_reduce amax' if fold == 'max' else 'bincount'}")
        print(f"phase 13 (c) keyed {fold} over {len(items)} rows, nkeys "
              f"{MESH_KEYS} ({where}): equal to "
              f"{'scatter_reduce(amax)' if fold == 'max' else 'bincount'} "
              f"over {len(got)} buckets; call wall {wall:.4f} s; {label}",
              flush=True)

    # (d) ring attention at Phi-3-mini's attention width
    fa_launches = phase_ring_attention(pool, dev, where, label)

    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # phases 14 and 15 on the same ranks
    sharded = phase_sharded_model(pool, dev, label)
    meshed = phase_mesh_serving(pool, dev, label)

    pids = pool.pids
    ranks.shutdown()
    left = _rank_leftovers(pids, stores_before)
    check(not left, f"the ranks left behind: {left}")
    hosts = _rank_hosts()
    check(not hosts, f"rank processes still running: {hosts}")
    print(f"phases 13-15: no rank process, rank store or /dev/shm entry of a "
          f"rank left; {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"sw": sw_launches, "fa": fa_launches, "sharded": sharded,
            "meshed": meshed}


# ---------------------------------------------------------------------------
# phase 14: the sharded model over the 4 rank processes on the card
# ---------------------------------------------------------------------------
# A (data 2, model 2) mesh of the same 4 ranks sharing cuda:0 over gloo
# (NCCL refuses two ranks on one card): the models at full width, depth
# cut.  One card time-sliced by 4 processes, exchanges staged through the
# host: no time here is a multi-GPU speed.
SHARD_MESH = (2, 2)
SHARD_SEED = 0                # init_params' seed, the same in every process
SHARD_RTOL = 3e-3             # a sharded loss against the one-device loss
SHARD_GRAD_TOL = TRAIN_GRAD_TOL   # phase 10's rule: worst leaf, of its max
SHARD_MOE_TOL = 2e-2          # row-wise relative L2 of the MoE output (bf16)
EF_SHAPE = (3072, 8192)       # a Phi-3 MLP matrix, f32, on each rank
EF_REPS = 3
SHARD_PHI3 = dict(arch="phi3-mini-3.8b", layers=2, loss=(4, 2048),
                  grads=(2, 512))
SHARD_MIXTRAL = dict(arch="mixtral-8x7b", layers=1, tokens=(4, 1024))
SHARD_MAMBA2 = dict(arch="mamba2-130m", loss=(4, 1024))
SHARD_TRAIN = dict(steps=3, batch=4, seq=1024)
# Planted faults, each a substitution in a module's text, executed into the
# module inside the ranks for one run of (b)'s gradient check and undone
# after it: each must fail the check.
SHARD_FAULTS = {
    "data-group reduce of replicated leaves left out": (
        "repro_torch.launch.steps",
        "else psum_compat(g, group), grads, specs)", "else g, grads, specs)"),
    "model-region entry's backward sum left out": (
        "repro_torch.parallel.context",
        "return _sum(grad, ctx.group), None", "return grad, None"),
}
_STEP_MS = []                 # a rank's train-step times, read after (e)


def _shard_cfg(arch, layers=None, **over):
    from repro_torch.configs import ARCHS
    cfg = ARCHS[arch]
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    return cfg.replace(**over)


def _shard_batch(cfg, B, S, dev, mc=None):
    """SyntheticLM seed 0's first batch on ``dev``: this rank's rows under
    the mesh context ``mc``, else all of it."""
    from repro_torch.data import SyntheticLM
    from repro_torch.parallel import rules
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, B, S)(0).items()}
    if mc is not None:
        batch = rules.shard_tree(batch, rules.batch_shardings(mc, cfg, B))
    return {k: v.to(dev) for k, v in batch.items()}


@contextlib.contextmanager
def _planted(fault, faults=None):
    """The module of ``fault`` (of ``faults``, ``SHARD_FAULTS`` by default)
    with its substitution executed into it (its functions resolve their
    globals there), undone on exit."""
    if fault is None:
        yield
        return
    import importlib
    import inspect
    name, old, new = (SHARD_FAULTS if faults is None else faults)[fault]
    mod = importlib.import_module(name)
    src = inspect.getsource(mod)
    if src.count(old) != 1:
        raise RuntimeError(f"planted fault {fault!r}: {old!r} is not once in "
                           f"{mod.__file__}")
    exec(compile(src.replace(old, new), mod.__file__, "exec"), mod.__dict__)
    try:
        yield
    finally:
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)


def _mesh_ctx():
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.context import mesh_context
    return mesh_context(make_test_mesh(*SHARD_MESH))


def _local_params(mc, cfg, dev):
    """This rank's shards of init_params(cfg, SHARD_SEED) (drawn whole on
    the card, then cut), with the peak memory counter reset after."""
    from repro_torch.models import init_params
    from repro_torch.parallel import rules
    plan = rules.param_shardings(mc, cfg)
    local = rules.shard_tree(init_params(cfg, SHARD_SEED, device=dev), plan)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    return local, plan


def ef_job(rctx, shape, reps):
    """Phase 14 (a), in each rank: ``ef_int8_psum`` over the 4 ranks of a
    seeded f32 gradient leaf of ``shape`` a rank, timed over ``reps``
    calls after one, against the exact mean."""
    from repro_torch.optim import ef_int8_psum
    dev = rctx.device
    gens = [torch.Generator(device=dev).manual_seed(100 + r)
            for r in range(rctx.world)]
    mine = torch.randn(shape, generator=gens[rctx.rank], device=dev)
    res = torch.zeros(shape, device=dev)
    grp = rctx.world_group
    out, r2 = ef_int8_psum({"g": mine}, {"g": res}, grp)       # warm-up
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, r2 = ef_int8_psum({"g": mine}, {"g": res}, grp)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    exact = torch.zeros(shape, device=dev)
    scale = 0.0
    for r in range(rctx.world):
        g = mine if r == rctx.rank else torch.randn(
            shape, generator=gens[r], device=dev)
        exact += g / rctx.world
        scale = max(scale, float(g.abs().max()))
    return {"err": float((out["g"] - exact).abs().max()), "scale": scale,
            "resid": float(r2["g"].abs().max()), "ms": ms,
            "staged": rctx.staged // (reps + 1)}


def sharded_model_job(rctx, cfg, B, S, grads, fault=None):
    """Phase 14 (b) and (d), in each rank: ``loss_fn`` of this rank's
    shards and rows (with ``grads`` also ``loss_and_grads``, the gradients
    gathered to rank 0), timed; ``fault`` planted for the run."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel import rules
    from repro_torch.tree import tree_map
    dev = rctx.device
    with _planted(fault), _mesh_ctx() as mc:
        local, plan = _local_params(mc, cfg, dev)
        batch = _shard_batch(cfg, B, S, dev, mc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if grads:
            loss, _, g = steps.loss_and_grads(local, batch, cfg)
        else:
            with torch.no_grad():
                loss, _ = M.loss_fn(local, batch, cfg)
        torch.cuda.synchronize()
        res = {"loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3,
               "staged": rctx.staged,
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        if grads:
            full = rules.gather_tree(g, plan)
            if rctx.rank == 0:
                res["grads"] = tree_map(lambda t: t.cpu(), full)
    return res


def sharded_moe_job(rctx, cfg, B, S):
    """Phase 14 (c), in each rank: ``_ffn_part`` of Mixtral's first layer
    over the mesh through each MoE dispatch (nothing dropped), then the
    sharded ``loss_fn``; rank 0 returns the output rows gathered over the
    data group."""
    from repro_torch.models import model as M
    from repro_torch.parallel import rules
    from repro_torch.parallel.context import fsdp_gather
    dev = rctx.device
    res = {"outs": {}, "ms": {}}
    with _mesh_ctx() as mc:
        local, _ = _local_params(mc, cfg, dev)
        block = {k: v for k, v in M._layers(local["blocks"])[0].items()
                 if k in ("moe", "norm2")}
        specs = M._attn_block_specs(cfg, mc.mp_size)
        specs = {k: specs[k] for k in block}
        rows = rules.to_shardings(mc, ("dp", None, None))
        x = rows.shard(_moe_input(cfg, B, S, dev))
        with torch.no_grad():
            for backend in ("local_gather", "a2a", "ring"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, _ = M._ffn_part(fsdp_gather(block, specs), x,
                                     cfg.replace(moe_backend=backend))
                torch.cuda.synchronize()
                res["ms"][backend] = (time.perf_counter() - t0) * 1e3
                out = rows.gather(out)
                if rctx.rank == 0:
                    res["outs"][backend] = out.cpu()
            del out
            res["peak_ffn_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            batch = _shard_batch(cfg, B, S, dev, mc)
            res["loss"] = float(M.loss_fn(local, batch, cfg)[0])
        res["staged"] = rctx.staged
        res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def _moe_input(cfg, B, S, dev):
    """The MoE block's seeded input: (B, S, d) bf16 activations."""
    gen = torch.Generator(device=dev).manual_seed(SHARD_SEED + 7)
    return torch.randn((B, S, cfg.d_model), generator=gen,
                       device=dev).to(cfg.param_dtype)


class StepTimer:
    """``wrap_step`` for ``train``: each step timed (synchronised) into
    the rank's ``_STEP_MS``."""

    def __call__(self, step_fn):
        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*a)
            torch.cuda.synchronize()
            _STEP_MS.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed


def step_times_job(rctx, reset):
    """The rank's train-step times and peak memory (with ``reset``: clear
    both first)."""
    if reset:
        _STEP_MS.clear()
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(rctx.device)
        return None
    return list(_STEP_MS), torch.cuda.max_memory_allocated(rctx.device) / 1e9


def _row_rel(got, want):
    """The largest relative L2 error of a row (over the last dim)."""
    dd = (got.float() - want.float()).square().sum(-1)
    rr = want.float().square().sum(-1)
    return float((dd / rr.clamp_min(1e-30)).sqrt().max())


def phase_sharded_model(pool, dev, label):
    """Phase 14: the sharded model over the 4 ranks as a 2×2 mesh — (a)
    ``ef_int8_psum``, (b) Phi-3-mini (2 layers) loss and gradients with
    two planted faults, (c) Mixtral-8x7B's MoE block (1 layer) through the
    three dispatches, (d) Mamba2-130M whole, (e) ``train(mesh=)``.
    Returns the kernel launches the ranks made on the counted paths."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import train
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import rms_norm
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    where = f"mesh {SHARD_MESH[0]}x{SHARD_MESH[1]} (data x model) of {RANKS} ranks"
    launches = {}

    # (a) ef_int8_psum
    out = pool.run(ef_job, EF_SHAPE, EF_REPS)
    for r, o in enumerate(out):
        check(o["err"] < o["scale"] / 32 and o["resid"] <= o["scale"] / 64,
              f"ef_int8_psum rank {r}: error {o['err']} (limit scale/32 = "
              f"{o['scale'] / 32}), residual {o['resid']} (limit "
              f"{o['scale'] / 64})")
    print(f"phase 14 (a) ef_int8_psum ({where}, over all {RANKS} ranks): a "
          f"{EF_SHAPE} f32 leaf a rank, mean error "
          f"{max(o['err'] for o in out):.4e} < scale/32 = "
          f"{out[0]['scale'] / 32:.4e}, residual "
          f"{max(o['resid'] for o in out):.4e} <= scale/64; ms per call by "
          f"rank {json.dumps([[round(m, 3) for m in o['ms']] for o in out])}"
          f"; {out[0]['staged']} host moves a call a rank; {label}",
          flush=True)

    # (b) Phi-3-mini at full width, 2 layers
    run = SHARD_PHI3
    cfg = _shard_cfg(run["arch"], run["layers"])
    B, S = run["loss"]
    params = init_params(cfg, SHARD_SEED, device=dev)
    with torch.no_grad():
        want = float(loss_fn(params, _shard_batch(cfg, B, S, dev), cfg)[0])
    del params
    free_device_memory()
    pool.reset_counts()
    out = pool.run(sharded_model_job, cfg, B, S, False)
    fa_fwd = pool.launches["fa"]
    got = out[0]["loss"]
    check(all(o["loss"] == got for o in out), "the ranks' losses differ")
    check(abs(got - want) <= SHARD_RTOL * abs(want),
          f"sharded {cfg.name} bf16 loss {got} vs one device {want}")
    print(f"phase 14 (b) {cfg.name} full width, {cfg.n_layers} layers, bf16 "
          f"loss {B} x {S} ({where}): {got:.6f} against one device "
          f"{want:.6f} (rtol {abs(got - want) / abs(want):.3e}, limit "
          f"{SHARD_RTOL}); ms by rank {json.dumps([round(o['ms'], 1) for o in out])}"
          f", host moves {out[0]['staged']} a rank, peak GB by rank "
          f"{json.dumps([round(o['peak_gb'], 3) for o in out])}; FA forward "
          f"launches {fa_fwd} from the ranks; {label}", flush=True)

    cfg32 = cfg.replace(dtype="float32")
    B, S = run["grads"]
    params = init_params(cfg32, SHARD_SEED, device=dev)
    _, _, wgrads = loss_and_grads(params, _shard_batch(cfg32, B, S, dev), cfg32)
    want_g = [w.cpu() for w in tree_leaves(wgrads)]
    del params, wgrads
    free_device_memory()
    pool.reset_counts()
    out = pool.run(sharded_model_job, cfg32, B, S, True)
    counts = dict(pool.launches)
    sound = _worst_leaf(tree_leaves(out[0]["grads"]), want_g)
    del out
    check(counts["fa"] > 0 and counts["fa_bwd"] > 0,
          f"the sharded Phi-3 runs launched {counts} in the ranks")
    check(sound <= SHARD_GRAD_TOL,
          f"sharded f32 gradients vs one device: {sound} > {SHARD_GRAD_TOL}")
    launches["fa"] = fa_fwd + counts["fa"]
    launches["fa_bwd"] = counts["fa_bwd"]
    faults = {}
    for fault in SHARD_FAULTS:
        out = pool.run(sharded_model_job, cfg32, B, S, True, fault)
        faults[fault] = _worst_leaf(tree_leaves(out[0]["grads"]), want_g)
        del out
    del want_g
    weakest = min(faults, key=faults.get)
    print(f"phase 14 (b) {cfg.name} f32 gradients {B} x {S} ({where}), "
          f"gathered with gather_tree: worst leaf max |diff| / max |g| "
          f"{sound:.3e} (limit {SHARD_GRAD_TOL}); FA forward / backward "
          f"launches from the ranks {counts['fa']} / {counts['fa_bwd']}; "
          f"planted faults: " + ", ".join(f"'{k}' {v:.3e}" for k, v in
                                          faults.items())
          + f"; weakest '{weakest}' {faults[weakest]:.3e}", flush=True)
    for fault, err in faults.items():
        check(err > SHARD_GRAD_TOL, f"planted fault {fault!r} passed the "
              f"gradient check ({err} <= {SHARD_GRAD_TOL})")

    # (c) Mixtral-8x7B at full width, 1 layer, forward
    run = SHARD_MIXTRAL
    cfg = _shard_cfg(run["arch"], run["layers"])
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)  # nothing drops
    B, S = run["tokens"]
    params = init_params(cfg, SHARD_SEED, device=dev)
    blk = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = _moe_input(cfg, B, S, dev)
    with torch.no_grad():
        h = rms_norm(x, params["blocks"]["norm2"][0], cfg.norm_eps)
        tokens = h.reshape(-1, cfg.d_model)
        gates, ids, _ = moe_mod._route(tokens, blk["router"], cfg.top_k)
        want_out = (x + moe_mod._moe_grouped(tokens, blk, gates, ids, cfg)
                    .to(x.dtype).reshape(x.shape)).cpu()
        want = float(loss_fn(params, _shard_batch(cfg, B, S, dev), cfg)[0])
    del params, blk, x, h, tokens
    free_device_memory()
    out = pool.run(sharded_moe_job, cfg, B, S)
    errs = {b: _row_rel(o, want_out) for b, o in out[0]["outs"].items()}
    got = out[0]["loss"]
    print(f"phase 14 (c) {cfg.name} full width, 1 layer, MoE block over "
          f"{B} x {S} tokens ({where}: ep, {cfg.n_experts // SHARD_MESH[1]} "
          f"experts a model rank), capacity_factor {cfg.capacity_factor}: "
          f"worst row relative L2 against the one-device dropless "
          f"_moe_grouped " + ", ".join(f"{b} {e:.3e}" for b, e in errs.items())
          + f" (limit {SHARD_MOE_TOL}); ms by rank " + json.dumps(
              {b: [round(o["ms"][b], 1) for o in out] for b in errs})
          + f"; loss {got:.6f} against one device {want:.6f} (rtol "
          f"{abs(got - want) / abs(want):.3e}); peak GB by rank after the "
          f"shards were cut: MoE block {json.dumps([round(o['peak_ffn_gb'], 3) for o in out])}"
          f", with the loss {json.dumps([round(o['peak_gb'], 3) for o in out])}"
          f"; host moves {out[0]['staged']} a rank; {label}", flush=True)
    for b, e in errs.items():
        check(e <= SHARD_MOE_TOL, f"sharded MoE {b}: {e} > {SHARD_MOE_TOL}")
    check(abs(got - want) <= SHARD_RTOL * abs(want),
          f"sharded {cfg.name} loss {got} vs one device {want}")
    del out, want_out
    free_device_memory()

    # (d) Mamba2-130M whole
    run = SHARD_MAMBA2
    cfg = _shard_cfg(run["arch"])
    B, S = run["loss"]
    params = init_params(cfg, SHARD_SEED, device=dev)
    with torch.no_grad():
        want = float(loss_fn(params, _shard_batch(cfg, B, S, dev), cfg)[0])
    del params
    free_device_memory()
    pool.reset_counts()
    out = pool.run(sharded_model_job, cfg, B, S, True)
    counts = dict(pool.launches)
    got = out[0]["loss"]
    del out
    launches["ssd"], launches["ssd_bwd"] = counts["ssd"], counts["ssd_bwd"]
    print(f"phase 14 (d) {cfg.name} whole ({cfg.n_layers} layers, d "
          f"{cfg.d_model}), bf16 loss and gradients {B} x {S} ({where}): "
          f"loss {got:.6f} against one device {want:.6f} (rtol "
          f"{abs(got - want) / abs(want):.3e}, limit {SHARD_RTOL}); SSD "
          f"forward / backward launches from the ranks {counts['ssd']} / "
          f"{counts['ssd_bwd']}; {label}", flush=True)
    check(abs(got - want) <= SHARD_RTOL * abs(want),
          f"sharded {cfg.name} loss {got} vs one device {want}")
    check(counts["ssd"] > 0 and counts["ssd_bwd"] > 0,
          f"the sharded Mamba2 run launched {counts} in the ranks")

    # (e) train(mesh=) on (b)'s Phi-3
    cfg = _shard_cfg(SHARD_PHI3["arch"], SHARD_PHI3["layers"])
    kw = dict(SHARD_TRAIN, ckpt_dir=None, seed=SHARD_SEED)
    _, want = train(cfg, device=dev, **kw)
    free_device_memory()
    pool.run(step_times_job, True)
    pool.reset_counts()
    t0 = time.perf_counter()
    _, got = train(cfg, mesh=make_test_mesh(*SHARD_MESH), transport=RANK_TRANSPORT,
                   wrap_step=StepTimer(), **kw)
    wall = time.perf_counter() - t0
    staged = pool.staged
    times = pool.run(step_times_job, False)
    for k in ("fa", "fa_bwd"):
        launches[k] += pool.launches[k]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"phase 14 (e) train(mesh=make_test_mesh{SHARD_MESH}, transport="
          f"{RANK_TRANSPORT!r}) {cfg.name} {cfg.n_layers} layers, "
          f"{SHARD_TRAIN['steps']} steps of {SHARD_TRAIN['batch']} x "
          f"{SHARD_TRAIN['seq']}: losses {json.dumps([round(v, 6) for v in got])}"
          f" against one device {json.dumps([round(v, 6) for v in want])} "
          f"(worst rtol {rel:.3e}, limit {SHARD_RTOL}); ms per step by rank "
          f"{json.dumps([[round(m, 1) for m in t[0]] for t in times])}; host "
          f"moves per step {staged / SHARD_TRAIN['steps']:.0f} (all ranks); "
          f"peak GB by rank {json.dumps([round(t[1], 3) for t in times])}; "
          f"call wall {wall:.1f} s (init, shard, steps, gather); FA forward / "
          f"backward launches from the ranks {pool.launches['fa']} / "
          f"{pool.launches['fa_bwd']}; {label}", flush=True)
    check(rel <= SHARD_RTOL, f"train(mesh=) losses {got} vs one device {want}")
    free_device_memory()
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 15: serving and gradients over the mesh, and the dry run
# ---------------------------------------------------------------------------
# The same 4 ranks on cuda:0 over gloo: ring attention's gradient at
# Phi-3-mini's attention width, sharded prefill and decode on the 2×2
# mesh, the dry run's accounting against the real ranks, and the
# production table of the dry run (the meta device: it touches no card).
# One card time-sliced by 4 processes: no time here is a multi-GPU speed.
RING_GRAD_CHECKS = [None, 512]     # windows of the S=2048 checks (causal)
RING_GRAD_S = 2048
RING_GRAD_BIG = RING_S             # phase 13's shape, 4096 a rank
RING_GRAD_SEED = 17                # dO's generator
RING_GRAD_HOPS = RANKS * (RANKS + 1) // 2   # FA backward launches a causal ring
# Planted faults of the backward ring, each a substitution in
# ring_attention.py's text, run in the ranks beside the real module: each
# must fail the S=2048 causal check.
RING_GRAD_FAULTS = {
    "each hop's own statistics": (
        "st = stats      # the global m and 1/l: P is the ring's probability",
        "st = fa.fa_forward_with_stats(qt, kt, vt, causal=causal, "
        "window=window, q_offset=off)[1]"),
    "dk, dv left one hop short of their owner": (
        "dk, dv = ring_send(acc, group)      # home: the accumulators' n-th send",
        "dk, dv = acc"),
    "Δ from the hop's partial output": (
        "oh = ot         # the ring's output: Δ = rowsum(do ∘ o) is global",
        "oh = fa.fa_forward_with_stats(qt, kt, vt, causal=causal, "
        "window=window, q_offset=off)[0]"),
}
SERVE_ARCHS = {"phi3-mini-3.8b": 2, "mamba2-130m": None}   # arch: layers (None: all)
SERVE_BF16 = dict(batch=4, seq=2048, steps=8)
SERVE_F32 = dict(batch=4, seq=512, steps=4)
SERVE_BF16_TOL = 2e-2          # row-wise relative L2, logits and cache
SERVE_F32_TOL = 1e-4           # of each logits row's max |.|
SERVE_SEED = 23
SERVE_FAULTS = {
    "attention output's model-group sum left out": (
        "repro_torch.models.model",
        "        out = psum_compat(out, ctx.model)\n    return out, new_cache",
        "        out = out\n    return out, new_cache"),
}
ACCOUNT_CELLS = {"train": (4, 1024), "decode": (4, 2048)}   # kind: (B, S)
DRY_CELLS = (66, 14)           # LOWERED and SKIP records of the 80


def _ring_do(S, dev):
    """The output gradient dO of the ring at sequence length S (a seeded
    generator on the card, the same in every process)."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[RING_ARCH]
    gen = torch.Generator(device=dev).manual_seed(RING_GRAD_SEED)
    return torch.randn((RING_B, S, cfg.n_heads, cfg.head_dim), generator=gen,
                       device=dev).to(torch.bfloat16)


def ring_grad_job(ctx, S, window, fault=None, split=False):
    """Phase 15 (a), in each rank: this rank's shard through
    ``ring_attention`` with q, k, v requiring grad (``RingAttentionFn``),
    then the backward of (out · dO).sum(): forward and backward timed, the
    gradients on the host.  ``fault`` runs a planted fault's module;
    ``split`` also times the backward's hops through the kernel alone and
    its exchanges alone."""
    import importlib
    from repro_torch.core import dchannel
    from repro_torch.kernels import flash_attention as fa
    ra = importlib.import_module("repro_torch.parallel.ring_attention")
    if fault is not None:
        ra = _faulty_ring_module(ra, fault, RING_GRAD_FAULTS)
    before = (fa.launch_count(), fa.bwd_launch_count())
    grp, s, me = ctx.world_group, S // ctx.world, ctx.rank
    q, k, v = (t.requires_grad_() for t in _ring_shard(ctx, S))
    do = _ring_do(S, ctx.device)[:, me * s:(me + 1) * s].contiguous()
    staged = ctx.staged
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ra.ring_attention(q, k, v, group=grp, causal=True, window=window)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.backward(out, do)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = {"fwd_ms": (t1 - t0) * 1e3, "bwd_ms": (t2 - t1) * 1e3,
           "staged": ctx.staged - staged,
           # the ring's own launches (the split's timing calls come after)
           "fa": fa.launch_count() - before[0],
           "fa_bwd": fa.bwd_launch_count() - before[1],
           "grads": [t.grad.cpu() for t in (q, k, v)],
           "finite": all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))}
    if split:
        qd, kd, vd = (t.detach() for t in (q, k, v))
        with torch.no_grad():
            o, stats = ra._ring_merge(qd, kd, vd, group=grp, causal=True,
                                      window=window)
            qt, ot, dot = (t.transpose(1, 2) for t in (qd, o, do))
            kt, vt = kd.transpose(1, 2), vd.transpose(1, 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for src in range(me + 1):
                ra._bwd_hop(qt, kt, vt, ot, dot, stats, causal=True,
                            window=window, q_offset=(me - src) * s)
            torch.cuda.synchronize()
            res["kernels_ms"] = (time.perf_counter() - t0) * 1e3
            acc = (torch.zeros(kd.shape, device=kd.device),
                   torch.zeros(vd.shape, device=vd.device))
            block, staged = (kd, vd), ctx.staged
            t0 = time.perf_counter()
            for h in range(ctx.world):
                arrive = dchannel.ring_post(block, grp) \
                    if h + 1 < ctx.world else None
                acc = dchannel.ring_send(acc, grp)
                if arrive is not None:
                    block = arrive()
            torch.cuda.synchronize()
            res["exchange_ms"] = (time.perf_counter() - t0) * 1e3
            res["exchange_staged"] = ctx.staged - staged
    return res


def _ring_grad_reference(S, window, dev, fa):
    """The one-device gradients of (out · dO).sum() on the card, as
    (B, S, H, D) float32 on the host: at S=2048 ``fa_backward_plain`` in
    float32 on the bf16 inputs (with ``fa_plain``'s output), at the big
    shape the bf16 ``flash_attention`` through ``FlashAttentionFn``."""
    q, k, v = _ring_inputs(S, dev)
    do = _ring_do(S, dev)
    if S == RING_GRAD_BIG:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = fa.flash_attention(qt, kt, vt, causal=True, window=window)
        torch.autograd.backward(out, do.transpose(1, 2))
        grads = [t.grad for t in (qt, kt, vt)]
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        qt, kt, vt, dot = (t.float().transpose(1, 2) for t in (q, k, v, do))
        o = fa.fa_plain(qt, kt, vt, causal=True, window=window)
        grads = fa.fa_backward_plain(qt, kt, vt, o, dot, causal=True,
                                     window=window)
    return [g.transpose(1, 2).float().cpu() for g in grads]


def _rel_l2(got, want):
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _ring_grad_errs(out, want):
    """The gathered gradients of ``ring_grad_job``'s replies against
    ``want`` by phase 10's rule for bf16 gradients: for dq, dk, dv, max
    |diff| over max |want| and the relative L2 of the whole tensor (each
    must be within ``BF16_GRAD_REL``), and the worst row's relative L2
    (printed: rows whose gradient nearly cancels have a norm near 0)."""
    errs = []
    for i in range(3):
        got = torch.cat([o["grads"][i] for o in out], dim=1).float()
        errs.append({"max": float((got - want[i]).abs().max()
                                  / want[i].abs().max()),
                     "l2": _rel_l2(got, want[i]),
                     "row": _ring_error(got, want[i])["row_max"]})
    return errs


def _worst(errs):
    return max(max(e["max"], e["l2"]) for e in errs)


def _fmt_errs(errs):
    return ", ".join(f"d{n} {e['max']:.3e} / {e['l2']:.3e} (worst row "
                     f"{e['row']:.3e})" for n, e in zip("qkv", errs))


def phase_ring_gradient(pool, dev, where, label):
    """Phase 15 (a): ring attention's gradient at Phi-3-mini's attention
    width over the 4 ranks.  Returns the FA forward and backward launches
    the ranks made."""
    from repro_torch.kernels import flash_attention as fa
    launches = {"fa": 0, "fa_bwd": 0}
    sound = {}
    for window in RING_GRAD_CHECKS:
        want = _ring_grad_reference(RING_GRAD_S, window, dev, fa)
        pool.reset_counts()
        out = pool.run(ring_grad_job, RING_GRAD_S, window)
        counts = dict(pool.launches)
        check(counts["fa_bwd"] == RING_GRAD_HOPS,
              f"ring backward at S={RING_GRAD_S} window {window} launched "
              f"{counts['fa_bwd']} FA backward kernels in the ranks, expected "
              f"{RING_GRAD_HOPS}")
        for k in launches:
            launches[k] += counts[k]
        errs = _ring_grad_errs(out, want)
        sound[window] = _worst(errs)
        check(all(o["finite"] for o in out) and sound[window] <= BF16_GRAD_REL,
              f"ring gradients at S={RING_GRAD_S} window {window}: "
              f"{_fmt_errs(errs)} (limit {BF16_GRAD_REL})")
        print(f"phase 15 (a) ring attention gradient ({where}): {RING_ARCH}'s "
              f"attention, B={RING_B} S={RING_GRAD_S} causal window {window} "
              f"bf16: dq, dk, dv of (out · dO).sum() gathered against the "
              f"one-device float32 fa_backward_plain, max |diff| / max |plain| "
              f"and relative L2 {_fmt_errs(errs)} (limit {BF16_GRAD_REL} each, "
              f"phase 10's bf16 gradient rule); FA backward launches from the "
              f"ranks {counts['fa_bwd']} (1+2+3+4), forward {counts['fa']}; ms "
              f"by rank forward {json.dumps([round(o['fwd_ms'], 2) for o in out])}"
              f", backward {json.dumps([round(o['bwd_ms'], 2) for o in out])}"
              f"; {label}", flush=True)
        del out, want

    # the planted faults of the backward ring, against the causal check
    want = _ring_grad_reference(RING_GRAD_S, None, dev, fa)
    faults = {}
    for fault in RING_GRAD_FAULTS:
        out = pool.run(ring_grad_job, RING_GRAD_S, None, fault)
        faults[fault] = _worst(_ring_grad_errs(out, want))
        check(faults[fault] > BF16_GRAD_REL, f"planted fault {fault!r} passes "
              f"the ring gradient check ({faults[fault]:.3e} <= {BF16_GRAD_REL})")
    weakest = min(faults, key=faults.get)
    print(f"phase 15 (a) ring gradient planted faults at S={RING_GRAD_S} "
          f"causal, worst of max |diff| / max |plain| and relative L2: sound "
          f"{sound[None]:.3e}; " + ", ".join(
              f"'{k}' {v:.3e}" for k, v in faults.items())
          + f"; weakest '{weakest}' {faults[weakest]:.3e} (limit "
          f"{BF16_GRAD_REL}); {label}", flush=True)
    del want

    # phase 13's shape against the one-device bf16 FA gradient
    want = _ring_grad_reference(RING_GRAD_BIG, None, dev, fa)
    free_device_memory()
    out = pool.run(ring_grad_job, RING_GRAD_BIG, None, None, True)
    counts = {k: sum(o[k] for o in out) for k in ("fa", "fa_bwd")}
    errs = [_rel_l2(torch.cat([o["grads"][i] for o in out], dim=1), want[i])
            for i in range(3)]
    del want
    check(counts["fa_bwd"] == RING_GRAD_HOPS,
          f"ring backward at S={RING_GRAD_BIG} launched {counts['fa_bwd']} FA "
          f"backward kernels in the ranks, expected {RING_GRAD_HOPS}")
    check(all(o["finite"] for o in out) and max(errs) <= RING_REL_TOL,
          f"ring gradients at S={RING_GRAD_BIG}: relative L2 {errs} against "
          f"the one-device bf16 FlashAttentionFn gradient (limit "
          f"{RING_REL_TOL})")
    for k in launches:
        launches[k] += counts[k]
    print(f"phase 15 (a) ring attention gradient ({where}): B={RING_B} "
          f"S={RING_GRAD_BIG} ({RING_GRAD_BIG // RANKS} a rank) causal bf16: "
          f"relative L2 against the one-device bf16 flash_attention gradient "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(("dq", "dk", "dv"), errs))
          + f" (limit {RING_REL_TOL}); FA backward launches {counts['fa_bwd']}"
          f"; ms per backward ring by rank "
          f"{json.dumps([round(o['bwd_ms'], 2) for o in out])} (forward "
          f"{json.dumps([round(o['fwd_ms'], 2) for o in out])}); split by "
          f"rank: the rank's backward hops through the kernel alone "
          f"{json.dumps([round(o['kernels_ms'], 3) for o in out])} ms, the "
          f"blocks and accumulators circulating with no body "
          f"{json.dumps([round(o['exchange_ms'], 2) for o in out])} ms "
          f"({out[0]['exchange_staged']} host moves); {label}", flush=True)
    return launches


def _serve_inputs(cfg, B, S, steps, dev):
    """The prompt (B, S) and each decode step's tokens (B, 1), from a
    seeded generator on the card (the same in every process)."""
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    tok = lambda s: {"tokens": torch.randint(  # noqa: E731
        0, cfg.vocab_size, (B, s), generator=gen, device=dev)}
    return tok(S), [tok(1) for _ in range(steps)]


def _serve(M, params, cfg, prompt, steps, S, cut=lambda b: b):
    """``prefill`` then a ``decode_step`` for each of ``steps``, timed:
    (logits of every call, cache, prefill ms, ms of each decode step)."""
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = M.prefill(params, cut(prompt), cfg)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        cache = _pad_cache(cache, len(steps))
        outs, dec_ms = [logits], []
        for t, step in enumerate(steps):
            t0 = time.perf_counter()
            logits, cache = M.decode_step(params, cut(step), cache, S + t, cfg)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(logits)
    return outs, cache, pre_ms, dec_ms


def serve_job(rctx, cfg, B, S, steps, fault=None):
    """Phase 15 (b), in each rank: ``prefill`` then ``steps`` decode steps
    of this rank's shards and rows on the 2×2 mesh, timed; its logits
    rows of every call on the host, and the cache gathered to rank 0."""
    from repro_torch.models import model as M
    from repro_torch.parallel import rules
    dev = rctx.device
    with _planted(fault, SERVE_FAULTS), _mesh_ctx() as mc:
        local, _ = _local_params(mc, cfg, dev)
        prompt, step_in = _serve_inputs(cfg, B, S, steps, dev)
        plan = rules.batch_shardings(mc, cfg, B)
        cut = lambda b: rules.shard_tree(b, {k: plan[k] for k in b})  # noqa: E731
        staged = rctx.staged
        outs, cache, pre_ms, dec_ms = _serve(M, local, cfg, prompt, step_in,
                                             S, cut)
        res = {"logits": [o.float().cpu() for o in outs], "prefill_ms": pre_ms,
               "decode_ms": dec_ms, "staged": rctx.staged - staged,
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "rows": (mc.data.rank * (B // mc.dp_size),
                        (mc.data.rank + 1) * (B // mc.dp_size))}
        full = rules.gather_cache(cfg, cache, mc, B)
        if rctx.rank == 0:
            res["cache"] = {k: v.cpu() for k, v in full.items()}
    return res


def _row_max_rel(got, want):
    """The largest |got - want| of a row over its row's largest |want|."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def phase_sharded_serving(pool, dev, where, label):
    """Phase 15 (b): sharded ``prefill`` and ``decode_step`` of Phi-3-mini
    (2 layers) and Mamba2-130M (whole) on the 2×2 mesh, bf16 and f32,
    against one device on the card, and a planted fault.  Returns the FA
    and SSD launches the ranks made."""
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    launches = {"fa": 0, "ssd": 0}
    for arch, layers in SERVE_ARCHS.items():
        for run, dtype in ((SERVE_BF16, "bfloat16"), (SERVE_F32, "float32")):
            cfg = _shard_cfg(arch, layers, dtype=dtype)
            B, S, steps = run["batch"], run["seq"], run["steps"]
            params = init_params(cfg, SHARD_SEED, device=dev)
            prompt, step_in = _serve_inputs(cfg, B, S, steps, dev)
            want, want_cache, pre_ms, dec_ms = _serve(M, params, cfg, prompt,
                                                      step_in, S)
            want = [w.float().cpu() for w in want]
            want_cache = {k: v.cpu() for k, v in want_cache.items()}
            del params, prompt, step_in
            free_device_memory()
            pool.reset_counts()
            out = pool.run(serve_job, cfg, B, S, steps)
            counts = dict(pool.launches)
            for k in launches:
                launches[k] += counts[k]
            errs = []
            for o in out:
                lo, hi = o["rows"]
                for g, w in zip(o["logits"], want):
                    errs.append(_row_rel(g, w[lo:hi]) if dtype == "bfloat16"
                                else _row_max_rel(g, w[lo:hi]))
            tol = SERVE_BF16_TOL if dtype == "bfloat16" else SERVE_F32_TOL
            # bf16: row-wise relative L2; f32: max |diff| over max |entry|
            # of each leaf (an SSM state row can decay to a norm near 0)
            c_err = max(_row_rel(out[0]["cache"][k], want_cache[k])
                        if dtype == "bfloat16" else
                        float((out[0]["cache"][k].float() - want_cache[k].float())
                              .abs().max() / want_cache[k].float().abs().max())
                        for k in want_cache)
            kern = "fa" if cfg.family != "ssm" else "ssd"
            check(counts[kern] > 0, f"sharded {arch} serving launched "
                  f"{counts} in the ranks; expected {kern} launches")
            check(max(errs) <= tol, f"sharded {arch} {dtype} logits: "
                  f"{max(errs)} > {tol}")
            if dtype == "bfloat16":
                check(c_err <= tol, f"sharded {arch} bf16 cache: {c_err} > {tol}")
            what = ("row-wise relative L2" if dtype == "bfloat16" else
                    "max |diff| of a row over its max |logit|")
            print(f"phase 15 (b) sharded serving {arch} full width, "
                  f"{cfg.n_layers} layers, {dtype} ({where}): prefill {B} x "
                  f"{S} then {steps} decode steps, each rank's logits rows "
                  f"against one device: worst {what} {max(errs):.3e} (limit "
                  f"{tol}); gathered cache "
                  f"{'row-wise relative L2' if dtype == 'bfloat16' else 'max |diff| / max |entry|'}"
                  f" {c_err:.3e}; "
                  f"{kern.upper()} launches from the ranks {counts[kern]}; ms "
                  f"per prefill by rank "
                  f"{json.dumps([round(o['prefill_ms'], 1) for o in out])} "
                  f"(one device {pre_ms:.1f}), ms per decode step by rank "
                  f"{json.dumps([round(sum(o['decode_ms']) / steps, 1) for o in out])}"
                  f" (one device {sum(dec_ms) / steps:.1f}); host moves per "
                  f"decode step a rank ~{out[0]['staged'] / (steps + 1):.0f} "
                  f"(prefill included); peak GB by rank "
                  f"{json.dumps([round(o['peak_gb'], 3) for o in out])}; "
                  f"{label}", flush=True)
            if arch == "phi3-mini-3.8b" and dtype == "float32":
                for fault in SERVE_FAULTS:
                    bad = pool.run(serve_job, cfg, B, S, steps, fault)
                    f_err = max(_row_max_rel(g, w[o["rows"][0]:o["rows"][1]])
                                for o in bad for g, w in zip(o["logits"], want))
                    check(f_err > tol, f"planted fault {fault!r} passes the "
                          f"sharded serving check ({f_err} <= {tol})")
                    print(f"phase 15 (b) planted fault '{fault}': worst "
                          f"{f_err:.3e} against the limit {tol} (sound "
                          f"{max(errs):.3e})", flush=True)
                    del bad
            del out, want, want_cache
            free_device_memory()
    return launches


def account_job(rctx, cfg, kind, B, S):
    """Phase 15 (c), in each rank: the dry run's cell run for real on this
    rank of the 2×2 mesh: the bytes of its arguments, the collectives it
    issued by kind, the step's ms and the card's peak allocation over the
    arguments during it."""
    from repro_torch.configs import ShapeCell
    from repro_torch.core import dchannel
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import rules
    from repro_torch.tree import tree_leaves
    dev = rctx.device
    shape = ShapeCell(kind, S, B, kind)
    with _mesh_ctx() as mc:
        scfg = steps.serve_cfg(cfg, shape, mc)
        specs = steps.input_specs(scfg, shape, mc)
        fn, names = steps.step_fn_for(scfg, shape, mc)
        params, _ = _local_params(mc, scfg, dev)
        gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
        real = {"params": params, "batch": {
            k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                             device=dev, dtype=v.dtype)
            for k, v in specs["batch"].items()}}
        if "opt_state" in names:
            real["opt_state"] = adamw_init(params,
                                           getattr(torch, scfg.optimizer_dtype))
        if "cache" in names:
            real["cache"] = M.init_cache(scfg, B, S, device=dev)
            real["cache_len"] = specs["cache_len"]
        args = [real[n] for n in names]
        tensors = tree_leaves({n: real[n] for n in names if n != "cache_len"})
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        free_device_memory()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with dchannel.tally() as t:
            fn(*args)
        torch.cuda.synchronize()
        return {"bytes": nbytes, "kinds": t.kinds(),
                "ms": (time.perf_counter() - t0) * 1e3,
                "peak_delta": torch.cuda.max_memory_allocated(dev) - base}


def phase_dry_run(pool, where, label):
    """Phase 15 (c) and (d): ``launch.dryrun._account`` on the 2×2 mesh
    over gloo against the same cells on the 4 ranks, then the production
    table (``run_cell(compile_=False)``, every cell of both meshes)."""
    from repro_torch.configs import ARCHS, SHAPES, ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import param_count
    cfg = _shard_cfg("phi3-mini-3.8b", SERVE_ARCHS["phi3-mini-3.8b"])
    n_params = param_count(cfg)
    for kind, (B, S) in ACCOUNT_CELLS.items():
        t0 = time.perf_counter()
        rec = dryrun._account(cfg, ShapeCell(kind, S, B, kind),
                              make_test_mesh(*SHARD_MESH), ("data",), "gloo")
        meta_s = time.perf_counter() - t0
        out = pool.run(account_job, cfg, kind, B, S)
        for r, o in enumerate(out):
            check(o["bytes"] == rec["argument_size"],
                  f"dry run {kind}: argument_size {rec['argument_size']} but "
                  f"rank {r} holds {o['bytes']} bytes")
            check(o["kinds"] == rec["collectives"],
                  f"dry run {kind}: tally {rec['collectives']} but rank {r} "
                  f"issued {o['kinds']}")
        tokens = B * (S if kind == "train" else 1)
        rule = (6 if kind == "train" else 2) * n_params * tokens / RANKS
        coll = {k: (v["count"], v["bytes"]) for k, v in rec["collectives"].items()
                if v["count"]}
        print(f"phase 15 (c) dry run against the ranks ({where}): {cfg.name} "
              f"{cfg.n_layers} layers, {kind} B={B} S={S}: argument_size "
              f"{rec['argument_size']} = each rank's bytes; collectives "
              f"(count, bytes) {json.dumps(coll)} = each rank's tally; "
              f"flops_per_device {rec['flops_per_device']:.4e} beside "
              f"{6 if kind == 'train' else 2}·N·tokens/{RANKS} {rule:.4e} "
              f"(ratio {rec['flops_per_device'] / rule:.3f}); temp_size "
              f"{rec['temp_size']} beside each rank's peak allocation over "
              f"its arguments {json.dumps([o['peak_delta'] for o in out])} "
              f"(ratio {rec['temp_size'] / max(1, max(o['peak_delta'] for o in out)):.3f}"
              f"); meta run {meta_s:.2f} s, ms by rank "
              f"{json.dumps([round(o['ms'], 1) for o in out])}; {label}",
              flush=True)
        del out
        free_device_memory()
    t0 = time.perf_counter()
    recs = [dryrun.run_cell(a, s.name, mp, compile_=False)
            for mp in (False, True) for a in sorted(ARCHS) for s in SHAPES]
    status = {k: sum(r["status"] == k for r in recs)
              for k in ("LOWERED", "SKIP", "FAIL")}
    big = max((r for r in recs if r["status"] == "LOWERED"),
              key=lambda r: r["argument_size"])
    check(status["FAIL"] == 0 and (status["LOWERED"], status["SKIP"]) == DRY_CELLS,
          f"dry run production table: {status}, expected {DRY_CELLS[0]} "
          f"LOWERED and {DRY_CELLS[1]} SKIP")
    print(f"phase 15 (d) dry run production table (meta device, no card): "
          f"{len(recs)} records over 16x16 and 2x16x16, {status['LOWERED']} "
          f"LOWERED / {status['SKIP']} SKIP / {status['FAIL']} FAIL; largest "
          f"argument_size a rank {big['argument_size']} bytes ({big['arch']} "
          f"{big['shape']} {big['mesh']}), {sum(r['status'] == 'LOWERED' and r['argument_size'] > 80e9 for r in recs)} "
          f"cells over 80 GB in arguments alone; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_mesh_serving(pool, dev, label):
    """Phase 15: (a) ring attention's gradient, (b) sharded serving, (c)
    the dry run's accounting against the ranks, (d) the production table.
    Returns the kernel launches the ranks made."""
    t_phase = time.perf_counter()
    where = f"world {RANKS}, transport {RANK_TRANSPORT}"
    ring = phase_ring_gradient(pool, dev, where, label)
    free_device_memory()
    serving = phase_sharded_serving(
        pool, dev, f"mesh {SHARD_MESH[0]}x{SHARD_MESH[1]} (data x model) of "
        f"{RANKS} ranks", label)
    phase_dry_run(pool, where, label)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"ring_fa": ring["fa"], "ring_fa_bwd": ring["fa_bwd"],
            "serve_fa": serving["fa"], "serve_ssd": serving["ssd"]}



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
    from repro_torch.kernels import gated_norm as gn
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
    model_rows["fa224"] = fa224_timing(dev, fa)
    model_rows["gated_norm"] = gated_norm_timing(dev, gn)
    gn_path = gated_norm_main_path(dev)
    families = phase_families(dev)
    training = phase_training(dev, fa, ssd)
    keyed_launches, keyed_ctx = phase_keyed(dev, sw, ops, core, queries,
                                            smi_line)
    tuned_launches, farm_launches, mesh_wants = phase_device_backend(
        dev, sw, ops, core, keyed_ctx, chunked_main, runs, db, queries,
        smi_line)
    ranked = phase_ranks(dev, sw, ops, core, keyed_ctx, runs, db, queries,
                         mesh_wants, smi_line)

    main_row = next(r for r in rows if r["b"] == TIMING_CHUNK and r["q"] == 1000)
    kernels = [{
        "name": "sw", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches + chunked_launches + keyed_launches
        + tuned_launches + farm_launches + ranked["sw"],
        "launches_by_path": {"one-subject farm": launches,
                             "chunked search": chunked_launches,
                             "keyed aggregation": keyed_launches,
                             "tuned chunked search": tuned_launches,
                             "device farm": farm_launches,
                             "device farm over 4 ranks": ranked["sw"]},
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
            by_path["ring attention over 4 ranks"] = ranked["fa"]
            by_path["sharded phi3 over 4 ranks"] = ranked["sharded"]["fa"]
            by_path["ring attention gradient over 4 ranks (phase 15)"] = \
                ranked["meshed"]["ring_fa"]
            by_path["sharded phi3 serving over 4 ranks (phase 15)"] = \
                ranked["meshed"]["serve_fa"]
            shapes = model_rows["fa_shapes"]
            entry.update(
                launches=sum(by_path.values()), launches_by_path=by_path,
                launches_per=f"one prefill of each path, {TRAIN_STEPS} "
                             f"phi3 and zamba2 train steps (forward and remat "
                             f"recompute), one ring attention over "
                             f"{RANKS} ranks and phase 14's sharded Phi-3 "
                             f"(bf16 loss, f32 gradients, {SHARD_TRAIN['steps']} "
                             f"train(mesh=) steps); phase 15: the ring "
                             f"attention gradient's forward rings and the "
                             f"sharded Phi-3 prefill and decode",
                max_abs_err=max(entry["max_abs_err"], *(x["err"] for x in shapes),
                                training["bwd_row"]["forward_with_stats_err"]),
                forward_with_stats_max_abs_err=training["bwd_row"][
                    "forward_with_stats_err"],
                shapes=[{k: x[k] for k in ("path", "shape", "ms", "plain_ms",
                                           "bound_ms", "bound_by", "library_ms",
                                           "library")}
                        for x in shapes + [model_rows["fa224"][FA224_FWD]]])
        else:
            by_path = {"zamba2 prefill": model_launches["ssd"],
                       "zamba2 train": training["zamba2"]["counts"]["ssd"],
                       "sharded mamba2 over 4 ranks": ranked["sharded"]["ssd"],
                       "sharded mamba2 serving over 4 ranks (phase 15)":
                           ranked["meshed"]["serve_ssd"]}
            entry.update(
                launches=sum(by_path.values()), launches_by_path=by_path,
                launches_per=f"one zamba2-2.7b prefill, {TRAIN_STEPS} "
                             f"zamba2 train steps (forward and remat recompute), "
                             f"phase 14's sharded Mamba2 loss and gradients "
                             f"and phase 15's sharded Mamba2 prefills")
        kernels.append(entry)
    r = training["bwd_row"]
    kernels.append({
        "name": "fa_bwd", "route": "cuda", "source": FA_BWD_SOURCE,
        "replaces": FA_BWD_REPLACES,
        "replaces_what": "XLA's gradient of chunked_attention: the JAX "
                         "package has no backward kernel",
        "launches": training["fa_bwd"] + training["zamba2"]["counts"]["fa_bwd"]
        + ranked["sharded"]["fa_bwd"] + ranked["meshed"]["ring_fa_bwd"],
        "launches_by_path": {"phi3 train": training["fa_bwd"],
                             "zamba2 train": training["zamba2"]["counts"]["fa_bwd"],
                             "sharded phi3 over 4 ranks": ranked["sharded"]["fa_bwd"],
                             "ring attention backward over 4 ranks (phase 15)":
                                 ranked["meshed"]["ring_fa_bwd"]},
        "launches_per": f"{TRAIN_STEPS} phi3 and {TRAIN_STEPS} zamba2 train "
                        f"steps, phase 14's sharded Phi-3 gradients and "
                        f"train(mesh=) steps, and phase 15's ring attention "
                        f"backward rings ({RING_GRAD_HOPS} a ring)",
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
        "shapes": [{k: x[k] for k in ("path", "shape", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "library")}
                   for x in (model_rows["fa224"]["backward"],)],
    })
    r = training["ssd_bwd_row"]
    kernels.append({
        "name": "ssd_bwd", "route": "cuda", "source": SSD_BWD_SOURCE,
        "replaces": SSD_BWD_REPLACES,
        "replaces_what": "XLA's gradient of ssd_chunked: the JAX package has "
                         "no backward kernel",
        "launches": training["zamba2"]["counts"]["ssd_bwd"]
        + ranked["sharded"]["ssd_bwd"],
        "launches_by_path": {"zamba2 train": training["zamba2"]["counts"]["ssd_bwd"],
                             "sharded mamba2 over 4 ranks": ranked["sharded"]["ssd_bwd"]},
        "launches_per": f"{TRAIN_STEPS} zamba2 train steps and phase 14's "
                        f"sharded Mamba2 gradients",
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
    r = model_rows["gated_norm"]
    kernels.append({
        "name": "gated_norm", "route": "cuda", "source": GN_SOURCE,
        "replaces": None,
        "replaces_what": "none: the JAX package has no Zamba2 at its published "
                         "widths; the eager f32 epilogue of models/zamba2.py's "
                         "_mixer (gated_rmsnorm_plain)",
        "launches": gn_path["forward"] + gn_path["backward"],
        "launches_by_path": {"zamba2-7b train, forward": gn_path["forward"],
                             "zamba2-7b train, backward": gn_path["backward"]},
        "launches_per": f"one zamba2-7b train step at full width, its first "
                        f"{gn_path['n_layers']} layers, remat: 2 x n_layers "
                        f"forward, n_layers backward (zamba2-train-4k's 36 "
                        f"layers: 72 and 36)",
        "kernels": "gn_fwd_kernel; backward: gn_bwd_kernel, gn_sum_kernel",
        "max_abs_err": r["forward"]["err"],
        "max_abs_err_is": "the largest gap beyond one storage spacing, of the "
                          "largest entry, over out, dy, dx, dz, dD, dgnorm",
        "ms": r["forward"]["ms"], "plain_ms": r["forward"]["plain_ms"],
        "bound_ms": r["forward"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "library": "none: no PyTorch call computes the epilogue",
        "shape": r["forward"]["shape"], "eager_autograd_backward_ms": r["eager_bwd_ms"],
        "shapes": [{k: x[k] for k in ("path", "shape", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}
                   for x in (r["forward"], r["backward"])],
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
    _stop_children()
    sys.stdout.flush()
    os._exit(rc)
