#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

The paper's application (Sec. 4.2): Smith-Waterman protein database search,
subjects streamed through an order-preserving farm whose workers score one
(query, subject) pair each with the hand-written CUDA kernel.

Phases, each on lines of its own; any failed check exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. kernel == plain PyTorch version on the card, exactly, on many shapes;
  4. the main path: a 4096-subject database through ``TaskFarm`` and
     through ``Pipeline(Farm, Stage)``, with launch counts, order and
     scores checked;
  5. kernel, plain-version and bound times at the main path's shapes;
  6. a ``kernels`` JSON line; the last line is the ``ok`` JSON.

Run from the root of a checkout:  python3 chip_smoke.py
"""
import json
import os
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
DB_SIZE = 4096                # subjects; a cut of Swiss-Prot's hundreds of thousands
MEAN_LEN = 352                # Swiss-Prot 57.5 mean sequence length
QUERY_LENS = [144, 497, 1000]  # P02232, P10635, P27895
REGIMES = [(10.0, "10-2k"), (5.0, "5-2k")]
GAP_EXTEND = 2.0
SAMPLE = 256                  # subjects checked against the plain version
OPS_PER_CELL = 15             # f32 ops per (query lane, subject char), from the .cu
PEAK_F32 = 67e12              # H100 SXM f32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s
SOURCE = "src/repro_torch/kernels/csrc/smith_waterman.cu"
REPLACES = "src/repro/kernels/smith_waterman.py:52"


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def gcups(qlen, db_cells, seconds):
    return qlen * db_cells / (seconds * 1e9)


def _watchdog(signum, frame):
    print(f"FAIL: chip_smoke exceeded {TIME_LIMIT_S} s", flush=True)
    os._exit(1)


def make_db(rng, n):
    """Subjects drawn to Swiss-Prot 57.5's statistics, as the reference
    benchmark draws them: gamma(2, 176) lengths clipped to [2, 2000],
    residues 0-19."""
    lens = np.clip(rng.gamma(2.0, MEAN_LEN / 2.0, n).astype(int), 2, 2000)
    return [rng.integers(0, 20, int(n_)).astype(np.int32) for n_ in lens]


def pad_batch(subjects, A, device):
    """(B, Dp) int32 padded with A, and (B,) int32 lengths, on ``device``."""
    dp = max(int(s.shape[0]) for s in subjects)
    out = torch.full((len(subjects), dp), A, dtype=torch.int32)
    for i, s in enumerate(subjects):
        out[i, :s.shape[0]] = torch.as_tensor(s)
    lens = torch.tensor([int(s.shape[0]) for s in subjects], dtype=torch.int32)
    return out.to(device), lens.to(device)


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
        subj, lens = pad_batch(subjects, A, dev)
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
    print(f"main path: {DB_SIZE} subjects, {db_cells} residues (a cut of the "
          f"full Swiss-Prot 57.5 release, which holds hundreds of thousands "
          f"of sequences, to keep the smoke short)", flush=True)
    queries = {q: torch.as_tensor(rng.integers(0, 20, q).astype(np.int32),
                                  device=dev) for q in QUERY_LENS}
    runs = {}
    sw.reset_launch_count()                       # --- counted window ---
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
    subj_all, lens_all = pad_batch(db, A, dev)
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
    return total_launches, runs, db_cells


def phase_timing(dev, sw, ops):
    """Per-launch kernel time at the main path's shapes, the plain
    version's, and the bound."""
    rng = np.random.default_rng(5)
    A = ops.BLOSUM50.shape[0]
    rows = []
    for qlen in (1000, 144):
        query = torch.as_tensor(rng.integers(0, 20, qlen).astype(np.int32),
                                device=dev)
        prof, q_len = ops.build_profile(query, ops.BLOSUM50.to(dev))
        dlen, dp = MEAN_LEN, 512          # padded to the 512 tile as the path does
        subj = torch.full((1, dp), A, dtype=torch.int32, device=dev)
        subj[0, :dlen] = torch.as_tensor(rng.integers(0, 20, dlen)
                                         .astype(np.int32), device=dev)
        kern = cuda_ms(lambda: sw.sw_batch(
            prof, subj, gap_open=10.0, gap_extend=GAP_EXTEND, q_len=q_len),
            iters=200, warmup=20)
        plain = cuda_ms(lambda: sw.sw_plain(
            prof, subj, 10.0, GAP_EXTEND, q_len), iters=3, warmup=1)
        cells = q_len * dlen
        t_ops = cells * OPS_PER_CELL / PEAK_F32
        t_bytes = (prof.numel() * 4 + subj.numel() * 4 + 4) / PEAK_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        rows.append(dict(q=qlen, d=dlen, ms=kern, plain_ms=plain,
                         bound_ms=bound_ms, bound_by=bound_by,
                         gcups=cells / (kern * 1e-3) / 1e9))
        print(f"timing q={qlen} d={dlen} (Dp={dp}): kernel {kern:.6f} ms/launch, "
              f"plain {plain:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
              f"kernel GCUPS {cells / (kern * 1e-3) / 1e9:.6f}, "
              f"library: none (no PyTorch call computes SW)", flush=True)
    return rows


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
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")

    from repro_torch import core
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import smith_waterman as sw
    t0 = time.perf_counter()
    _build.load("smith_waterman")
    secs, log = _build.build_info("smith_waterman")
    print(f"build smith_waterman.cu: {secs:.1f} s nvcc "
          f"({time.perf_counter() - t0:.1f} s with load)", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    cases, worst = phase_exact(dev, sw, ops, ref)
    launches, runs, _ = phase_main_path(dev, sw, ops, core)
    rows = phase_timing(dev, sw, ops)

    main_row = rows[0]
    kernels = [{
        "name": "sw", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": worst, "exact_cases": cases,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shapes": [{k: r[k] for k in ("q", "d", "ms", "plain_ms", "bound_ms",
                                      "bound_by")} for r in rows],
    }]
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
