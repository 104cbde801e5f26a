"""Card-only tests of the PyTorch port: the CUDA Smith-Waterman kernels (the
warp kernel at every Qp up to 1024, the strip kernel and the block kernel
above, each on its side of the subject count between them) held against
their plain PyTorch version on the card, exactly, and the farm search
launching them once per task or once per chunk of the database; the flash-attention kernels (bf16: wgmma with
TMA loads, on its edge cases; f32: the SIMT kernel) and the SSD kernels
(five passes per call) and their backward (eight kernels per call) against
their plain versions, on their edge cases; training steps of every family
through the kernels, forward and backward, against the CPU;
the Zamba2 smoke prefill launching both; the MoE grouped dispatch against
its dense oracle, the smoke prefill of the moe, vlm and audio families
through the FA kernel, the Mamba2 mixer's gated-norm kernels (Zamba2)
against their plain versions and in the zamba2 family's train step, CUDA
tensors crossing a procs farm on the
host (the shared-memory ring's tensor edge), and the device backend
``lower(.., "mesh")`` on the card: a Farm, a Feedback and a keyed
reduction equal to the threads backend, and a device farm of SW scores
equal to ``sw_plain``; rank processes on the card (two sharing it over
gloo: a ring hop, a device farm over two workers, ring attention through
the FA kernel against the plain hop, and its gradient through the FA
backward kernel; NCCL where there are two cards); and the FA backward
launched as the first CUDA call of autograd's thread.
They carry the ``gpu`` marker
and skip where there is no card.  This file imports neither jax nor the
reference package, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import FnNode, TaskFarm
from repro_torch.kernels import ops
from repro_torch.kernels import smith_waterman as sw

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parents[1]
GAPS = [(10.0, 2.0), (5.0, 2.0)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _codes(rng, n):
    return torch.from_numpy(rng.integers(0, 20, n).astype(np.int32))


def _across_strips(query, A=24):
    """Subjects that align across each boundary of the strip kernel's
    strips of 1024 query rows: a query segment on the diagonal through it,
    one with a vertical gap across it, one with padding codes inside."""
    q = query.cpu().numpy()
    subjects = []
    for t in range(sw.WARP_QP, len(q), sw.WARP_QP):
        seg = q[max(t - 40, 0):t + 40]
        subjects += [seg.copy(),
                     np.concatenate([q[max(t - 40, 0):t - 2], q[t + 3:t + 40]]),
                     np.insert(seg, [5, len(seg) // 2, len(seg) // 2], A + 2)]
    return subjects


# Every warp-kernel instance (Qp = 128 .. 1024), both sides of the dispatch
# (Qp 1024 and 1152), and the strip kernel with a last strip of 128 rows
# (1025, 1152, 5147), 512 (1536), 1024 - 96 (4000) and whole strips (2048,
# 8192 = MAX_QP), given enough subjects to take it.
@pytest.mark.parametrize("qlen", [1, 129, 144, 257, 385, 513, 641, 769, 897,
                                  1000, 1024, 1025, 1152, 1536, 2048, 4000,
                                  5147, 8192])
def test_kernel_equals_plain_on_card(dev, qlen):
    rng = np.random.default_rng(qlen)
    query = _codes(rng, qlen)
    prof, q_len = ops.build_profile(query.to(dev), ops.BLOSUM50.to(dev))
    subjects = [_codes(rng, n) for n in (1, 17, 352, 513)] + _across_strips(query)
    B = len(subjects) if qlen <= sw.WARP_QP else max(len(subjects),
                                                     sw.STRIP_MIN_B)
    subjects += [_codes(rng, n) for n in rng.integers(1, 514, B - len(subjects))]
    assert sw._sw_path(prof.shape[1], B) == (
        "warp" if qlen <= sw.WARP_QP else "strip")
    batch, lengths = sw.pack_subjects(subjects, 24, dev)
    for go, ge in GAPS:
        got = sw.sw_batch(prof, batch, lengths, gap_open=go, gap_extend=ge,
                          q_len=q_len)
        want = sw.sw_plain(prof, batch, go, ge, q_len)
        assert torch.equal(got, want)


# Not multiples of 4 or 8 warps, and both sides of the strip kernel's
# threshold where there is one.
EDGE_BS = sorted({1, 7, 9, 33} | ({sw.STRIP_MIN_B - 1, sw.STRIP_MIN_B}
                                  if sw.STRIP_MIN_B > 1 else set()))


@pytest.mark.parametrize("B", EDGE_BS)
@pytest.mark.parametrize("qlen", [1000, 1152, 5147])
def test_kernel_batch_edges_on_card(dev, B, qlen):
    """Tail warps, empty subjects, interior codes >= A, negative codes (row
    0, as the reference clips them), junk past the lengths, subjects that
    align across the strips' boundaries, and a profile whose padded query
    rows score +7, so that they would win if the kernel let them into the
    best score."""
    rng = np.random.default_rng(B * qlen)
    query = _codes(rng, qlen)
    prof, q_len = ops.build_profile(query.to(dev), ops.BLOSUM50.to(dev))
    prof[:, q_len:] = 7.0
    A = prof.shape[0]
    lens = rng.integers(0, 400, B)
    lens[0] = 0
    subjects = [rng.integers(0, 20, n).astype(np.int32) for n in lens]
    if B > 2:
        subjects[1][::3] = A + 5
        subjects[2][1::4] = -3
        across = _across_strips(query)[:B - 3]
        subjects[3:3 + len(across)] = across
    subj, lengths = sw.pack_subjects(subjects, A, dev)
    subj = torch.cat([subj, torch.full((B, 9), 3, dtype=torch.int32,
                                       device=dev)], 1)   # junk past lengths
    for go, ge in GAPS + [(10.3, 2.1)]:
        got = sw.sw_batch(prof, subj, lengths, gap_open=go, gap_extend=ge,
                          q_len=q_len)
        live = torch.arange(subj.shape[1], device=dev) < lengths[:, None]
        want = sw.sw_plain(prof, torch.where(live, subj, A), go, ge, q_len)
        assert torch.equal(got, want), (go, ge, got.tolist(), want.tolist())


def test_strip_launches_counted_on_card(dev):
    """Every long-query sw_batch call is one launch, tallied by the path
    _sw_path names, and the card runs that kernel: sw_warp_kernel<32, LL>
    on the strip path (LL the last strip's rows / 32), sw_kernel<L> on the
    block path, sw_warp_kernel<L> up to 1024 rows."""
    rng = np.random.default_rng(2)
    cases = [(1000, 5, "warp", "sw_warp_kernel<32>"),
             (1500, max(sw.STRIP_MIN_B, 5), "strip", "sw_warp_kernel<32, 16>"),
             (5147, max(sw.STRIP_MIN_B, 5), "strip", "sw_warp_kernel<32, 4>")]
    if sw.STRIP_MIN_B > 1:
        cases.append((1500, sw.STRIP_MIN_B - 1, "block", "sw_kernel<2>"))
    for qlen, B, path, kernel in cases:
        prof, q_len = ops.build_profile(_codes(rng, qlen).to(dev),
                                        ops.BLOSUM50.to(dev))
        subj, lengths = sw.pack_subjects(
            [_codes(rng, n) for n in rng.integers(1, 300, B)], 24, dev)
        assert sw._sw_path(prof.shape[1], B) == path
        before, by_path = sw.launch_count(), sw.launch_counts()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof_run:
            for _ in range(3):
                sw.sw_batch(prof, subj, lengths, gap_open=10.0,
                            gap_extend=2.0, q_len=q_len)
            torch.cuda.synchronize()
        assert sw.launch_count() - before == 3
        after = sw.launch_counts()
        assert {p: after[p] - by_path[p] for p in sw.PATHS} == {
            p: 3 if p == path else 0 for p in sw.PATHS}
        names = [e.name for e in prof_run.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "sw_" in e.name]
        assert len(names) == 3 and all(kernel + "(" in n for n in names), names


def test_wrapper_refuses_non_contiguous_on_card(dev):
    prof, q_len = ops.build_profile(torch.zeros(5, dtype=torch.int32, device=dev),
                                    ops.BLOSUM50.to(dev))
    subj = torch.zeros((8, 2), dtype=torch.int32, device=dev).T
    with pytest.raises(ValueError, match="contiguous"):
        sw.sw_batch(prof, subj, gap_open=10.0, gap_extend=2.0, q_len=q_len)
    shifted = torch.zeros(prof.numel() + 1, device=dev)[1:].view(prof.shape)
    with pytest.raises(ValueError, match="16-byte"):
        sw.sw_batch(shifted, subj.T.contiguous(), gap_open=10.0,
                    gap_extend=2.0, q_len=q_len)


def test_sw_search_via_farm_on_card(dev):
    rng = np.random.default_rng(0)
    query = _codes(rng, 144).to(dev)
    db = [_codes(rng, n).to(dev) for n in (2, 352, 700, 2000, 17)]
    before = sw.launch_count()
    farm = TaskFarm(2, preserve_order=True)
    farm.add_stream(db)
    farm.add_worker(FnNode(lambda s: float(ops.smith_waterman(query, s))))
    got = farm.run_and_wait()
    assert sw.launch_count() - before == len(db)
    prof, q_len = ops.build_profile(query, ops.BLOSUM50.to(dev))
    assert got == [float(sw.sw_plain(prof, s, 10.0, 2.0, q_len)) for s in db]


def test_chunked_farm_equals_one_subject_farm_on_card(dev):
    """Length-sorted chunks of the database, one launch per chunk, give the
    one-subject farm's scores in database order."""
    rng = np.random.default_rng(4)
    query = _codes(rng, 497).to(dev)
    db = [rng.integers(0, 20, n).astype(np.int32)
          for n in rng.integers(1, 900, 70)]
    one = TaskFarm(2, preserve_order=True)
    one.add_stream([torch.from_numpy(s).to(dev) for s in db])
    one.add_worker(FnNode(lambda s: float(ops.smith_waterman(query, s))))
    want = one.run_and_wait()

    prof, q_len = ops.build_profile(query, ops.BLOSUM50.to(dev))
    order = sorted(range(len(db)), key=lambda i: -len(db[i]))
    chunks = [sw.pack_subjects([db[i] for i in order[c:c + 16]], 24, dev)
              for c in range(0, len(db), 16)]
    before = sw.launch_count()
    farm = TaskFarm(2, preserve_order=True)
    farm.add_stream(chunks)
    farm.add_worker(FnNode(lambda ch: sw.sw_batch(
        prof, *ch, gap_open=10.0, gap_extend=2.0, q_len=q_len)))
    scores = torch.cat(farm.run_and_wait()).tolist()
    assert sw.launch_count() - before == len(chunks)
    got = [0.0] * len(db)
    for pos, i in enumerate(order):
        got[i] = scores[pos]
    assert got == want


# -- flash attention and SSD kernels against their plain versions ---------
# FA tolerance: 2e-5 in f32, 2e-2 in bf16 (the reference's own,
# tests/test_kernels.py:93): the softmax sums run in another order.
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,T,D,window", [
    (1, 2, 2, 64, 64, 16, None),
    (2, 4, 2, 96, 160, 32, None),    # GQA + ragged
    (1, 8, 1, 128, 128, 64, None),   # MQA
    (2, 4, 4, 1, 1, 80, None),       # one row, one key
    (1, 4, 4, 200, 200, 80, 48),     # window, ragged tiles
    (1, 2, 1, 77, 300, 128, None),   # S < T
])
def test_fa_kernel_equals_plain_on_card(dev, dtype, B, H, Hkv, S, T, D, window):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(S * 7 + T)
    q = torch.randn((B, H, S, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Hkv, T, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Hkv, T, D), generator=g, device=dev).to(dtype)
    before = fa.launch_count()
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    assert fa.launch_count() == before + 1
    want = fa.fa_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    tol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_fa_kernel_takes_the_models_layout(dev):
    """(B,S,H,D) tensors passed as (B,H,S,D) views: no copy, same result."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((2, 70, 4, 80), generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        before = fa.launch_count()
        got = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2))
        assert fa.launch_count() == before + 1
        assert got.transpose(1, 2).is_contiguous()
        want = fa.fa_plain(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2))
        torch.cuda.synchronize()
        tol = FA_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


# The bf16 (wgmma/TMA) kernel's edges: every head dim, S and T of 1, 63,
# 65, 257 and below its 128-row kv tile, S < T with q_offset = T - S,
# S > T, GQA and MQA, windows 1, 64 and 128, no causal mask.
@pytest.mark.parametrize("B,H,Hkv,S,T,D,window,q_offset,causal", [
    *[(1, 2, 1, 129, 200, d, None, 0, True) for d in (16, 32, 48, 64, 80,
                                                      96, 112, 128)],
    (2, 4, 2, 1, 1, 80, None, 0, True),
    (1, 4, 4, 63, 63, 80, None, 0, True),
    (1, 4, 4, 65, 65, 48, None, 0, True),
    (1, 4, 4, 257, 257, 80, None, 0, True),
    (1, 4, 2, 63, 65, 64, None, 2, True),
    (1, 4, 2, 65, 257, 80, None, 192, True),
    (1, 4, 4, 257, 63, 80, None, 0, True),
    (1, 4, 4, 300, 77, 128, None, 0, True),
    (2, 8, 1, 200, 200, 80, None, 0, True),
    (1, 8, 2, 300, 300, 80, 1, 0, True),
    (1, 8, 2, 300, 300, 80, 64, 0, True),
    (1, 4, 4, 500, 500, 128, 128, 0, True),
    (1, 4, 1, 33, 1000, 64, 64, 967, True),
    (1, 2, 2, 100, 300, 80, None, 0, False),
])
def test_fa_bf16_kernel_edges_on_card(dev, B, H, Hkv, S, T, D, window,
                                      q_offset, causal):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(S * 31 + T + D)
    q = torch.randn((B, H, S, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, Hkv, T, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, Hkv, T, D), generator=g, device=dev).bfloat16()
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.launch_count()
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launch_count() == before + 1
    want = fa.fa_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = FA_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_fa_bf16_refuses_layouts_tma_cannot_take(dev):
    """A bf16 view whose head stride is 84 elements (168 bytes), or that
    starts 2 bytes into its storage, raises and launches nothing: no copy,
    no fall back to the SIMT kernel."""
    from repro_torch.kernels import flash_attention as fa
    wide = torch.zeros((1, 20, 4, 84), dtype=torch.bfloat16, device=dev)
    ok = torch.zeros((1, 4, 20, 80), dtype=torch.bfloat16, device=dev)
    before = fa.launch_count()
    with pytest.raises(ValueError, match=r"stride\(1\)"):
        fa.flash_attention(wide[..., :80].transpose(1, 2), ok, ok)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(ok, wide[..., 1:81].transpose(1, 2), ok)
    assert fa.launch_count() == before


def _ssd_inputs(dev, b, T, H, P, N, dtype, seed, with_h0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, T, H, P), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, T, H), generator=g, device=dev)) * 0.1
    A = -torch.exp(torch.randn((H,), generator=g, device=dev))
    B = torch.randn((b, T, N), generator=g, device=dev).to(dtype)
    C = torch.randn((b, T, N), generator=g, device=dev).to(dtype)
    h0 = torch.randn((b, H, P, N), generator=g, device=dev) if with_h0 else None
    return x, dt, A, B, C, h0


SSD_RAGGED_GROUPS = (1, 256, 7, 40, 64, 128, True)
# The SSD kernels' edges, forward and backward: one chunk (T = l), chunks
# of 8, 16 and 32 (under one 64-row tile), 96 and 15 (ragged tiles), 1024;
# P = 16 with N = 128; H = 3; h0 given and not; 64 chunks in the
# inter-chunk pass; P = 5, N = 7 and chunk 70, which take the scalar
# staging paths.
SSD_EDGES = [
    (1, 32, 2, 8, 16, 8, False),
    (2, 64, 3, 8, 16, 16, True),
    (1, 128, 4, 16, 32, 32, False),
    (1, 512, 5, 64, 64, 256, True),
    (1, 256, 3, 64, 128, 128, False),
    (1, 256, 3, 16, 128, 256, True),
    (2, 192, 3, 32, 64, 96, False),
    (1, 45, 2, 8, 16, 15, True),
    (1, 1024, 2, 64, 64, 1024, True),
    (2, 2048, 3, 64, 128, 1024, False),
    (1, 4096, 8, 64, 64, 64, True),
    (1, 140, 3, 5, 7, 70, True),
    # the backward's head groups and H·P slices (16 heads each) left ragged:
    # H = 7, H·P = 280, P = 40
    SSD_RAGGED_GROUPS,
]


# SSD tolerance: 1e-4 with f32 products (tests/test_kernels.py:146), chunk
# sums of up to 256 terms taken in another order; 5e-2 with bf16 products,
# the reference's bf16 tolerance: a sum in another order can round one
# bf16 operand to its neighbour.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,T,H,P,N,chunk,with_h0", SSD_EDGES)
def test_ssd_kernel_equals_plain_on_card(dev, dtype, cd, b, T, H, P, N,
                                         chunk, with_h0):
    from repro_torch.kernels import ssd_scan as ssd
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full f32
    x, dt, A, B, C, h0 = _ssd_inputs(dev, b, T, H, P, N, dtype, T + H, with_h0)
    before = ssd.launch_count()
    y, h = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk, h0=h0, compute_dtype=cd)
    assert ssd.launch_count() == before + 1
    # with f32 products a chunk over 256 is held against the plain version
    # in float64: the f32 one drifts there by about the tolerance itself
    # (test_torch_ssm.py::test_ssd_f32_forms_against_f64_witness_at_chunk_1024)
    witness = cd == torch.float32 and chunk > 256
    y_p, h_p = ssd.ssd_plain(x, dt, A, B, C, chunk, h0=h0,
                             compute_dtype=torch.float64 if witness else cd)
    y_p, h_p = y_p.float(), h_p.float()
    torch.cuda.synchronize()
    tol = 1e-4 if cd == torch.float32 else 5e-2
    torch.testing.assert_close(y, y_p, atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_p, atol=tol, rtol=tol)


def test_ssd_kernel_takes_unaligned_inputs_on_card(dev):
    """x, B and C as contiguous views that start one element into their
    storage, off the 16-byte boundary the vector staging needs: the kernels
    stage them element by element and give the aligned call's result, bit
    for bit (the same operations in the same order)."""
    from repro_torch.kernels import ssd_scan as ssd

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, B, C, h0 = _ssd_inputs(dev, 1, 128, 3, 64, 64, dtype, 11, True)
        xs, Bs, Cs = shifted(x), shifted(B), shifted(C)
        assert xs.is_contiguous() and xs.data_ptr() % 16
        for cd in (torch.float32, torch.bfloat16):
            y, h = ssd.ssd_scan(x, dt, A, B, C, chunk=64, h0=h0, compute_dtype=cd)
            ys, hs = ssd.ssd_scan(xs, dt, A, Bs, Cs, chunk=64, h0=h0,
                                  compute_dtype=cd)
            torch.cuda.synchronize()
            assert torch.equal(y, ys) and torch.equal(h, hs)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_smoke_prefill_runs_the_kernels(dev, dtype):
    """One prefill of the Zamba2 smoke model (2 groups of 5 Mamba2 blocks +
    the shared attention block) on the card launches FA once per group and
    SSD once per Mamba2 block, and agrees with the plain path on the CPU
    with the same weights: 1e-4 of the logits' scale in f32 (sums in
    another order), 5e-2 in bf16 (bf16 activations rounded at other
    points)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import init_params, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["zamba2-2.7b"].smoke().replace(dtype=dtype)
    params = init_params(cfg, 0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32))).to(dev)
    fa0, ssd0 = fa.launch_count(), ssd.launch_count()
    logits, cache = prefill(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    assert fa.launch_count() - fa0 == 2
    assert ssd.launch_count() - ssd0 == 10
    assert torch.isfinite(logits).all()
    want, _ = prefill(_to(params, "cpu"), {"tokens": toks.cpu()}, cfg)
    tol = 1e-4 if dtype == "float32" else 5e-2
    scale = max(1.0, float(want.abs().max()))
    assert float((logits.cpu() - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,router", [("mixtral-8x7b", "seeded"),
                                         ("mixtral-8x7b", "all-to-one"),
                                         ("kimi-k2-1t-a32b", "seeded")])
def test_moe_grouped_dispatch_equals_dense_on_card(dev, arch, router, dtype):
    """The dropless grouped dispatch against the dense oracle on the card,
    on the same routing: 1e-5 of the scale in f32 (sums in another order,
    TF32 off), one bf16 ulp of the scale (1e-2) in bf16.  ``all-to-one``
    sends every token's first choice to expert 3."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[arch].smoke().replace(dtype=dtype)
    params = moe.moe_init(torch.Generator(device=dev).manual_seed(1), cfg)
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    if router == "all-to-one":
        x[..., 0] = 5.0
        params["router"][0, 3] = 20.0
    tokens = x.to(cfg.param_dtype).reshape(-1, cfg.d_model)
    gates, ids, _ = moe._route(tokens, params["router"], cfg.top_k)
    if router == "all-to-one":
        assert bool((ids[:, 0] == 3).all())
    grouped = moe._moe_grouped(tokens, params, gates, ids, cfg)
    dense = moe._moe_dense(tokens, params, gates, ids, cfg)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 1e-2
    scale = max(1.0, float(dense.abs().max()))
    assert float((grouped - dense).abs().max()) <= tol * scale


# (arch, config overrides, FA launches per smoke prefill): mixtral's window
# of 16 at S = 32; llama-vision's 8 self blocks and 2 cross blocks over 8
# vision rows (non-causal); musicgen with its 4 heads padded to 8 and masked.
NEW_FAMILIES = [("mixtral-8x7b", {}, 2),
                ("llama-3.2-vision-90b", {}, 10),
                ("musicgen-medium", {"pad_heads_to": 8}, 2)]


def _family_batch(cfg, B, S, dev):
    rng = np.random.default_rng(0)
    if cfg.family == "audio":
        b = {"frames": torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))}
    else:
        b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        b["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_patches, cfg.vision_dim)).astype(np.float32))
    return {k: v.to(dev) for k, v in b.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,over,n_fa", NEW_FAMILIES)
def test_new_family_smoke_prefill_runs_fa_kernel(dev, arch, over, n_fa, dtype):
    """One smoke prefill of each family of this slice on the card launches
    the FA kernel once per attention block (self and cross) and the SSD
    kernel never, and agrees with the plain path on the CPU with the same
    weights: 1e-4 of the logits' scale in f32, 5e-2 in bf16 (as the Zamba2
    case above).  The bf16 moe model is held to the counts and to finite
    logits only: bf16 activations rounded at other points can move a
    near-tied token to another expert, which changes its output by a whole
    expert's share; its routing and dispatch are
    held in f32 here and in bf16 by the grouped-against-dense test."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import init_params, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[arch].smoke().replace(dtype=dtype, **over)
    params = init_params(cfg, 0, device=dev)
    batch = _family_batch(cfg, 2, 32, dev)
    fa0, ssd0 = fa.launch_count(), ssd.launch_count()
    logits, cache = prefill(params, batch, cfg)
    torch.cuda.synchronize()
    assert fa.launch_count() - fa0 == n_fa
    assert ssd.launch_count() == ssd0
    assert torch.isfinite(logits).all()
    if cfg.family == "moe" and dtype == "bfloat16":
        return
    want, _ = prefill(_to(params, "cpu"), _to(batch, "cpu"), cfg)
    tol = 1e-4 if dtype == "float32" else 5e-2
    scale = max(1.0, float(want.abs().max()))
    assert float((logits.cpu() - want).abs().max()) <= tol * scale


# -- the flash-attention backward kernel ------------------------------------
# Its edges (B, H, Hkv, S, T, D, window, q_offset, causal): every head dim,
# ragged S and T, GQA and MQA, a window, S < T with q_offset, S > T, the
# vision cross-attention's T = 1601 (non-causal), and rows whose every key
# is masked (q_offset < 0; a window past T), which the kernel differentiates
# as the forward kernel computes them (fa_backward_plain with kv_tile).
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
]


def _bwd_inputs(dev, dtype, B, H, Hkv, S, T, D, seed):
    """q, k, v, do as (B, H, rows, D) views of (B, rows, H, D) tensors, the
    model's layout; do as the transpose of another layout still."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
             .transpose(1, 2) for _ in range(2))
    k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).to(dtype)
            .transpose(1, 2) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,T,D,window,q_offset,causal", FA_BWD_EDGES)
def test_fa_backward_kernel_equals_plain_on_card(dev, dtype, B, H, Hkv, S, T,
                                                 D, window, q_offset, causal):
    """dq, dk, dv of the kernel against fa_backward_plain on the kernel
    forward's output: f32 within 2e-5 + 2e-5·|plain|, bf16 (the wgmma
    kernels, reading the statistics the forward saved) within
    2e-2 + 2e-2·|plain| (the forward's tolerances), in the inputs' dtypes
    and layouts."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _bwd_inputs(dev, dtype, B, H, Hkv, S, T, D, S * 13 + T + D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if dtype == torch.bfloat16:
        o, stats = fa.fa_forward_with_stats(q, k, v, **kw)
    else:
        o, stats = fa.flash_attention(q, k, v, **kw), None
    before = fa.bwd_launch_count()
    got = fa.fa_backward(q, k, v, o, do, stats=stats, **kw)
    assert fa.bwd_launch_count() == before + 1
    want = fa.fa_backward_plain(q, k, v, o, do, kv_tile=fa.KV_TILE[dtype], **kw)
    torch.cuda.synchronize()
    tol = FA_TOL[dtype]
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.stride() == x.stride()
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


def test_flash_attention_autograd_runs_both_kernels_on_card(dev):
    """With inputs that require grad, flash_attention on the card is one
    forward launch and, at .backward(), one backward launch whose gradients
    equal a direct fa_backward call's bit for bit."""
    from repro_torch.kernels import flash_attention as fa
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _bwd_inputs(dev, dtype, 2, 8, 2, 130, 130, 96, 7)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        f0, b0 = fa.launch_count(), fa.bwd_launch_count()
        out = fa.flash_attention(*leaves, causal=True, window=None)
        out.backward(do)
        assert (fa.launch_count() - f0, fa.bwd_launch_count() - b0) == (1, 1)
        stats = None
        if dtype == torch.bfloat16:
            o2, stats = fa.fa_forward_with_stats(q, k, v, causal=True)
            assert torch.equal(o2, out.detach())
        want = fa.fa_backward(q, k, v, out.detach(), do, stats=stats)
        torch.cuda.synchronize()
        for t, w in zip(leaves, want):
            assert torch.equal(t.grad, w)


@pytest.mark.parametrize("B,H,Hkv,S,T,D,window,q_offset,causal", FA_BWD_EDGES)
def test_fa_forward_stats_equal_plain_on_card(dev, B, H, Hkv, S, T, D, window,
                                              q_offset, causal):
    """The bf16 forward kernel's saved statistics against fa_stats_plain
    over its tiles (f32 products of the same bf16 inputs): m (base 2) and
    1/l within 1e-5 + 1e-5·|plain| (the sums run in another order, exp2
    approximate); a row whose every key is masked reads m = NEG2 exactly.
    Its output against fa_plain over the same tiles within the forward's
    2e-2 + 2e-2·|plain|, and equal bit for bit to the inference launch's."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = _bwd_inputs(dev, torch.bfloat16, B, H, Hkv, S, T, D,
                             S * 17 + T + D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.launch_count()
    o, stats = fa.fa_forward_with_stats(q, k, v, **kw)
    assert fa.launch_count() == before + 1
    want = fa.fa_stats_plain(q, k, kv_tile=fa.KV_TILE[torch.bfloat16], **kw)
    o_plain = fa.fa_plain(q, k, v, kv_tile=fa.KV_TILE[torch.bfloat16], **kw)
    o_inference = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = FA_TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o_plain.float(), atol=tol, rtol=tol)
    assert torch.equal(o, o_inference)
    assert stats.shape == want.shape == (2, B * H * S)
    torch.testing.assert_close(stats, want, atol=1e-5, rtol=1e-5)
    qpos = torch.arange(S, device=dev)[:, None] + q_offset
    kpos = torch.arange(T, device=dev)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=dev)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    dead = (~ok.any(dim=1)).expand(B, H, S).reshape(-1)
    assert bool((stats[0][dead] == want[0][dead]).all())
    assert bool((want[0][dead] == torch.tensor(fa.NEG2, dtype=torch.float32)).all())


# D = 224 (Zamba2-7B's shared attention; bf16 only): 64-row kv tiles, the
# split dK/dV block; the scale Zamba2 uses, (D/2)^-0.5, and the default
FA224_EDGES = [
    (1, 2, 1, 129, 200, None, 0, True, 112 ** -0.5),
    (2, 4, 4, 256, 256, None, 0, True, None),
    (1, 4, 2, 200, 200, 48, 0, True, 112 ** -0.5),
    (1, 2, 1, 77, 300, None, 223, True, 112 ** -0.5),
    (1, 2, 2, 100, 333, None, 0, False, 112 ** -0.5),
    (1, 2, 2, 70, 70, None, -3, True, 112 ** -0.5),
    (1, 32, 32, 4096, 4096, None, 0, True, 112 ** -0.5),
]


@pytest.mark.parametrize("B,H,Hkv,S,T,window,q_offset,causal,scale", FA224_EDGES)
def test_fa224_forward_and_stats_equal_plain_on_card(dev, B, H, Hkv, S, T, window,
                                                     q_offset, causal, scale):
    """At D = 224 the bf16 forward kernel, with and without the
    statistics, against fa_plain and fa_stats_plain over its 64-key tiles
    (kv_tile), with the scale given: the output within the forward's
    2e-2 + 2e-2·|plain|, the two launches equal bit for bit, the
    statistics within 1e-5 + 1e-5·|plain|."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    D = 224
    assert fa.kv_tile(torch.bfloat16, D) == 64
    q, k, v, _ = _bwd_inputs(dev, torch.bfloat16, B, H, Hkv, S, T, D,
                             S * 19 + T + D)
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    before = fa.launch_count()
    o, stats = fa.fa_forward_with_stats(q, k, v, **kw)
    o_inference = fa.flash_attention(q, k, v, **kw)
    assert fa.launch_count() == before + 2
    want = fa.fa_stats_plain(q, k, kv_tile=64, **kw)
    o_plain = fa.fa_plain(q, k, v, kv_tile=64, **kw)
    torch.cuda.synchronize()
    tol = FA_TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o_plain.float(), atol=tol, rtol=tol)
    assert torch.equal(o, o_inference)
    torch.testing.assert_close(stats, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,Hkv,S,T,window,q_offset,causal,scale", FA224_EDGES)
def test_fa224_backward_equals_plain_on_card(dev, B, H, Hkv, S, T, window,
                                             q_offset, causal, scale):
    """At D = 224 dq, dk, dv of the backward kernels (dK and dV from the
    two warpgroups of a split block) against fa_backward_plain on the
    kernel forward's output and statistics, within 2e-2 + 2e-2·|plain|,
    in the inputs' dtypes and layouts; through autograd the same bits."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    D = 224
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, B, H, Hkv, S, T, D,
                              S * 23 + T + D)
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    o, stats = fa.fa_forward_with_stats(q, k, v, **kw)
    before = fa.bwd_launch_count()
    got = fa.fa_backward(q, k, v, o, do, stats=stats, **kw)
    assert fa.bwd_launch_count() == before + 1
    want = fa.fa_backward_plain(q, k, v, o, do, kv_tile=64, **kw)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, **kw).backward(do)
    torch.cuda.synchronize()
    tol = FA_TOL[torch.bfloat16]
    for g, w, x, t in zip(got, want, (q, k, v), leaves):
        assert g.dtype == x.dtype and g.stride() == x.stride()
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
        assert torch.equal(t.grad, g)


def test_fa224_refuses_float32_on_card(dev):
    """D = 224 has bfloat16 kernels only: float32 inputs are refused."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 2, 64, 224), device=dev)
    with pytest.raises(ValueError, match="head dim 224"):
        fa.flash_attention(q, q, q)


def test_fa_forward_without_grad_writes_no_stats_on_card(dev, monkeypatch):
    """Without autograd the forward launches once with no statistics
    buffer, as before the backward read them, and its output equals the
    stats-writing launch's bit for bit; with grad on, bf16 writes them."""
    from repro_torch.kernels import flash_attention as fa
    calls = []
    launch = fa._fa_launch

    def spy(q, k, v, c, w, o, stats=None, **kw):
        calls.append(stats)
        return launch(q, k, v, c, w, o, stats=stats, **kw)

    monkeypatch.setattr(fa, "_fa_launch", spy)
    q, k, v, _ = _bwd_inputs(dev, torch.bfloat16, 2, 8, 2, 130, 130, 96, 11)
    before = fa.launch_count()
    with torch.no_grad():
        plain_out = fa.flash_attention(q, k, v, causal=True)
    out = fa.flash_attention(q, k, v, causal=True)      # no input needs grad
    assert fa.launch_count() == before + 2 and calls == [None, None]
    with_stats, stats = fa.fa_forward_with_stats(q, k, v, causal=True)
    assert calls[-1] is stats
    torch.cuda.synchronize()
    assert torch.equal(plain_out, with_stats) and torch.equal(out, with_stats)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, causal=True)
    assert calls[-1] is not None and calls[-1].shape == stats.shape
    with pytest.raises(ValueError, match="statistics"):
        fa.fa_forward_with_stats(q.float(), k.float(), v.float())


def test_kernels_without_a_backward_refuse_autograd_on_card(dev):
    """sw_batch has no backward kernel: under autograd on the card it raises
    instead of returning a result with no gradient."""
    prof, q_len = ops.build_profile(_codes(np.random.default_rng(0), 40).to(dev),
                                    ops.BLOSUM50.to(dev))
    subj = _codes(np.random.default_rng(1), 64).to(dev)[None]
    with pytest.raises(NotImplementedError, match="backward kernel"):
        sw.sw_batch(prof.requires_grad_(), subj, gap_open=10.0,
                    gap_extend=2.0, q_len=q_len)


# -- the SSD backward kernels ---------------------------------------------------
# SSD_EDGES, in both x dtypes and both compute dtypes, with a cotangent on
# y and, where h0 is given, on the final state too.  Each gradient within
# SSD_BWD_TOL of its own max |plain| (1e-4 with f32 products: sums of up to
# a chunk's terms, and of the heads, in another order; 5e-2 with bf16
# products, the forward's bf16 tolerance), plus, for a gradient stored in
# bf16 (dx, dB, dC of bf16 inputs), one bf16 spacing of the element (2^-7
# of |plain|): two f32 values a rounding apart can round to neighbouring
# bf16 values.  With f32 products at chunks over 256 the plain backward
# runs in float64, as the forward's witness does.
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _ssd_grad_close(got, want, tol):
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert torch.isfinite(g).all(), name
        diff = (g.double() - w.double()).abs()
        if g.dtype == torch.bfloat16:
            diff = (diff - 2.0 ** -7 * w.double().abs()).clamp(min=0)
        scale = max(float(w.abs().max()), 1e-30)
        assert float(diff.max()) <= tol * scale, (name, float(diff.max()), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,T,H,P,N,chunk,with_h0", SSD_EDGES)
def test_ssd_backward_kernel_equals_plain_on_card(dev, dtype, cd, b, T, H, P,
                                                  N, chunk, with_h0):
    from repro_torch.kernels import ssd_scan as ssd
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dt, A, B, C, h0 = _ssd_inputs(dev, b, T, H, P, N, dtype, T + H + 1, with_h0)
    g = torch.Generator(device=dev).manual_seed(T + N)
    dy = torch.randn((b, T, H, P), generator=g, device=dev)
    dh = torch.randn((b, H, P, N), generator=g, device=dev) if with_h0 else None
    y, h, scratch = ssd.ssd_forward_with_scratch(x, dt, A, B, C, chunk=chunk,
                                                 h0=h0, compute_dtype=cd)
    before = ssd.bwd_launch_count()
    got = ssd.ssd_backward(x, dt, A, B, C, chunk, dy, scratch, dh_final=dh,
                           h0=h0, compute_dtype=cd)
    assert ssd.bwd_launch_count() == before + 1
    witness = cd == torch.float32 and chunk > 256
    want = ssd.ssd_backward_plain(x, dt, A, B, C, chunk, dy, dh_final=dh, h0=h0,
                                  compute_dtype=torch.float64 if witness else cd)
    torch.cuda.synchronize()
    assert [t.dtype for t in got[:5]] == [dtype, torch.float32, torch.float32,
                                          dtype, dtype]
    _ssd_grad_close(got, want, SSD_BWD_TOL[cd])


def test_ssd_backward_is_deterministic_on_card(dev):
    """No atomics: two backward calls give the same bits, and autograd
    through SsdScanFn gives a direct call's, in both compute dtypes; also
    where the head groups and H·P slices are ragged."""
    from repro_torch.kernels import ssd_scan as ssd
    for b, T, H, P, N, chunk, _ in [(2, 512, 8, 64, 64, 128, True), SSD_RAGGED_GROUPS]:
        x, dt, A, B, C, h0 = _ssd_inputs(dev, b, T, H, P, N, torch.bfloat16, 5, True)
        dy = torch.randn((b, T, H, P), device=dev)
        for cd in (torch.float32, torch.bfloat16):
            _, _, scratch = ssd.ssd_forward_with_scratch(x, dt, A, B, C, chunk=chunk,
                                                         h0=h0, compute_dtype=cd)
            one = ssd.ssd_backward(x, dt, A, B, C, chunk, dy, scratch, h0=h0,
                                   compute_dtype=cd)
            two = ssd.ssd_backward(x, dt, A, B, C, chunk, dy, scratch, h0=h0,
                                   compute_dtype=cd)
            leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, B, C, h0)]
            f0, b0 = ssd.launch_count(), ssd.bwd_launch_count()
            y, _ = ssd.ssd_scan(*leaves[:5], chunk=chunk, h0=leaves[5], compute_dtype=cd)
            y.backward(dy)
            assert (ssd.launch_count() - f0, ssd.bwd_launch_count() - b0) == (1, 1)
            torch.cuda.synchronize()
            for a, b_, leaf in zip(one, two, leaves):
                assert torch.equal(a, b_) and torch.equal(a, leaf.grad)


# -- the Mamba2 mixer's gated-norm epilogue (Zamba2) ------------------------------
# (b, T, H, P, G, pad): x a slice of a (b, T, H·P + pad) xBC.  One sequence at
# zamba2-train-4k's shape (xBC 7424 wide); T = 333, not a multiple of either
# strip, with G = 1; two sequences of 77 with 3 groups and xBC rows of 52
GN_CASES = [(1, 4096, 112, 64, 2, 256), (1, 333, 7, 40, 1, 0), (2, 77, 6, 8, 3, 4)]


def _gn_inputs(dev, b, T, H, P, pad, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    di = H * P
    y = torch.randn((b, T, H, P), generator=g, device=dev)
    xbc = torch.randn((b, T, di + pad), generator=g, device=dev).to(dtype)
    x = xbc[..., :di].reshape(b, T, H, P)
    z = (torch.randn((b, T, di), generator=g, device=dev) * 2).to(dtype)
    D = torch.randn((H,), generator=g, device=dev)
    gnorm = torch.randn((di,), generator=g, device=dev)
    do = torch.randn((b, T, di), generator=g, device=dev).to(dtype)
    return y, x, z, D, gnorm, do


def _gn_close(got, want, tol):
    """|got − want| <= tol·max|want| + one spacing of got's dtype's
    mantissa (2^-7 for bf16, 2^-23 for f32) of |want|: the kernel and the
    plain version compute the same f32 values but for the order of their
    sums, which can round a stored value to its neighbour."""
    spacing = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -23
    got, want = got.float(), want.float()
    bound = tol * float(want.abs().max()) + spacing * want.abs()
    return bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


@pytest.mark.parametrize("b,T,H,P,G,pad", GN_CASES)
def test_gated_norm_kernels_equal_plain_on_card(dev, b, T, H, P, G, pad):
    """The forward kernel against ``gated_rmsnorm_plain`` (out in bf16; r
    within 1e-5, a sum of up to 3584 squares in another order), the backward kernels against
    ``gated_rmsnorm_backward_plain`` (dy, dx, dz within 1e-5 of their
    largest entry; dD and dgnorm, sums over every token, within 1e-4),
    each beside one storage spacing; a second call of each gives the same
    bits; each call adds one to its count."""
    from repro_torch.kernels import gated_norm as gn
    y, x, z, D, gnorm, do = _gn_inputs(dev, b, T, H, P, pad)
    f0, b0 = gn.launch_count(), gn.bwd_launch_count()
    out, r = gn.gated_rmsnorm_forward(y, x, z, D, gnorm, G, 1e-5)
    out2, r2 = gn.gated_rmsnorm_forward(y, x, z, D, gnorm, G, 1e-5)
    got = gn.gated_rmsnorm_backward(do, y, x, z, D, gnorm, r, G)
    got2 = gn.gated_rmsnorm_backward(do, y, x, z, D, gnorm, r, G)
    torch.cuda.synchronize()
    assert (gn.launch_count() - f0, gn.bwd_launch_count() - b0) == (2, 2)
    assert torch.equal(out, out2) and torch.equal(r, r2)
    assert all(torch.equal(u, v) for u, v in zip(got, got2))
    want = gn.gated_rmsnorm_plain(y, x, z, D, gnorm, G, 1e-5)
    assert out.dtype == torch.bfloat16 and _gn_close(out, want, 0.0)[0]
    v = ((y + x.float() * D[:, None]) * torch.nn.functional.silu(z.float()).reshape(
        y.shape)).reshape(b, T, G, -1)
    torch.testing.assert_close(r, torch.rsqrt((v * v).mean(-1) + 1e-5), rtol=1e-5, atol=0)
    want = gn.gated_rmsnorm_backward_plain(y, x, z, D, gnorm, G, 1e-5, do)
    for name, u, w, tol in zip(("dy", "dx", "dz", "dD", "dgnorm"), got, want,
                               (1e-5, 1e-5, 1e-5, 1e-4, 1e-4)):
        assert u.dtype == w.dtype and u.shape == w.shape, name
        ok, err = _gn_close(u, w, tol)
        assert ok, (name, err)


def test_gated_norm_autograd_runs_both_kernels_on_card(dev):
    """Through ``gated_rmsnorm`` with inputs that require grad: one forward
    and one backward launch, and the direct calls' bits, x's gradient on
    its slice of xBC."""
    from repro_torch.kernels import gated_norm as gn
    b, T, H, P, G, pad = 2, 300, 8, 64, 2, 128
    y, x, z, D, gnorm, do = _gn_inputs(dev, b, T, H, P, pad, seed=3)
    xbc = x.reshape(b, T, H * P)
    xbc = torch.cat([xbc, torch.zeros_like(xbc[..., :pad])], -1).requires_grad_()
    leaves = [t.detach().clone().requires_grad_() for t in (y, z, D, gnorm)]
    xs = xbc[..., :H * P].reshape(b, T, H, P)
    f0, b0 = gn.launch_count(), gn.bwd_launch_count()
    out = gn.gated_rmsnorm(leaves[0], xs, leaves[1], leaves[2], leaves[3], G, 1e-5)
    out.backward(do)
    torch.cuda.synchronize()
    assert (gn.launch_count() - f0, gn.bwd_launch_count() - b0) == (1, 1)
    want_out, r = gn.gated_rmsnorm_forward(y, xs.detach(), z, D, gnorm, G, 1e-5)
    want = gn.gated_rmsnorm_backward(do, y, xs.detach(), z, D, gnorm, r, G)
    assert torch.equal(out, want_out)
    assert torch.equal(xbc.grad[..., :H * P].reshape(x.shape), want[1])
    assert not xbc.grad[..., H * P:].any()
    for u, w in zip([leaves[0].grad, *(t.grad for t in leaves[1:])], [want[0], *want[2:]]):
        assert torch.equal(u, w)


def test_gated_norm_refuses_what_the_kernel_does_not_take_on_card(dev):
    from repro_torch.kernels import gated_norm as gn
    y, x, z, D, gnorm, _ = _gn_inputs(dev, 1, 8, 4, 8, 0)
    with pytest.raises(TypeError, match="float32"):
        gn.gated_rmsnorm(y.to(torch.bfloat16), x, z, D, gnorm, 2, 1e-5)
    with pytest.raises(TypeError, match="share"):
        gn.gated_rmsnorm(y, x, z.float(), D, gnorm, 2, 1e-5)
    with pytest.raises(ValueError, match="contiguously"):
        gn.gated_rmsnorm(y, x.transpose(2, 3).contiguous().transpose(2, 3), z, D,
                         gnorm, 2, 1e-5)
    odd = _gn_inputs(dev, 1, 8, 4, 6, 0)                     # P not a multiple of 4
    with pytest.raises(ValueError, match="4 channels"):
        gn.gated_rmsnorm(*odd[:5], 2, 1e-5)
    xbc = torch.zeros((1, 8, 33), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="4 channels"):     # rows off alignment
        gn.gated_rmsnorm(y, xbc[..., 1:].reshape(1, 8, 4, 8), z, D, gnorm, 2, 1e-5)
    big = _gn_inputs(dev, 1, 2, 64, 132, 0)                  # 8448 channels a group
    with pytest.raises(ValueError, match="exceeds"):
        gn.gated_rmsnorm(*big[:5], 1, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_smoke_train_step_runs_the_gated_norm_kernels(dev, dtype):
    """One make_train_step of the zamba2 family's smoke model with remat on
    the card: 2 x n_layers gated-norm forward launches (the forward and the
    remat recompute) and n_layers backward; in f32 the loss within 1e-4
    and every gradient within 1e-4 of its largest |g| against the plain
    path on the CPU (the CPU parity tests' limit), in bf16 finite metrics."""
    from repro_torch.configs.zamba2_7b import CONFIG
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import gated_norm as gn
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CONFIG.smoke().replace(dtype=dtype, remat=True)
    params = init_params(cfg, 0, device="cpu")
    cpu_batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, 2, 32, seed=1)(0).items()}
    dev_params, dev_batch = _to(params, dev), _to(cpu_batch, dev)
    if dtype == "float32":
        want_loss, want = _grad_leaves(params, cpu_batch, cfg)
        got_loss, got = _grad_leaves(dev_params, dev_batch, cfg)
        assert abs(got_loss - want_loss) <= 1e-4 * max(1.0, abs(want_loss))
        for g, w in zip(got, want):
            assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)
    step = make_train_step(cfg, peak_lr=1e-3, warmup=1)
    f0, b0 = gn.launch_count(), gn.bwd_launch_count()
    _, _, m = step(dev_params, adamw_init(dev_params), dev_batch)
    torch.cuda.synchronize()
    assert (gn.launch_count() - f0, gn.bwd_launch_count() - b0) == (2 * cfg.n_layers,
                                                                     cfg.n_layers)
    assert all(torch.isfinite(m[k]).all() for k in ("loss", "ce", "grad_norm"))


# -- training on the card -----------------------------------------------------
def _grad_leaves(params, batch, cfg):
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.tree import tree_leaves
    loss, _, grads = loss_and_grads(params, batch, cfg)
    return float(loss), tree_leaves(grads)


@pytest.mark.parametrize("arch,n_fa", [("phi3-mini-3.8b", 2),
                                       ("mixtral-8x7b", 2),
                                       ("llama-3.2-vision-90b", 10),
                                       ("musicgen-medium", 2),
                                       ("mamba2-130m", 0),
                                       ("zamba2-2.7b", 2)])
def test_train_step_on_card_equals_cpu(dev, arch, n_fa):
    """The smoke model's loss and gradients on the card (every attention
    block through the FA kernel forward and backward, every Mamba2 block
    through the SSD kernels forward and backward, remat on) against the
    plain path on the CPU with the same weights and batch, in f32: the
    loss within 1e-4, each gradient leaf within 1e-4 of its largest |g| (the
    CPU parity tests' limit against JAX).  Then one make_train_step on the
    card: FA forward launches twice per block (the forward and the remat
    recompute), one backward launch per block; SSD forward once per Mamba2
    block, twice in the hybrid family, whose groups are recomputed (the ssm
    family has no remat, as in the reference), one backward launch per
    block; finite metrics that match the CPU step's."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[arch].smoke().replace(dtype="float32", remat=True)
    n_ssd = sum(k == "ssm" for k in cfg.layer_kinds())
    params = init_params(cfg, 0, device="cpu")
    np_batch = SyntheticLM(cfg, 2, 32, seed=1)(0)
    cpu_batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    dev_params, dev_batch = _to(params, dev), _to(cpu_batch, dev)
    want_loss, want = _grad_leaves(params, cpu_batch, cfg)
    got_loss, got = _grad_leaves(dev_params, dev_batch, cfg)
    assert abs(got_loss - want_loss) <= 1e-4 * max(1.0, abs(want_loss))
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale
    step = make_train_step(cfg, peak_lr=1e-3, warmup=1)
    f0, b0 = fa.launch_count(), fa.bwd_launch_count()
    s0, sb0 = ssd.launch_count(), ssd.bwd_launch_count()
    _, _, m = step(dev_params, adamw_init(dev_params), dev_batch)
    torch.cuda.synchronize()
    assert fa.launch_count() - f0 == 2 * n_fa
    assert fa.bwd_launch_count() - b0 == n_fa
    remat = 2 if cfg.family == "hybrid" else 1
    assert ssd.launch_count() - s0 == remat * n_ssd
    assert ssd.bwd_launch_count() - sb0 == n_ssd
    _, _, m_cpu = step(params, adamw_init(params), cpu_batch)
    for key in ("loss", "ce", "aux", "grad_norm"):
        assert torch.isfinite(m[key]).all()
        assert abs(float(m[key]) - float(m_cpu[key])) <= 1e-4 * max(
            1.0, abs(float(m_cpu[key]))), key


def test_cuda_tensors_cross_a_procs_farm_on_the_host(dev):
    """The procs backend's tensor edge: CUDA tensors offloaded to a process
    farm reach the workers, and come back, as CPU tensors equal to
    ``.cpu()`` — inside the farm's tokens (caller-side arbitration) and
    bare on a stage edge (the graph path), bf16 included."""
    from _torch_procs_nodes import describe
    from repro_torch.core import Farm, ProcAccelerator, Stage, pool_shutdown
    xs = [torch.arange(12, dtype=torch.float32, device=dev).reshape(3, 4),
          torch.tensor([5, -6, 7], dtype=torch.int32, device=dev),
          torch.tensor([True, False], device=dev),
          torch.linspace(-2, 2, 9, device=dev).to(torch.bfloat16)]
    try:
        for skel in (Farm(describe, 2, ordered=True), Stage(describe)):
            acc = ProcAccelerator(skel)
            for x in xs:
                acc.offload(x)
            out = acc.wait(120)
            assert len(out) == len(xs)
            for (kind, dtype, shape, device, t), x in zip(out, xs):
                assert (kind, dtype, shape, device) == \
                    ("Tensor", str(x.dtype), tuple(x.shape), "cpu")
                assert t.device.type == "cpu" and torch.equal(t, x.cpu())
    finally:
        pool_shutdown()


# -- the device backend on the card -----------------------------------------
def _f(x):
    return x * 3 + 1


def _step(x):
    return x * 2 + 1


def _until(x):
    return x < 64


def _mod7(x):
    return x % 7


def test_mesh_farm_and_feedback_on_card_equal_threads(dev):
    """The mesh program's default device is the card: its outputs equal
    the threads backend's, ints exactly and floats to float32 rounding."""
    from repro_torch.core import Farm, Feedback, Pipeline, lower
    pipe = Pipeline(Farm(_f, 2, ordered=True), Farm(_mod7, 2, ordered=True))
    prog = lower(pipe, "mesh", metrics=True)
    assert prog.device.type == "cuda"
    xs = list(range(-3000, 3000, 7))
    assert prog(xs) == lower(pipe, "threads")(xs)
    fl = [0.37 * x for x in range(100)]
    np.testing.assert_allclose(prog(fl), lower(pipe, "threads")(fl),
                               rtol=1e-5, atol=1e-4)
    fb = Feedback(_step, _until, max_trips=32)
    xs = list(range(0, 90))
    assert lower(fb, "mesh")(xs) == lower(fb, "threads")(xs)
    assert prog.metrics.counter("mesh.compiles").value == 2


@pytest.mark.parametrize("fold", ["sum", "min", "max", "count"])
def test_mesh_reduce_by_key_on_card_equals_threads(dev, fold):
    from repro_torch.core import lower, reduce_by_key
    rng = np.random.default_rng(3)
    xs = [int(v) for v in rng.integers(-5000, 5000, 3000)]
    skel = reduce_by_key(_mod7, fold, nkeys=7)
    assert dict(lower(skel, "mesh")(xs)) == dict(lower(skel, "threads")(xs))


def test_mesh_sw_farm_on_card_equals_sw_plain(dev):
    """A device Farm whose worker scores rows of padded subject residues
    (codes >= 24 are padding) with sw_batch; column 0 of each row carries
    its score, equal to sw_plain, and the kernel launched once."""
    from repro_torch.core import Farm, lower
    rng = np.random.default_rng(8)
    query = _codes(rng, 300).to(dev)
    prof, q_len = ops.build_profile(query, ops.BLOSUM50.to(dev))
    A = ops.BLOSUM50.shape[0]
    subjects = [rng.integers(0, 20, n).astype(np.int32)
                for n in rng.integers(2, 400, 37)]
    padded, _ = sw.pack_subjects(subjects, A, "cpu")

    def score_rows(x):
        y = torch.zeros_like(x)
        y[:, 0] = sw.sw_batch(prof, x.contiguous(), gap_open=10.0,
                              gap_extend=2.0, q_len=q_len).to(torch.int32)
        return y

    before = sw.launch_count()
    out = lower(Farm(score_rows, 2, ordered=True), "mesh")(
        [r for r in padded.numpy()])
    assert sw.launch_count() - before == 1
    want = sw.sw_plain(prof, padded.to(dev), 10.0, 2.0, q_len)
    assert [row[0] for row in out] == [int(v) for v in want.tolist()]


# -- rank processes on the card (repro_torch.core.ranks) ----------------------
def test_ranks_share_the_card_over_gloo(dev):
    """Two rank processes on cuda:0 over gloo (one card: NCCL refuses two
    ranks on it): a bf16 ring hop staged through the host (one move out
    and one back a rank), and a 2-worker SW device farm through the mesh
    program, equal to ``sw_plain``, with one launch in each rank."""
    import functools

    import _torch_rank_jobs as J
    from repro_torch.core import Farm, lower, ranks
    p = ranks.RankPool(2, device="cuda:0", transport="gloo")
    try:
        out = p.run(J.card_ring_hop)
    finally:
        p.close()
    for r, (where, got, staged) in enumerate(out):
        assert where == "cuda" and (got == (r - 1) % 2).all() and staged == 2
    rng = np.random.default_rng(8)
    prof, q_len = ops.build_profile(_codes(rng, 300).to(dev),
                                    ops.BLOSUM50.to(dev))
    subjects = [rng.integers(0, 20, n).astype(np.int32)
                for n in rng.integers(2, 400, 37)]
    padded, _ = sw.pack_subjects(subjects, ops.BLOSUM50.shape[0], "cpu")
    prog = lower(Farm(functools.partial(J.score_rows, prof.cpu(), q_len), 2),
                 "mesh", devices=2, transport="gloo")
    try:
        got = prog([r for r in padded.numpy()])
        assert prog.pool.launches["sw"] == 2
    finally:
        ranks.shutdown()
    want = sw.sw_plain(prof, padded.to(dev), 10.0, 2.0, q_len)
    assert [row[0] for row in got] == [int(v) for v in want.tolist()]


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_ring_attention_kernel_hops_equal_the_plain_hop_on_card(dev, causal,
                                                                window):
    """Two ranks on the card, bf16, grouped-query: every hop through the
    FA kernel (a later rank's block skipped under ``causal``), merged by
    the statistics, against the same ring through the plain hop in
    float32 on the same bf16 inputs: each row within 1e-2 relative L2
    over the head dim (bf16 rounds a row by about 2^-9); with a window of
    40 over shards of 64 the last rows of the hop one rank back see no
    key."""
    import _torch_rank_jobs as J
    from repro_torch.core import ranks
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((1, 128, 8, 64), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((1, 128, 2, 64), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    p = ranks.RankPool(2, device="cuda:0", transport="gloo")
    try:
        kern = p.run(J.ring_attention, q, k, v, causal, window, "fa")
        plain = p.run(J.ring_attention, q.float(), k.float(), v.float(),
                      causal, window, "plain")
        assert p.launches["fa"] == (3 if causal else 4)
    finally:
        p.close()
    assert [c for _, c in kern] == ([[0], [0, 64]] if causal
                                    else [[0, -64], [0, 64]])
    got = np.concatenate([o for o, _ in kern], axis=1)
    want = np.concatenate([o for o, _ in plain], axis=1)
    assert np.isfinite(got).all()
    rel = np.sqrt(((got - want) ** 2).sum(-1) / (want ** 2).sum(-1))
    assert rel.max() <= 1e-2, rel.max()


def test_ring_attention_kernel_path_refuses_grad_on_card(dev):
    """The kernel path's gradient (bf16 on the card, ``RingAttentionFn``
    over 2 ranks): the forward and backward kernels each hop — 1 + 2
    launches of each under ``causal`` — and dq, dk, dv of sum(out · dO)
    within 1e-2 row-wise relative L2 of autograd through the float32
    one-device naive attention on the same inputs.  ``ring_attention_plain``
    still refuses."""
    import _torch_rank_jobs as J
    from repro_torch.core import ranks
    from repro_torch.models.attention import naive_attention
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn((1, 256, 2, 64), generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    p = ranks.RankPool(2, device="cuda:0", transport="gloo")
    try:
        got = p.run(J.ring_attention_grad, q, k, v, "auto", do)
        assert p.launches["fa"] == 3 and p.launches["fa_bwd"] == 3, p.launches
        msgs = p.run(J.ring_attention_grad, q, k, v, "plain")
    finally:
        p.close()
    assert all(isinstance(m, str) and "ring_attention" in m for m in msgs)
    qf, kf, vf = (t.float().to(dev).requires_grad_() for t in (q, k, v))
    out = naive_attention(qf, kf, vf, causal=True, window=None)
    (out * do.float().to(dev)).sum().backward()
    for i, want in enumerate((out, qf.grad, kf.grad, vf.grad)):
        mine = torch.from_numpy(np.concatenate([g[i] for g in got], axis=1))
        want = want.detach().cpu()
        if i == 0:      # the output, row by row
            rel = ((mine - want).square().sum(-1).sqrt()
                   / want.square().sum(-1).sqrt().clamp_min(1e-30))
            assert rel.max() <= 1e-2, float(rel.max())
            continue
        # a gradient by the rule of the bf16 FA backward's card checks: a
        # row whose gradient cancels (dq of the first query) has a norm
        # near 0, so its own relative error says nothing
        assert (mine - want).abs().max() <= 1e-2 * want.abs().max(), i
        assert (mine - want).norm() <= 1e-2 * want.norm(), i


def test_fa_backward_as_the_first_call_of_autograds_thread(dev):
    """The bf16 backward launch encodes its tensor maps through the driver
    API, which needs a current context: when it is the first CUDA call of
    autograd's device thread (a graph whose only node is the attention, in
    a fresh process, so no earlier backward bound one), it must bind the
    card's context itself, and match the direct call."""
    code = textwrap.dedent("""
        import torch
        from repro_torch.kernels import flash_attention as fa
        gen = torch.Generator(device="cuda").manual_seed(11)
        q, k, v, do = (torch.randn((1, 2, 256, 64), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True)
        torch.autograd.backward(out, do)
        o, stats = fa.fa_forward_with_stats(q, k, v, causal=True)
        want = fa.fa_backward(q, k, v, o, do, causal=True, stats=stats)
        assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_sharded_loss_and_grads_on_card_equal_one_device(dev):
    """Four ranks on the card over gloo (a 2×2 mesh): the Phi-3 smoke
    config's sharded loss and gathered f32 gradients, through the FA
    kernels forward and backward, against the one-device ones on the
    card: loss rtol 1e-5, each leaf within 1e-4 of its largest |g|."""
    import _torch_rank_jobs as J
    from repro_torch.configs import ARCHS
    from repro_torch.core import ranks
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves_with_path, tree_map
    cfg = ARCHS["phi3-mini-3.8b"].smoke().replace(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, 4, 64)(0).items()}
    p = ranks.RankPool(4, device="cuda:0", transport="gloo")
    try:
        loss, _, _, got = p.run(J.sharded_loss, cfg, params, batch, (2, 2),
                                True)[0]
        assert p.launches["fa"] > 0 and p.launches["fa_bwd"] > 0
    finally:
        p.close()
    want_loss, _, want = loss_and_grads(
        tree_map(lambda t: t.to(dev), params),
        {k: v.to(dev) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    for (k, a), (_, b) in zip(tree_leaves_with_path(got),
                              tree_leaves_with_path(want)):
        b = b.cpu()
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max()), k


def test_nccl_ranks_with_a_card_each(dev):
    """The NCCL transport, one card a rank: a ring hop and an all-reduce
    on the cards, nothing staged through the host.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card of its own for every rank; this "
                    "machine has fewer than 2 cards")
    import _torch_rank_jobs as J
    from repro_torch.core import ranks
    p = ranks.RankPool(2, transport="nccl")
    try:
        out = p.run(J.nccl_ring)
    finally:
        p.close()
    for r, (got, total, staged) in enumerate(out):
        assert (got == (r - 1) % 2).all() and (total == 1).all()
        assert staged == 0
