"""Card-only tests of the PyTorch port: the CUDA Smith-Waterman kernels (the
warp kernel at every Qp up to 1024, the block kernel above) held against
their plain PyTorch version on the card, exactly, and the farm search
launching them once per task or once per chunk of the database; the flash-attention kernels (bf16: wgmma with
TMA loads, on its edge cases; f32: the SIMT kernel) and the SSD kernels
(five passes per call) and their backward (four kernels per call) against
their plain versions, on their edge cases; training steps of every family
through the kernels, forward and backward, against the CPU;
the Zamba2 smoke prefill launching both; the MoE grouped dispatch against
its dense oracle, the smoke prefill of the moe, vlm and audio families
through the FA kernel, CUDA tensors crossing a procs farm on the
host (the shared-memory ring's tensor edge), and the device backend
``lower(.., "mesh")`` on the card: a Farm, a Feedback and a keyed
reduction equal to the threads backend, and a device farm of SW scores
equal to ``sw_plain``.  They carry the ``gpu`` marker
and skip where there is no card.  This file imports neither jax nor the
reference package, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import FnNode, TaskFarm
from repro_torch.kernels import ops
from repro_torch.kernels import smith_waterman as sw

pytestmark = pytest.mark.gpu
GAPS = [(10.0, 2.0), (5.0, 2.0)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _codes(rng, n):
    return torch.from_numpy(rng.integers(0, 20, n).astype(np.int32))


# Every warp-kernel instance (Qp = 128 .. 1024), both sides of the dispatch
# (Qp 1024 and 1152), and the block kernel at Qp 4096.
@pytest.mark.parametrize("qlen", [1, 129, 144, 257, 385, 513, 641, 769, 897,
                                  1000, 1024, 1152, 4000])
def test_kernel_equals_plain_on_card(dev, qlen):
    rng = np.random.default_rng(qlen)
    prof, q_len = ops.build_profile(_codes(rng, qlen).to(dev),
                                    ops.BLOSUM50.to(dev))
    lens = [1, 17, 352, 513]
    batch = torch.full((4, 513), 24, dtype=torch.int32)
    for i, n in enumerate(lens):
        batch[i, :n] = _codes(rng, n)
    batch = batch.to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    for go, ge in GAPS:
        got = sw.sw_batch(prof, batch, lengths, gap_open=go, gap_extend=ge,
                          q_len=q_len)
        want = sw.sw_plain(prof, batch, go, ge, q_len)
        assert torch.equal(got, want)


@pytest.mark.parametrize("B", [1, 7, 9, 33])   # not multiples of 4 or 8 warps
@pytest.mark.parametrize("qlen", [1000, 1152])
def test_kernel_batch_edges_on_card(dev, B, qlen):
    """Tail warps, empty subjects, interior codes >= A, negative codes (row
    0, as the reference clips them), junk past the lengths, and a profile
    whose padded query rows score +7, so that they would win if the kernel
    let them into the best score."""
    rng = np.random.default_rng(B * qlen)
    prof, q_len = ops.build_profile(_codes(rng, qlen).to(dev),
                                    ops.BLOSUM50.to(dev))
    prof[:, q_len:] = 7.0
    A = prof.shape[0]
    lens = rng.integers(0, 400, B)
    lens[0] = 0
    subjects = [rng.integers(0, 20, n).astype(np.int32) for n in lens]
    if B > 2:
        subjects[1][::3] = A + 5
        subjects[2][1::4] = -3
    subj, lengths = sw.pack_subjects(subjects, A, dev)
    subj = torch.cat([subj, torch.full((B, 9), 3, dtype=torch.int32,
                                       device=dev)], 1)   # junk past lengths
    for go, ge in GAPS + [(10.3, 2.1)]:
        got = sw.sw_batch(prof, subj, lengths, gap_open=go, gap_extend=ge,
                          q_len=q_len)
        live = torch.arange(subj.shape[1], device=dev) < lengths[:, None]
        want = sw.sw_plain(prof, torch.where(live, subj, A), go, ge, q_len)
        assert torch.equal(got, want), (go, ge, got.tolist(), want.tolist())


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


def test_fa_forward_without_grad_writes_no_stats_on_card(dev, monkeypatch):
    """Without autograd the forward launches once with no statistics
    buffer, as before the backward read them, and its output equals the
    stats-writing launch's bit for bit; with grad on, bf16 writes them."""
    from repro_torch.kernels import flash_attention as fa
    calls = []
    launch = fa._fa_launch

    def spy(q, k, v, c, w, o, stats=None):
        calls.append(stats)
        return launch(q, k, v, c, w, o, stats=stats)

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
