"""The flash-attention backward of the PyTorch port against the JAX package,
on the CPU.

``fa_backward_plain`` (the backward kernel's three steps in eager PyTorch)
is held against ``jax.grad`` of the reference's ``chunked_attention`` (and
``naive_attention`` at tiny shapes), and against ``torch.autograd`` of the
port's ``fa_plain``: causal, windowed, non-causal cross-attention with
S != T and ragged T, q_offset, GQA and MQA, D = 96, and rows whose every
key is masked.  The same numpy inputs and output gradient go to both
packages.  Tolerance 1e-5 in f32 (absolute, on gradients of order 1): the
sums run in another order.  The kernel itself runs in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa

from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5

# (B, H, Hkv, S, T, D, causal, window, q_offset); T is a multiple of the
# reference's kv chunk (8) wherever a row has every key masked, so that the
# reference's padded kv slots do not enter such a row's average.
CASES = {
    "causal": (1, 4, 4, 40, 40, 16, True, None, 0),
    "window_gqa": (2, 4, 2, 50, 50, 16, True, 7, 0),
    "cross_ragged_mqa": (1, 4, 1, 24, 37, 16, False, None, 0),
    "q_offset": (1, 2, 2, 16, 40, 16, True, None, 24),
    "d96": (1, 2, 2, 20, 20, 96, True, None, 0),
    "masked_rows_causal": (1, 2, 1, 32, 32, 16, True, None, -3),
    "masked_rows_window": (1, 2, 2, 30, 24, 16, False, 4, 0),
}


def _inputs(case, seed=0):
    B, H, Hkv, S, T, D, causal, window, q_offset = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, do, dict(causal=causal, window=window, q_offset=q_offset)


def _jax_grads(fn, q, k, v, do, kw):
    """(dq, dk, dv) of sum(fn(q, k, v) * do) in the (B, S, H, D) layout."""
    loss = lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_, **kw) * do)
    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _plain_grads(q, k, v, do, kw, kv_tile=None):
    """fa_backward_plain on the (B, H, S, D) views, back in (B, S, H, D)."""
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    o = fa.fa_plain(qt, kt, vt, **kw)
    grads = fa.fa_backward_plain(qt, kt, vt, o, dot, kv_tile=kv_tile, **kw)
    return [g.transpose(1, 2).numpy() for g in grads]


def _masked_rows(case):
    B, H, Hkv, S, T, D, causal, window, q_offset = case
    qpos = np.arange(S)[:, None] + q_offset
    kpos = np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return int((~ok.any(axis=1)).sum())


def test_cases_include_rows_whose_keys_are_all_masked():
    assert _masked_rows(CASES["masked_rows_causal"]) == 3
    assert _masked_rows(CASES["masked_rows_window"]) == 3
    assert all(_masked_rows(c) == 0 for n, c in CASES.items()
               if not n.startswith("masked"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_plain_matches_jax_grad_of_chunked_attention(name):
    q, k, v, do, kw = _inputs(CASES[name])
    want = _jax_grads(lambda *a, **kw_: jattn.chunked_attention(
        *a, q_chunk=16, kv_chunk=8, **kw_), q, k, v, do, kw)
    for g, w in zip(_plain_grads(q, k, v, do, kw), want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["causal", "cross_ragged_mqa",
                                  "masked_rows_causal", "masked_rows_window"])
def test_backward_plain_matches_jax_grad_of_naive_attention(name):
    q, k, v, do, kw = _inputs(CASES[name], seed=1)
    want = _jax_grads(jattn.naive_attention, q, k, v, do, kw)
    for g, w in zip(_plain_grads(q, k, v, do, kw), want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_plain_matches_autograd_of_fa_plain(name):
    q, k, v, do, kw = _inputs(CASES[name], seed=2)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2).requires_grad_()
                  for a in (q, k, v))
    out = fa.fa_plain(qt, kt, vt, **kw)
    out.backward(torch.from_numpy(do).transpose(1, 2))
    got = _plain_grads(q, k, v, do, kw)
    for g, t in zip(got, (qt, kt, vt)):
        np.testing.assert_allclose(g, t.grad.transpose(1, 2).numpy(),
                                   atol=TOL, rtol=0)


def _tiled_forward(q, k, v, *, causal, window, q_offset, kv_tile):
    """The CUDA forward kernel's function, written out: a row's softmax
    runs over the slots of the kv tiles its 64-row q group visits, padding
    past T included (score NEG, value 0); a row with none is 0."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    n_kt = -(-T // kv_tile)
    pad = n_kt * kv_tile - T
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    g = H // Hkv
    kp, vp = kp.repeat_interleave(g, dim=1), vp.repeat_interleave(g, dim=1)
    qpos = torch.arange(S)[:, None] + q_offset
    kpos = torch.arange(n_kt * kv_tile)[None, :]
    ok = kpos < T
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    glo = torch.arange(S)[:, None] // 64 * 64 + q_offset
    kv0 = kpos // kv_tile * kv_tile
    seen = torch.ones_like(ok)
    if causal:
        seen = seen & (kv0 <= glo + 63)
    if window is not None:
        seen = seen & (kv0 + kv_tile - 1 > glo - window)
    s = torch.where(ok, (q @ kp.transpose(-1, -2)) * D ** -0.5, fa.NEG)
    s = torch.where(seen, s, -torch.inf)
    live = seen.any(dim=1)[:, None]
    p = torch.softmax(torch.where(live, s, 0.0), dim=-1) * live
    return p @ vp


@pytest.mark.parametrize("kv_tile", [64, 128])
@pytest.mark.parametrize("case", [
    (1, 2, 1, 70, 70, 16, True, None, -3),     # rows 0-2 masked, 2 q groups
    (1, 2, 2, 300, 100, 16, False, 30, 0),     # rows 129+ masked: group 128
                                               # sees a tile, 192 and 256 none
    (1, 2, 2, 200, 130, 16, True, 9, 0),       # window, ragged T, no masked row
])
def test_backward_plain_follows_the_kernels_tile_visits(case, kv_tile):
    """With ``kv_tile``, fa_backward_plain is the gradient of the forward
    kernel's function, whose fully masked rows average v over the visited
    tiles' slots."""
    q, k, v, do, kw = _inputs(case, seed=3)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2).double().requires_grad_()
                  for a in (q, k, v))
    out = _tiled_forward(qt, kt, vt, kv_tile=kv_tile, **kw)
    out.backward(torch.from_numpy(do).transpose(1, 2).double())
    got = _plain_grads(q, k, v, do, kw, kv_tile=kv_tile)
    for g, t in zip(got, (qt, kt, vt)):
        np.testing.assert_allclose(g, t.grad.transpose(1, 2).numpy(),
                                   atol=TOL, rtol=0)
    # and outside the fully masked rows the two plain forms agree
    plain = _plain_grads(q, k, v, do, kw)
    if _masked_rows(case) == 0:
        for g, p in zip(got, plain):
            np.testing.assert_allclose(g, p, atol=TOL, rtol=0)


def test_function_plumbing_on_views(monkeypatch):
    """FlashAttentionFn saves q, k, v and o and returns one gradient per
    input in its layout; on the CPU its two launches are replaced by the
    plain versions, which is what the card's kernels are held to."""
    monkeypatch.setattr(fa, "_fa_launch", lambda q, k, v, c, w, o, stats=None:
                        fa.fa_plain(q, k, v, causal=c, window=w, q_offset=o))
    monkeypatch.setattr(fa, "fa_backward", fa.fa_backward_plain)
    q, k, v, do, kw = _inputs(CASES["window_gqa"], seed=4)
    qs, ks, vs = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.FlashAttentionFn.apply(qs.transpose(1, 2), ks.transpose(1, 2),
                                    vs.transpose(1, 2), kw["causal"],
                                    kw["window"], kw["q_offset"])
    (out.transpose(1, 2) * torch.from_numpy(do)).sum().backward()
    want = _plain_grads(q, k, v, do, kw)
    for t, w in zip((qs, ks, vs), want):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.numpy(), w, atol=TOL, rtol=0)


def test_backward_plain_keeps_dtypes_and_refuses_the_kernel_on_cpu():
    q, k, v, do, kw = _inputs(CASES["causal"], seed=5)
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2).bfloat16()
                       for a in (q, k, v, do))
    o = fa.fa_plain(qt, kt, vt)
    assert all(g.dtype == torch.bfloat16 for g in
               fa.fa_backward_plain(qt, kt, vt, o, dot))
    with pytest.raises(ValueError, match="runs on CUDA"):
        fa.fa_backward(qt, kt, vt, o, dot, stats=fa.fa_stats_plain(qt, kt))


# -- the softmax statistics the bf16 forward kernel saves ------------------
def _visited_slots(case, kv_tile):
    """Per q row, the kv slots its 64-row group visits (padding included)."""
    B, H, Hkv, S, T, D, causal, window, q_offset = case
    if kv_tile is None:
        return np.full(S, T)
    n_kt = -(-T // kv_tile)
    kv0 = np.arange(n_kt)[None, :] * kv_tile
    glo = (np.arange(S) // 64 * 64 + q_offset)[:, None]
    seen = np.ones((S, n_kt), bool)
    if causal:
        seen &= kv0 <= glo + 63
    if window is not None:
        seen &= kv0 + kv_tile - 1 > glo - window
    return seen.sum(axis=1) * kv_tile


@pytest.mark.parametrize("kv_tile", [None, 64, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_stats_plain_is_the_logsumexp_of_jax_scores(name, kv_tile):
    """fa_stats_plain's m (base 2) and 1/l give m·ln 2 + log l equal to
    jax.nn.logsumexp of the reference's masked, scaled scores on every row
    with a visible key, within 1e-5 (absolute, on values of order 1-10: the
    sums run in another order); a row whose keys are all masked reads m =
    NEG2 exactly and 1/l = 1 / its visited slots (0 with none)."""
    case = CASES[name]
    B, H, Hkv, S, T, D, causal, window, q_offset = case
    q, k, _, _, kw = _inputs(case, seed=6)
    qt, kt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k))
    stats = fa.fa_stats_plain(qt, kt, kv_tile=kv_tile, **kw).numpy()
    m, inv_l = (x.reshape(B, H, S) for x in stats)

    kj = jnp.repeat(jnp.asarray(k), H // Hkv, axis=2)
    scores = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kj) * D ** -0.5
    qpos = np.arange(S)[:, None] + q_offset
    kpos = np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    want = np.asarray(jax.nn.logsumexp(jnp.where(ok, scores, -jnp.inf), axis=-1))
    live = ok.any(axis=1)
    got = m * np.log(2.0) - np.log(np.where(inv_l > 0, inv_l, 1.0))
    np.testing.assert_allclose(got[..., live], want[..., live], atol=TOL, rtol=0)
    if not live.all():
        assert (m[..., ~live] == np.float32(fa.NEG2)).all()
        slots = _visited_slots(case, kv_tile)[~live]
        recip = np.where(slots > 0, 1.0 / np.maximum(slots, 1), 0.0)
        np.testing.assert_allclose(inv_l[..., ~live],
                                   np.broadcast_to(recip, inv_l[..., ~live].shape),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv_tile", [None, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_plain_with_given_stats_is_exact(name, kv_tile):
    """fa_backward_plain(stats=fa_stats_plain(...)) equals
    fa_backward_plain() bit for bit: step 1 is that function."""
    q, k, v, do, kw = _inputs(CASES[name], seed=7)
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    o = fa.fa_plain(qt, kt, vt, **kw)
    stats = fa.fa_stats_plain(qt, kt, kv_tile=kv_tile, **kw)
    got = fa.fa_backward_plain(qt, kt, vt, o, dot, kv_tile=kv_tile,
                               stats=stats, **kw)
    want = fa.fa_backward_plain(qt, kt, vt, o, dot, kv_tile=kv_tile, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_function_saves_stats_and_recomputes_them_under_checkpoint(monkeypatch):
    """In bfloat16 FlashAttentionFn has the forward write the statistics
    and saves them with save_for_backward; under a non-reentrant
    torch.utils.checkpoint they are dropped with the layer and written
    again by the recompute, and the gradients equal fa_backward_plain's
    exactly.  The launches are the plain versions on the CPU, as in
    test_function_plumbing_on_views."""
    launches = []

    def launch(q, k, v, c, w, o, stats=None):
        launches.append(stats)
        if stats is not None:
            stats.copy_(fa.fa_stats_plain(q, k, causal=c, window=w, q_offset=o))
        return fa.fa_plain(q, k, v, causal=c, window=w, q_offset=o)

    def backward(q, k, v, o, do, *, causal, window, q_offset, stats):
        assert stats is not None and stats.shape == (2, B * H * S)
        return fa.fa_backward_plain(q, k, v, o, do, causal=causal,
                                    window=window, q_offset=q_offset,
                                    stats=stats)

    monkeypatch.setattr(fa, "_fa_launch", launch)
    monkeypatch.setattr(fa, "fa_backward", backward)
    case = CASES["window_gqa"]
    B, H, _, S = case[:4]
    q, k, v, do, kw = _inputs(case, seed=8)
    args = (kw["causal"], kw["window"], kw["q_offset"])
    qs, ks, vs = (torch.from_numpy(a).bfloat16().transpose(1, 2) for a in (q, k, v))
    dot = torch.from_numpy(do).bfloat16().transpose(1, 2)

    saved = []
    leaves = [t.detach().clone().requires_grad_() for t in (qs, ks, vs)]
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = fa.FlashAttentionFn.apply(*leaves, *args)
    assert len(launches) == 1 and launches[0] is not None
    assert any(t is launches[0] for t in saved), "stats not saved"

    ck = [t.detach().clone().requires_grad_() for t in (qs, ks, vs)]
    out_ck = torch.utils.checkpoint.checkpoint(
        fa.FlashAttentionFn.apply, *ck, *args, use_reentrant=False)
    out_ck.backward(dot)
    assert len(launches) == 3 and all(s is not None for s in launches)
    assert launches[2] is not launches[1], "the recompute wrote no stats"
    want = fa.fa_backward_plain(qs, ks, vs, out.detach(), dot, **kw)
    for t, w in zip(ck, want):
        assert t.grad.dtype == torch.bfloat16
        assert torch.equal(t.grad, w)


def test_bf16_backward_needs_the_forward_stats():
    q, k, v, do, kw = _inputs(CASES["causal"], seed=9)
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2).bfloat16()
                       for a in (q, k, v, do))
    o, stats = fa.fa_forward_with_stats(qt, kt, vt, **kw)
    assert torch.equal(o, fa.fa_plain(qt, kt, vt, **kw))
    assert torch.equal(stats, fa.fa_stats_plain(qt, kt, **kw))
    with pytest.raises(ValueError, match="fa_forward_with_stats"):
        fa.fa_backward(qt, kt, vt, o, dot, **kw)


def test_f32_backward_refuses_stats():
    """The float32 backward kernels recompute the statistics, so a stats
    tensor passed with float32 inputs is refused rather than ignored."""
    q, k, v, do, kw = _inputs(CASES["causal"], seed=9)
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    o = fa.fa_plain(qt, kt, vt, **kw)
    with pytest.raises(ValueError, match="bfloat16 only"):
        fa.fa_backward(qt, kt, vt, o, dot, stats=fa.fa_stats_plain(qt, kt, **kw),
                       **kw)


@pytest.mark.parametrize("kv_tile", [64, 128])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_follows_the_kernels_tile_visits(name, kv_tile):
    """``fa_plain(kv_tile=)`` is the CUDA forward kernel's function, written
    out in ``_tiled_forward``: within 1e-5 on every row (f32 against f64),
    and equal to ``fa_plain()`` on every row with a visible key."""
    case = CASES[name]
    q, k, v, _, kw = _inputs(case, seed=4)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = fa.fa_plain(qt, kt, vt, kv_tile=kv_tile, **kw)
    want = _tiled_forward(qt.double(), kt.double(), vt.double(),
                          kv_tile=kv_tile, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    B, H, Hkv, S, T, D, causal, window, q_offset = case
    qpos = np.arange(S)[:, None] + q_offset
    kpos = np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    live = torch.from_numpy(ok.any(axis=1))
    every = fa.fa_plain(qt, kt, vt, **kw)
    assert torch.equal(got[:, :, live], every[:, :, live])
    assert (_masked_rows(case) > 0) == (not torch.equal(got, every))
