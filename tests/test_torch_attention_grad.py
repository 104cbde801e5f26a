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
    monkeypatch.setattr(fa, "_fa_launch", lambda q, k, v, c, w, o: fa.fa_plain(
        q, k, v, causal=c, window=w, q_offset=o))
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
        fa.fa_backward(qt, kt, vt, o, dot)
