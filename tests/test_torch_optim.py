"""The port's optimizer against the JAX package, on the CPU.

The same numpy trees go through ``repro.optim`` and ``repro_torch.optim``:
the cosine schedule, global-norm clipping, AdamW (f32 and bf16 moments,
1-d leaves without weight decay, large stacked leaves walked one layer
at a time), int8 quantisation and gradient accumulation.  Tolerance 1e-6
(absolute, on values of order 1; the bf16 moments within one bf16 ulp):
the same f32 arithmetic, with sums taken in another order.  Then the
port's versions of the reference's own optimizer tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.tree import tree_leaves

from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


def _tree(seed, dtype=np.float32):
    """A parameter-like tree: a stacked 3-d leaf, a matrix, a 1-d scale."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.standard_normal((3, 4, 5)).astype(dtype),
                       "norm": (1 + 0.1 * rng.standard_normal((3, 5))).astype(dtype)},
            "head": rng.standard_normal((6, 5)).astype(dtype),
            "scale": (1 + 0.1 * rng.standard_normal(5)).astype(dtype)}


def _j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _t(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype),
                        tree)


def _close(got, want, tol=TOL):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(jnp.asarray(w, jnp.float32)),
                                   atol=tol, rtol=0)


def test_cosine_schedule_matches_jax():
    steps = np.arange(0, 130)
    want = jopt.cosine_schedule(jnp.asarray(steps), peak_lr=3e-4,
                                warmup_steps=10, total_steps=120)
    got = topt.cosine_schedule(torch.from_numpy(steps), peak_lr=3e-4,
                               warmup_steps=10, total_steps=120)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, rtol=1e-6)
    assert float(topt.cosine_schedule(7, peak_lr=1.0, warmup_steps=10,
                                      total_steps=100)) == pytest.approx(0.7)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(1)
    want, wn = jopt.clip_by_global_norm(_j(g), max_norm)
    got_tree = _t(g)
    got, gn = topt.clip_by_global_norm(got_tree, max_norm)
    assert got is got_tree                         # scaled in place
    assert abs(float(gn) - float(wn)) <= TOL * float(wn)
    _close(got, want)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("params_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moments, params_dtype):
    """Three steps; weight decay on the stacked and matrix leaves only."""
    jd, td = getattr(jnp, params_dtype), getattr(torch, params_dtype)
    jm, tm = getattr(jnp, moments), getattr(torch, moments)
    p0 = _tree(2)
    jp, tp = _j(p0, jd), _t(p0, td)
    jo, to = jopt.adamw_init(jp, jm), topt.adamw_init(tp, tm)
    for i in range(3):
        g = _tree(10 + i)
        lr = 1e-2 * (i + 1)
        jp, jo, jmet = jopt.adamw_update(jp, _j(g, jd), jo, lr=jnp.float32(lr))
        tp, to, tmet = topt.adamw_update(tp, _t(g, td), to, lr=lr)
        assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= 1e-5
    assert int(to.step) == int(jo.step) == 3
    assert all(p.dtype == td for p in tree_leaves(tp))
    assert all(m.dtype == tm for m in tree_leaves(to.mu) + tree_leaves(to.nu))
    # bf16 leaves: one rounding of a value of order 1 may land one ulp apart
    ulp = 2 ** -7
    _close(tp, jp, TOL if params_dtype == "float32" else ulp * 4)
    mtol = TOL if moments == "float32" else ulp
    _close(to.mu, jo.mu, mtol)
    _close(to.nu, jo.nu, mtol)


def test_adamw_walks_a_leaf_by_layer_only_where_a_layer_is_large(monkeypatch):
    """A leaf of three or more dimensions is walked one index of its leading
    axis at a time where an index holds SLICE_MIN elements or more (a layer
    of a stack at full width); a shared block's (d, H, hd) leaf at Zamba2's
    width goes whole.  The walk does not change the update: with SLICE_MIN
    lowered so that the test tree's stacked leaf is walked by layer, three
    unclipped steps give the whole-leaf steps' parameters and moments bit
    for bit, and the grad norm within 1e-6 of it (a sum in parts)."""
    from repro_torch.optim import adamw
    meta = lambda *shape: torch.empty(shape, device="meta")
    assert len(list(adamw._slices(meta(2560, 32, 80)))) == 1
    assert len(list(adamw._slices(meta(32, 3072, 8192)))) == 32
    assert len(list(adamw._slices(meta(4096, 8192)))) == 1
    runs = []
    for smin in (adamw.SLICE_MIN, 1):
        monkeypatch.setattr(adamw, "SLICE_MIN", smin)
        assert len(list(adamw._slices(torch.empty((3, 4, 5))))) == (3 if smin == 1 else 1)
        tp = _t(_tree(2))
        to = topt.adamw_init(tp)
        norms = []
        for i in range(3):
            tp, to, met = topt.adamw_update(tp, _t(_tree(10 + i)), to, lr=1e-2,
                                            max_grad_norm=1e3)
            norms.append(float(met["grad_norm"]))
        runs.append((tree_leaves(tp) + tree_leaves(to.mu) + tree_leaves(to.nu), norms))
    (whole, n_whole), (walked, n_walked) = runs
    assert all(torch.equal(a, b) for a, b in zip(whole, walked))
    np.testing.assert_allclose(n_walked, n_whole, rtol=1e-6, atol=0)


def test_adamw_skips_weight_decay_on_1d_leaves():
    p = {"w": torch.ones((2, 2)), "b": torch.ones(2)}
    opt = topt.adamw_init(p)
    zero = {"w": torch.zeros((2, 2)), "b": torch.zeros(2)}
    topt.adamw_update(p, zero, opt, lr=0.5, weight_decay=0.1)
    assert torch.equal(p["b"], torch.ones(2))
    torch.testing.assert_close(p["w"], torch.full((2, 2), 0.95))


def test_int8_quantize_matches_jax():
    x = np.random.default_rng(3).standard_normal(2500).astype(np.float32) * 3
    jq, js = jopt.int8_quantize(jnp.asarray(x))
    tq, ts = topt.int8_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tq.shape == (3, 1024)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=0, rtol=TOL)
    back = topt.int8_dequantize(tq, ts, (50, 50), torch.float32)
    want = jopt.int8_dequantize(jq, js, (50, 50), jnp.float32)
    np.testing.assert_allclose(back.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_accumulate_grads_matches_jax():
    """Four microbatches of a least-squares loss: the mean loss, the last
    microbatch's metrics and the mean gradient in f32."""
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    xs = rng.standard_normal((4, 8, 5)).astype(np.float32)
    ys = rng.standard_normal((4, 8, 3)).astype(np.float32)

    def jfn(p, mb):
        r = mb["x"] @ p["w"] - mb["y"]
        loss = jnp.mean(r * r)
        return (loss, {"r0": r[0, 0]}), jax.grad(
            lambda q: jnp.mean((mb["x"] @ q["w"] - mb["y"]) ** 2))(p)

    def tfn(p, mb):
        w = p["w"].detach().requires_grad_()
        r = mb["x"] @ w - mb["y"]
        loss = torch.mean(r * r)
        (g,) = torch.autograd.grad(loss, [w])
        return (loss.detach(), {"r0": r[0, 0].detach()}), {"w": g}

    jl, jmet, jg = jopt.accumulate_grads(
        jfn, {"w": jnp.asarray(w0)}, {"x": jnp.asarray(xs), "y": jnp.asarray(ys)})
    tl, tmet, tg = topt.accumulate_grads(
        tfn, {"w": torch.from_numpy(w0)},
        {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)})
    assert abs(float(tl) - float(jl)) <= TOL
    assert abs(float(tmet["r0"]) - float(jmet["r0"][-1])) <= TOL
    assert tg["w"].dtype == torch.float32
    np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]), atol=TOL, rtol=0)


# -- the port's versions of tests/test_runtime.py's optimizer tests ----------
def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = topt.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw of w^2
        params, opt, _ = topt.adamw_update(params, grads, opt, lr=0.05,
                                           weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.3


def test_cosine_schedule_shape():
    s = topt.cosine_schedule(torch.arange(100), peak_lr=1.0, warmup_steps=10,
                             total_steps=100, min_ratio=0.1)
    assert float(s[0]) == 0.0
    assert abs(float(s[10]) - 1.0) < 0.11
    assert float(s[99]) < 0.2
    assert bool((s >= 0).all())


def test_int8_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32)) * 3
    q, s = topt.int8_quantize(x)
    back = topt.int8_dequantize(q, s, x.shape, x.dtype)
    err = (back - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_bf16_moments_halve_optimizer_bytes():
    params = {"w": torch.zeros((1024,), dtype=torch.bfloat16)}
    o32 = topt.adamw_init(params, torch.float32)
    o16 = topt.adamw_init(params, torch.bfloat16)
    assert o32.mu["w"].dtype == torch.float32 and o16.mu["w"].dtype == torch.bfloat16
    nbytes = lambda o: sum(t.numel() * t.element_size()
                           for t in tree_leaves(o.mu) + tree_leaves(o.nu))
    assert nbytes(o16) * 2 == nbytes(o32)
