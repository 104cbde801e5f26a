"""The SSD backward of the PyTorch port against the JAX package, on the CPU.

``ssd_backward_plain`` (the backward kernels' decomposition in eager
PyTorch) is held against ``jax.grad`` of the reference's ``ssd_chunked``
(``repro.models.ssm``) on the same numpy inputs and cotangents, in both
compute dtypes, with and without h0, with a cotangent on y alone and on y
and the final state, over one chunk, several chunks, a ragged P and N
(5, 7) and N = 128.  Tolerances, each of a gradient's largest |want|: 1e-5
with f32 products (the same steps, sums in another order); 5e-2 with bf16
products, the reference's bf16 tolerance (JAX also rounds the cotangents
where they pass the casts, which the port leaves unrounded, as the kernels
do).  The kernels themselves run in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.models import ssm as jssm
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm as tssm

from _torch_threads import one_torch_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")

SHAPES = {  # b, T, H, P, N, chunk
    "one_chunk": (2, 32, 3, 8, 16, 32),
    "chunks": (2, 64, 3, 8, 16, 16),
    "ragged_p5_n7": (1, 60, 2, 5, 7, 20),
    "n128": (1, 64, 2, 8, 128, 32),
}


def _inputs(seed, b, T, H, P, N, with_h0, with_dh):
    """x, dt, A, B, C, h0 and the cotangents dy, dh (None where absent)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, T, H)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    B = rng.standard_normal((b, T, N)).astype(np.float32)
    C = rng.standard_normal((b, T, N)).astype(np.float32)
    h0 = rng.standard_normal((b, H, P, N)).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dh = rng.standard_normal((b, H, P, N)).astype(np.float32) if with_dh else None
    return [x, dt, A, B, C], h0, dy, dh


def _jax_grads(args, h0, dy, dh, chunk, compute):
    """(dx, ddt, dA, dB, dC, dh0) of Σ y·dy + Σ h·dh through the reference."""
    cd = getattr(jnp, compute)

    def loss(x, dt, A, B, C, h0):
        y, h = jssm.ssd_chunked(x, dt, A, B, C, chunk, h0=h0, compute_dtype=cd)
        out = jnp.sum(y * dy)
        return out if dh is None else out + jnp.sum(h * dh)

    jargs = [jnp.asarray(a) for a in args]
    if h0 is None:
        grads = jax.grad(lambda *a: loss(*a, None), argnums=tuple(range(5)))(*jargs)
        return [np.asarray(g) for g in grads] + [None]
    grads = jax.grad(loss, argnums=tuple(range(6)))(*jargs, jnp.asarray(h0))
    return [np.asarray(g) for g in grads]


def _plain(args, h0, dy, dh, chunk, compute_dtype):
    t = [torch.from_numpy(a) for a in args]
    return ssd.ssd_backward_plain(
        *t, chunk, torch.from_numpy(dy),
        dh_final=None if dh is None else torch.from_numpy(dh),
        h0=None if h0 is None else torch.from_numpy(h0),
        compute_dtype=compute_dtype)


def _assert_close(got, want, tol, names=NAMES):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        g = np.asarray(g.double() if isinstance(g, torch.Tensor) else g, np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{name}: max |diff| {err} > {tol} * {scale}"


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_backward_plain_matches_jax_grad_of_ssd_chunked(shape, compute,
                                                        with_h0, with_dh):
    b, T, H, P, N, chunk = SHAPES[shape]
    args, h0, dy, dh = _inputs(T + P + N, b, T, H, P, N, with_h0, with_dh)
    want = _jax_grads(args, h0, dy, dh, chunk, compute)
    got = _plain(args, h0, dy, dh, chunk, getattr(torch, compute))
    assert [g.dtype for g in got[:5]] == [torch.float32] * 5
    _assert_close(got, want, TOL[compute])


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", ["chunks", "ragged_p5_n7"])
def test_backward_plain_matches_autograd_of_ssd_plain(shape, with_h0):
    """Against torch.autograd of ssd_plain on the same inputs: 1e-5 (f32;
    the same function, sums in another order)."""
    b, T, H, P, N, chunk = SHAPES[shape]
    args, h0, dy, dh = _inputs(7, b, T, H, P, N, with_h0, True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    y, h = ssd.ssd_plain(*leaves, chunk, h0=th0)
    loss = (y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()
    want = torch.autograd.grad(loss, leaves + ([] if th0 is None else [th0]))
    want = [w.numpy() for w in want] + ([None] if th0 is None else [])
    _assert_close(_plain(args, h0, dy, dh, chunk, torch.float32), want, 1e-5)


def test_backward_plain_keeps_the_inputs_dtypes():
    """bf16 x, B and C get bf16 gradients; ddt, dA and dh0 stay f32."""
    args, h0, dy, dh = _inputs(3, *SHAPES["chunks"][:5], True, True)
    t = [torch.from_numpy(a) for a in args]
    t[0], t[3], t[4] = t[0].bfloat16(), t[3].bfloat16(), t[4].bfloat16()
    got = ssd.ssd_backward_plain(*t, 16, torch.from_numpy(dy),
                                 dh_final=torch.from_numpy(dh),
                                 h0=torch.from_numpy(h0),
                                 compute_dtype=torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    with pytest.raises(ValueError, match="runs on CUDA"):
        ssd.ssd_backward(*t, 16, torch.from_numpy(dy), None)


@pytest.mark.parametrize("with_h0", [False, True])
def test_backward_f32_against_f64_witness_at_chunk_1024(with_h0):
    """Chunk 1024 with steep decays (A = -13.5, so cs reaches about -1e3):
    ``ssd_backward_plain`` with ``compute_dtype=torch.float64`` evaluates
    every step in float64 and is the witness, which itself equals
    torch.autograd of the float64 ``ssd_plain`` within 1e-9 of each
    gradient's max |want|.  The f32 form drifts from it, as the forward
    does (tests/test_torch_ssm.py), but stays within 1e-2 of each max
    |want|: at chunks over 256 the card's kernels are held against the
    witness, not against the f32 form."""
    b, T, H, P, N, l = 1, 2048, 2, 16, 32, 1024
    args, h0, dy, dh = _inputs(5, b, T, H, P, N, with_h0, True)
    args[2] = np.full(H, -13.5, np.float32)
    t = [torch.from_numpy(a) for a in args]
    th0 = None if h0 is None else torch.from_numpy(h0)
    kw = dict(dh_final=torch.from_numpy(dh), h0=th0)
    wit = ssd.ssd_backward_plain(*t, l, torch.from_numpy(dy),
                                 compute_dtype=torch.float64, **kw)
    assert all(g is None or g.dtype == torch.float64 for g in wit)
    assert float(torch.cumsum(t[1][0, :l, 0].double() * -13.5, 0)[-1]) < -900

    leaves = [a.double().requires_grad_() for a in t]
    h64 = None if th0 is None else th0.double().requires_grad_()
    y, h = ssd.ssd_plain(*leaves, l, h0=h64, compute_dtype=torch.float64)
    loss = (y * torch.from_numpy(dy).double()).sum() + \
        (h * torch.from_numpy(dh).double()).sum()
    want = torch.autograd.grad(loss, leaves + ([] if h64 is None else [h64]))
    want = [w.numpy() for w in want] + ([None] if h64 is None else [])
    _assert_close(wit, want, 1e-9)
    f32 = ssd.ssd_backward_plain(*t, l, torch.from_numpy(dy), **kw)
    _assert_close(f32, [None if w is None else w.numpy() for w in wit], 1e-2)


# -- SsdScanFn's plumbing, with its launches replaced by the plain versions --
def _same(a, b):
    """Whether two scratch tuples hold the same storage, tensor by tensor."""
    return all(x.data_ptr() == y.data_ptr() for x, y in zip(a, b))


def _fake_launches(monkeypatch, log):
    """Replace the forward and backward launches by the plain versions; the
    forward hands out fresh scratch tensors, which ``log`` records."""
    def launch(x, dt, A, B, C, h0, l, cd):
        b, T, H, P = x.shape
        N, nc = B.shape[-1], T // l
        scratch = (torch.zeros((b, H, nc, l), dtype=torch.float64),
                   torch.zeros((b, nc, l, l)), torch.zeros((b, nc, H, N, P)))
        log.append(("fwd", scratch))
        y, h = ssd.ssd_plain(x, dt, A, B, C, l, h0=h0, compute_dtype=cd)
        return y, h, scratch

    def backward(x, dt, A, B, C, chunk, dy, scratch, *, dh_final, h0,
                 compute_dtype):
        log.append(("bwd", scratch))
        assert dy.is_contiguous() and dy.dtype == torch.float32
        return ssd.ssd_backward_plain(x, dt, A, B, C, chunk, dy,
                                      dh_final=dh_final, h0=h0,
                                      compute_dtype=compute_dtype)

    monkeypatch.setattr(ssd, "_ssd_launch", launch)
    monkeypatch.setattr(ssd, "ssd_backward", backward)


@pytest.mark.parametrize("uses", ["y", "y_and_h", "h"])
def test_function_plumbing_on_views(monkeypatch, uses):
    """SsdScanFn returns one gradient per input: a non-contiguous output
    gradient (y used through a transposed view) is made contiguous, an
    output that the loss does not use is a None cotangent (zero), h0 gets
    dh0, and the gradients equal ssd_backward_plain's exactly."""
    log = []
    _fake_launches(monkeypatch, log)
    b, T, H, P, N, chunk = SHAPES["chunks"]
    args, h0, dy, dh = _inputs(11, b, T, H, P, N, True, True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args + [h0]]
    y, h = ssd.SsdScanFn.apply(*leaves, chunk, torch.float32)
    loss = 0
    if "y" in uses:
        loss = loss + (y.transpose(1, 2) * torch.from_numpy(dy).transpose(1, 2)).sum()
    if "h" in uses:
        loss = loss + (h * torch.from_numpy(dh)).sum()
    loss.backward()
    assert [k for k, _ in log] == ["fwd", "bwd"] and _same(log[0][1], log[1][1])
    want = _plain(args, h0, dy if "y" in uses else np.zeros_like(dy),
                  dh if "h" in uses else None, chunk, torch.float32)
    for t, w in zip(leaves, want):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
        assert torch.equal(t.grad, w)


def test_function_saves_scratch_and_recomputes_it_under_checkpoint(monkeypatch):
    """SsdScanFn saves the forward's scratch with save_for_backward; under
    a non-reentrant torch.utils.checkpoint it is dropped with the layer and
    written again by the recompute, whose scratch the backward then reads,
    and the gradients equal ssd_backward_plain's exactly."""
    log = []
    _fake_launches(monkeypatch, log)
    b, T, H, P, N, chunk = SHAPES["chunks"]
    args, _, dy, _ = _inputs(12, b, T, H, P, N, False, False)
    saved = []
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        ssd.SsdScanFn.apply(*leaves, None, chunk, torch.float32)
    assert all(any(t.data_ptr() == s.data_ptr() for t in saved)
               for s in log[0][1]), "scratch not saved"

    ck = [torch.from_numpy(a).requires_grad_() for a in args]
    y, _ = torch.utils.checkpoint.checkpoint(
        ssd.SsdScanFn.apply, *ck, None, chunk, torch.float32, use_reentrant=False)
    (y * torch.from_numpy(dy)).sum().backward()
    assert [k for k, _ in log] == ["fwd", "fwd", "fwd", "bwd"]
    assert _same(log[3][1], log[2][1]) and not _same(log[2][1], log[1][1]), \
        "the backward did not read the recompute's scratch"
    want = _plain(args, None, dy, None, chunk, torch.float32)
    for t, w in zip(ck, want):
        assert torch.equal(t.grad, w)


def test_ssd_chunked_carries_the_gradient_to_the_block_parameters(monkeypatch):
    """ssm_apply on the CPU: A = -exp(A_log), dt and the bf16 x reach the
    scan as leaves of the graph, so A_log, dt_bias and the projections get
    gradients; with the scan routed through SsdScanFn (the card's path,
    its launches the plain versions) they equal those of ssd_plain under
    autograd, within 1e-5 of each max |g| (f32)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    cfg = ARCHS["mamba2-130m"].smoke().replace(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    block = {k: v[0].clone().requires_grad_() for k, v in params["blocks"].items()}
    u = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))

    def grads():
        out = tssm.ssm_apply(block, u, cfg)
        return torch.autograd.grad(out.square().sum(), list(block.values()),
                                   allow_unused=True)

    want = grads()
    log = []
    _fake_launches(monkeypatch, log)
    monkeypatch.setattr(tssm, "ssd_scan", lambda x, dt, A, B, C, *, chunk, h0,
                        compute_dtype: ssd.SsdScanFn.apply(
                            x, dt, A, B, C, h0, min(chunk, x.shape[1]),
                            compute_dtype))
    got = grads()
    assert [k for k, _ in log] == ["fwd", "bwd"]
    for name, g, w in zip(block, got, want):
        assert g is not None and w is not None, name
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= 1e-5 * scale, name
