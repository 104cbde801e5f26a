"""The Mamba2 mixer's gated-norm epilogue (``kernels/gated_norm.py``) on
the CPU: the plain version is the ``zamba2`` family's eager expression bit
for bit, the plain backward's formulas match autograd of the plain forward,
a CPU call runs the plain version under autograd, and the autograd
Function's plumbing (counts, saved tensors, remat) with the kernels'
launches replaced by plain versions.  The kernels themselves run on the
card only (``tests/test_torch_gpu.py``).  This family has no counterpart
in the JAX package, so nothing here imports it."""
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs.zamba2_7b import CONFIG
from repro_torch.kernels import gated_norm as gn
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import init_params
from repro_torch.models import zamba2 as Z
from repro_torch.tree import tree_leaves


def _inputs(dtype, G, seed=0, b=2, T=16, H=4, P=16, pad=24, x_dtype=None):
    """y (b,T,H,P); x a strided slice of a (b,T,H·P + pad) xBC, as the mixer
    takes it; z, D, gnorm and an output gradient."""
    g = torch.Generator().manual_seed(seed)
    xd = x_dtype or dtype
    y = torch.randn(b, T, H, P, generator=g, dtype=dtype)
    xbc = torch.randn(b, T, H * P + pad, generator=g, dtype=dtype).to(xd)
    x = xbc[..., :H * P].reshape(b, T, H, P)
    z = (torch.randn(b, T, H * P, generator=g, dtype=dtype) * 2).to(xd)
    D = torch.randn(H, generator=g, dtype=dtype)
    gnorm = torch.randn(H * P, generator=g, dtype=dtype)
    do = torch.randn(b, T, H * P, generator=g, dtype=dtype).to(xd)
    return y, x, z, D, gnorm, do


@pytest.mark.parametrize("G", [1, 2])
def test_plain_is_the_mixers_eager_expression(G):
    """``gated_rmsnorm_plain`` against the expression ``models.zamba2._mixer``
    wrote before the kernel, on bf16 x (a strided slice of xBC) and z, bit
    for bit."""
    y, x, z, D, gnorm, _ = _inputs(torch.float32, G, x_dtype=torch.bfloat16)
    assert not x.is_contiguous()
    b, t, hh, P = y.shape
    di, eps = hh * P, 1e-5
    want = y + x.float() * D[:, None]
    want = want.reshape(b, t, G, di // G) * F.silu(z.float()).reshape(b, t, G, di // G)
    want = want * torch.rsqrt((want * want).mean(-1, keepdim=True) + eps)
    want = (want.reshape(b, t, di) * gnorm).to(z.dtype)
    got = gn.gated_rmsnorm_plain(y, x, z, D, gnorm, G, eps)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# relative to each gradient's largest entry: float64, the same formulas
# summed in another order (5e-16 seen); float32, a few ulps of 2^-24 over
# sums of up to 64 channels and 32 tokens (3.4e-7 seen)
BWD_TOL = {torch.float64: 1e-13, torch.float32: 2e-6}


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_backward_plain_matches_autograd_of_the_plain_forward(dtype, G):
    """dy, dx, dz, dD and dgnorm of ``gated_rmsnorm_backward_plain`` against
    autograd through ``gated_rmsnorm_plain``, within BWD_TOL of each
    gradient's largest entry, on 3 draws; each comes back in its input's
    dtype."""
    for seed in range(3):
        y, x, z, D, gnorm, do = _inputs(dtype, G, seed)
        leaves = [t.clone().requires_grad_() for t in (y, x, z, D, gnorm)]
        gn.gated_rmsnorm_plain(*leaves, G, 1e-5).backward(do)
        got = gn.gated_rmsnorm_backward_plain(y, x, z, D, gnorm, G, 1e-5, do)
        for name, a, leaf in zip(("dy", "dx", "dz", "dD", "dgnorm"), got, leaves):
            assert a.dtype == dtype and a.shape == leaf.shape, name
            scale = float(leaf.grad.abs().max())
            assert float((a - leaf.grad).abs().max()) <= BWD_TOL[dtype] * scale, name


def test_cpu_call_runs_the_plain_version_under_autograd():
    """On the CPU ``gated_rmsnorm`` is the plain version: the same output
    and the same gradients bit for bit, and no launch counted."""
    y, x, z, D, gnorm, do = _inputs(torch.float32, 2, 4, x_dtype=torch.bfloat16)
    gn.reset_launch_count()
    runs = []
    for fn in (gn.gated_rmsnorm, gn.gated_rmsnorm_plain):
        leaves = [t.clone().requires_grad_() for t in (y, x, z, D, gnorm)]
        out = fn(*leaves, 2, 1e-5)
        out.backward(do)
        runs.append([out] + [t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert (gn.launch_count(), gn.bwd_launch_count()) == (0, 0)


def test_inputs_neither_version_takes_are_refused():
    y, x, z, D, gnorm, _ = _inputs(torch.float32, 2)
    with pytest.raises(ValueError, match="groups"):
        gn.gated_rmsnorm(y, x, z, D, gnorm, 3, 1e-5)
    with pytest.raises(ValueError, match="z"):
        gn.gated_rmsnorm(y, x, z[..., :-1], D, gnorm, 2, 1e-5)
    with pytest.raises(ValueError, match="no gated-norm kernel"):
        gn.gated_rmsnorm_forward(y, x, z, D, gnorm, 2, 1e-5)


def _plain_launches(monkeypatch):
    """The kernels' launches replaced by the plain versions, counted as the
    kernels count."""
    def forward(y, x, z, D, gnorm, groups, eps):
        gn._COUNTER.add("fwd")
        b, t, hh, P = y.shape
        v = ((y + x.to(y.dtype) * D[:, None]) * F.silu(z.to(y.dtype)).reshape(
            b, t, hh, P)).reshape(b, t, groups, -1)
        r = torch.rsqrt((v * v).mean(-1) + eps)
        return gn.gated_rmsnorm_plain(y, x, z, D, gnorm, groups, eps), r

    def backward(do, y, x, z, D, gnorm, r, groups):
        gn._COUNTER.add("bwd")
        assert r.shape == (*y.shape[:2], groups)
        return gn.gated_rmsnorm_backward_plain(y, x, z, D, gnorm, groups, 1e-5, do)

    monkeypatch.setattr(gn, "gated_rmsnorm_forward", forward)
    monkeypatch.setattr(gn, "gated_rmsnorm_backward", backward)


def test_function_saves_its_inputs_and_runs_the_backward_once(monkeypatch):
    """``GatedRMSNormFn`` with plain launches: one forward and one backward
    launch a call, the plain backward's gradients, x's landing on its
    slice of xBC and nowhere else."""
    _plain_launches(monkeypatch)
    y, x, z, D, gnorm, do = _inputs(torch.float32, 2, 5, x_dtype=torch.bfloat16)
    di = x.shape[2] * x.shape[3]
    xbc = torch.cat([x.reshape(*x.shape[:2], di), torch.ones_like(z)], -1).requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (y, z, D, gnorm)]
    xs = xbc[..., :di].reshape(x.shape)
    gn.reset_launch_count()
    out = gn.GatedRMSNormFn.apply(leaves[0], xs, leaves[1], leaves[2], leaves[3], 2, 1e-5)
    out.backward(do)
    assert (gn.launch_count(), gn.bwd_launch_count()) == (1, 1)
    want = gn.gated_rmsnorm_backward_plain(y, x, z, D, gnorm, 2, 1e-5, do)
    assert torch.equal(xbc.grad[..., :di].reshape(x.shape), want[1])
    assert not xbc.grad[..., di:].any()
    for got, w in zip([leaves[0].grad, *(t.grad for t in leaves[1:])],
                      [want[0], *want[2:]]):
        assert torch.equal(got, w)


def test_zamba2_remat_step_counts_two_forward_launches_and_one_backward(monkeypatch):
    """The smoke model with remat, every mixer's epilogue through
    ``GatedRMSNormFn`` (plain launches): 2 x n_layers forward launches (the
    forward and its recompute) and n_layers backward in one loss and
    gradient; the loss equal and every gradient within 1e-5 of its largest
    entry against the plain path (the backward's sums in another order)."""
    _plain_launches(monkeypatch)
    cfg = CONFIG.smoke().replace(dtype="float32", remat=True)
    g = torch.Generator().manual_seed(1)
    b = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
         for k in ("tokens", "labels")}
    want_loss, _, want = loss_and_grads(init_params(cfg, 2, device="cpu"), b, cfg)
    monkeypatch.setattr(Z, "gated_rmsnorm", gn.GatedRMSNormFn.apply)
    gn.reset_launch_count()
    loss, _, grads = loss_and_grads(init_params(cfg, 2, device="cpu"), b, cfg)
    assert (gn.launch_count(), gn.bwd_launch_count()) == (2 * cfg.n_layers, cfg.n_layers)
    assert torch.equal(loss, want_loss)
    for got, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert float((got - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)
