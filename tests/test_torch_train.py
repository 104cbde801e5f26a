"""Training in the PyTorch port against the JAX package, on the CPU.

``loss_fn`` and its gradients are held against
``jax.value_and_grad(repro.models.model.loss_fn)`` for one config of each
family at its ``smoke()`` size in f32, from the same parameters (carried
across with ``convert.params_from_numpy``) and the same ``SyntheticLM``
batches (numpy, a pure function of (seed, step) in both packages);
``make_train_step`` is held against the reference's jitted step over three
steps from the same parameters and moments (``opt_state_from_numpy``).
Tolerances: the loss within 1e-5; each gradient leaf within 1e-4 of its
largest |g| (sums in another order, through up to 12 layers); after three
steps the losses, grad norms and parameters within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import init_params as jinit
from repro.models.model import loss_fn as jloss_fn
from repro.optim import adamw_init as jadamw_init
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
# One config of each family; the dense one with a chunked loss and remat,
# the hybrid and vlm ones with remat over their groups.
FAMILIES = [
    ("phi3-mini-3.8b", dict(loss_chunk=8, remat=True)),
    ("mixtral-8x7b", {}),
    ("mamba2-130m", {}),
    ("zamba2-2.7b", dict(remat=True)),
    ("llama-3.2-vision-90b", dict(remat=True)),
    ("musicgen-medium", {}),
]
B, S = 2, 16


def _pair(arch, **over):
    jcfg = JARCHS[arch].smoke().replace(dtype="float32", **over)
    cfg = ARCHS[arch].smoke().replace(dtype="float32", **over)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return jcfg, cfg, jp, tp


def _batches(jcfg, cfg, step):
    """The step's batch from both packages' SyntheticLM, which must agree
    bit for bit, as (jax dict, torch dict)."""
    a, b = JSyntheticLM(jcfg, B, S, seed=5)(step), SyntheticLM(cfg, B, S, seed=5)(step)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    return ({k: jnp.asarray(v) for k, v in a.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("arch,over", FAMILIES)
def test_loss_and_grads_match_jax(arch, over):
    jcfg, cfg, jp, tp = _pair(arch, **over)
    jb, tb = _batches(jcfg, cfg, 0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True),
                           static_argnums=2)(jp, jb, jcfg)
    leaves = tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss, metrics = M.loss_fn(leaves, tb, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert abs(float(metrics["ce"]) - float(jm["ce"])) <= 1e-5
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= 1e-5
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jg)))
    names = [n for n, _ in tree_leaves_with_path(tp)]
    for name, g in zip(names, grads):
        w = want[name]
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * scale, f"{arch} {name}: {err} > 1e-4 * {scale}"
    if cfg.family == "moe":
        assert float(metrics["aux"]) > 0
    if cfg.family == "audio":     # frames in: the token embedding is unused
        assert grads[names.index("['embed']")] is None
        assert not want["['embed']"].any()


@pytest.mark.parametrize("arch,over", [FAMILIES[0], FAMILIES[2]])
def test_three_train_steps_match_jax(arch, over):
    """Three steps of make_train_step from the same parameters and
    moments: the moments come from one reference step first, so they are
    not zeros, and carry across with opt_state_from_numpy."""
    jcfg, cfg, jp, _ = _pair(arch, **over)
    kw = dict(peak_lr=1e-3, warmup=1, total_steps=10)
    jstep = jax.jit(jmake_train_step(jcfg, **kw))
    jo = jadamw_init(jp)
    jp, jo, _ = jstep(jp, jo, _batches(jcfg, cfg, 0)[0])
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    to = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo), cfg, device=CPU)
    assert int(to.step) == 1
    step = make_train_step(cfg, **kw)
    for i in range(1, 4):
        jb, tb = _batches(jcfg, cfg, i)
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = step(tp, to, tb)
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-5, (i, key)
    assert int(to.step) == int(jo.step) == 4
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jp)))
    for name, p in tree_leaves_with_path(tp):
        np.testing.assert_allclose(p.numpy(), want[name], atol=1e-5, rtol=0,
                                   err_msg=name)
    for field in ("mu", "nu"):
        want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, getattr(jo, field))))
        for name, m in tree_leaves_with_path(getattr(to, field)):
            np.testing.assert_allclose(m.numpy(), want[name], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{field} {name}")


def test_train_step_keeps_the_callers_tensors_and_flags():
    """The step updates the caller's tensors in place (the reference
    donates them) and leaves their requires_grad flags as they were."""
    _, cfg, _, tp = _pair("phi3-mini-3.8b")
    from repro_torch.optim import adamw_init
    opt = adamw_init(tp)
    wq = tp["blocks"]["wq"]
    before = wq.clone()
    _, _, m = make_train_step(cfg, peak_lr=1e-3, warmup=1)(
        tp, opt, _batches(JARCHS["phi3-mini-3.8b"].smoke(), cfg, 0)[1])
    assert tp["blocks"]["wq"] is wq and not wq.requires_grad
    assert int(opt.step) == 1 and float(m["grad_norm"]) > 0
    # the first step's lr is 0 (warm-up from step 0): only the moments move
    assert torch.equal(wq, before) and float(opt.mu["blocks"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "zamba2-2.7b"])
def test_unbind_layers_give_the_indexed_layers_gradients(arch, monkeypatch):
    """Taking the layers by one unbind(0) per stacked leaf is numerically
    neutral: the gradients equal those of indexing layer by layer."""
    jcfg, cfg, _, tp = _pair(arch, remat=True)
    _, tb = _batches(jcfg, cfg, 0)

    def grads():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), tp)
        loss, _ = M.loss_fn(leaves, tb, cfg)
        return torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)

    by_unbind = grads()
    monkeypatch.setattr(M, "_layers", lambda tree: [
        tree_map(lambda t: t[i], tree)
        for i in range(tree_leaves(tree)[0].shape[0])])
    by_index = grads()
    for a, b in zip(by_unbind, by_index):
        assert (a is None and b is None) or torch.equal(a, b)


def test_remat_and_loss_chunks_change_nothing():
    """cfg.remat and cfg.loss_chunk recompute in the backward; the loss and
    the gradients are those of the plain graph, within 1e-6 (the chunked
    mean sums the tokens in another order)."""
    jcfg, cfg, _, tp = _pair("phi3-mini-3.8b")
    _, tb = _batches(jcfg, cfg, 0)
    out = []
    for over in ({}, {"remat": True, "loss_chunk": 4}):
        c = cfg.replace(**over)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), tp)
        loss, _ = M.loss_fn(leaves, tb, c)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(leaves))))
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l0, l1, atol=1e-6, rtol=0)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
