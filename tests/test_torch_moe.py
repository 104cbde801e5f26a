"""The port's MoE layer against the JAX package's, on the CPU.

``moe_apply`` of both packages on the same weights (drawn by the
reference's ``moe_init``, carried across with ``convert``) and the same
tokens (numpy seeds), on the smoke mixtral (8 experts, top-2) and kimi-k2
(the shared expert); then the port's grouped dispatch against its dense
oracle, skewed routers included.  Tolerances are stated beside each check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import moe, moe_apply, moe_init, router_aux_loss

CPU = "cpu"
ARCHS_MOE = ["mixtral-8x7b", "kimi-k2-1t-a32b"]


def _scaled_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor) else want,
                      dtype=np.float32)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _pair(arch, dtype="float32", seed=0):
    jcfg = JARCHS[arch].smoke().replace(dtype=dtype)
    cfg = ARCHS[arch].smoke().replace(dtype=dtype)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: convert.tensor_from_numpy(np.asarray(a), device=CPU), jp)
    return jcfg, cfg, jp, tp


def _x(cfg, B=2, S=24, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("backend", ["local_gather", "dense"])
@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_moe_apply_matches_jax(arch, backend):
    """Out and aux against JAX ``moe_apply(axis_name=None)`` in f32: 1e-5
    of the output's scale (f32 sums of d and d_ff terms in another order)."""
    jcfg, cfg, jp, tp = _pair(arch)
    x = _x(cfg)
    jout, jaux = jmoe.moe_apply(jnp.asarray(x), jp, jcfg, axis_name=None)
    out, aux = moe_apply(torch.from_numpy(x), tp, cfg, backend=backend)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert _scaled_err(out, jout) <= 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-5 * max(1.0, abs(float(jaux)))


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_moe_init_has_the_reference_tree(arch):
    jcfg, cfg = JARCHS[arch].smoke(), ARCHS[arch].smoke()
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jax.eval_shape(lambda: jmoe.moe_init(jax.random.PRNGKey(0), jcfg)))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                       moe_init(torch.Generator().manual_seed(0), cfg))
    assert got == want


def test_route_and_aux_loss_match_jax():
    """Gates, ids and probs of the f32 router, and the Switch loss: 1e-6
    (a d-term f32 dot product and two softmaxes)."""
    jcfg, cfg, jp, tp = _pair("mixtral-8x7b")
    x = _x(cfg).reshape(-1, cfg.d_model)
    jg, jids, jprobs = jmoe._route(jnp.asarray(x), jp["router"], cfg.top_k)
    g, ids, probs = moe._route(torch.from_numpy(x), tp["router"], cfg.top_k)
    assert ids.tolist() == np.asarray(jids).tolist()
    assert _scaled_err(g, jg) <= 1e-6 and _scaled_err(probs, jprobs) <= 1e-6
    want = jmoe.router_aux_loss(jprobs, jids, cfg.n_experts)
    assert abs(float(router_aux_loss(probs, ids, cfg.n_experts)) - float(want)) <= 1e-6


@pytest.mark.parametrize("n_experts,model_axis", [(8, 4), (8, 3), (384, 16), (6, 4)])
def test_expert_shard_kind_matches_jax(n_experts, model_axis):
    assert moe.expert_shard_kind(n_experts, model_axis) == \
        jmoe.expert_shard_kind(n_experts, model_axis)


ROUTERS = ["seeded", "all-to-one", "top1-all-to-one"]


def _routed(tp, cfg, router, x):
    """(params, cfg, x) for a router case.  ``all-to-one``: every token's
    first choice is expert 3 (feature 0 of every token is 5, and the
    router's weight from it to expert 3 is 20), the other experts share the
    second slot; ``top1-all-to-one`` routes top-1 too, so expert 3 takes
    every row and the rest none."""
    if router == "seeded":
        return tp, cfg, x
    x = x.copy()
    x[..., 0] = 5.0
    r = tp["router"].clone()
    r[0, 3] = 20.0
    if router.startswith("top1"):
        cfg = cfg.replace(top_k=1)
    return dict(tp, router=r), cfg, x


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("arch", ARCHS_MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_dispatch_equals_dense_oracle(arch, dtype, router):
    """The grouped dispatch against the dense oracle on the same routing:
    1e-5 of the scale in f32 (f32 sums in another order); in bf16 one bf16
    ulp of the scale, 1e-2 (each expert product rounds to bf16 in both
    forms; its d_ff-term sums can round to neighbouring values)."""
    _, cfg, _, tp = _pair(arch, dtype=dtype, seed=1)
    tp, cfg, x = _routed(tp, cfg, router, _x(cfg, seed=3))
    xt = torch.from_numpy(x).to(cfg.param_dtype)
    tokens = xt.reshape(-1, cfg.d_model)
    gates, ids, _ = moe._route(tokens, tp["router"], cfg.top_k)
    if router != "seeded":
        assert (ids[:, 0] == 3).all()
    grouped = moe._moe_grouped(tokens, tp, gates, ids, cfg)
    dense = moe._moe_dense(tokens, tp, gates, ids, cfg)
    assert grouped.dtype == dense.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _scaled_err(grouped, dense) <= tol
    out_g, _ = moe_apply(xt, tp, cfg)
    out_d, _ = moe_apply(xt, tp, cfg, backend="dense")
    assert out_g.dtype == xt.dtype
    assert _scaled_err(out_g, out_d) <= tol


def test_mesh_backends_wait_for_multi_gpu():
    _, cfg, _, tp = _pair("mixtral-8x7b")
    x = torch.from_numpy(_x(cfg))
    for kw in ({"axis_name": "model"}, {"backend": "a2a"}, {"backend": "ring"}):
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 11"):
            moe_apply(x, tp, cfg, **kw)
    with pytest.raises(ValueError, match="unknown moe backend"):
        moe_apply(x, tp, cfg, backend="nope")
