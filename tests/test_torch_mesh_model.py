"""The sharded model of the PyTorch port on a 2×4 grid of 8 CPU rank
processes (gloo: data 2, model 4) against the reference's
``tests/test_multidevice.py`` over 8 forced JAX host devices, on the same
parameters and inputs (carried across as numpy).

* The MoE block (``model._ffn_part``) in the ``ep`` layout (E=8: two
  experts a model rank) through ``local_gather``, ``a2a`` and ``ring``,
  and in the ``tp`` layout (E=6: d_ff split) through ``local_gather``,
  against the reference's one-device dense oracle: 1e-4, the reference's
  own tolerance.  At ``capacity_factor`` 1.0 tokens drop; there the port
  is held against the reference's own 8-device ``local_gather`` at 1e-4.
* ``loss_fn`` of the Phi-3, Mixtral and Mamba2 smoke configs (bf16, as
  the reference's test) within rtol 3e-3 of the reference's one-device and
  8-device losses.
* The gathered gradients of the sharded ``loss_fn`` for one config of
  each family (f32; Phi-3 with a chunked loss and remat) within 1e-4 of
  each leaf's largest |g| against the port's one-device gradients of the
  same loss: the mean over the two data shards of ``loss_fn`` on each
  shard's rows (the router loss is the mean of the shards'; for the dense
  and ssm configs this is the full batch's loss).
* ``train(mesh=make_test_mesh(2, 2))`` over three steps of the Phi-3 smoke
  config, the clip binding, against one-device ``train`` (rtol 1e-3), and
  its checkpoints restored across the two layouts.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_rank_jobs as J
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import ARCHS
from repro_torch.core import ranks
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import loss_and_grads
from repro_torch.launch.train import train
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params_spec
from repro_torch.optim.adamw import _global_norm
from repro_torch.tree import tree_leaves_with_path, tree_map, tree_map_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (2, 4)
ARCHS3 = ["phi3-mini-3.8b", "mixtral-8x7b", "mamba2-130m"]
# one config of each family for the gradients
FAMILIES = ARCHS3 + ["zamba2-2.7b", "llama-3.2-vision-90b", "musicgen-medium"]
MOE_CASES = {"ep": (8, 8.0), "tp": (6, 8.0), "drop": (8, 1.0)}
MOE_TOL = 1e-4
LOSS_RTOL = 3e-3
GRAD_TOL = 1e-4
# the dense config with a chunked loss and remat: the gathers and the
# vocab-parallel sums run again in the backward's recompute
GRAD_OVER = {"phi3-mini-3.8b": dict(loss_chunk=8, remat=True)}
TRAIN_RTOL = 1e-3

REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS
from repro.models import init_params, loss_fn
from repro.models import model as M
from repro.models.config import ModelConfig
from repro.models.layers import rms_norm
from repro.models.moe import moe_apply, moe_init
from repro.parallel.context import mesh_context
from repro.launch.mesh import make_test_mesh
out = {}
mesh = make_test_mesh(2, 4)
for tag, (E, cf) in {"ep": (8, 8.0), "tp": (6, 8.0), "drop": (8, 1.0)}.items():
    cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=4, d_ff=16, vocab_size=64,
                      n_experts=E, top_k=2, capacity_factor=cf,
                      pad_heads_to=0, pad_vocab_to=0, dtype="float32")
    params = {"moe": moe_init(jax.random.PRNGKey(0), cfg),
              "norm2": jnp.ones((32,), jnp.float32)}
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32), jnp.float32)
    hn = rms_norm(x, params["norm2"], cfg.norm_eps)
    want, _ = moe_apply(hn, params["moe"], cfg, axis_name=None,
                        backend="dense")
    out[tag + "|want"] = np.asarray(x + want)
    out[tag + "|x"] = np.asarray(x)
    for k, v in params["moe"].items():
        out[tag + "|moe|" + k] = np.asarray(v)
    with mesh_context(mesh):
        got, _ = jax.jit(lambda xx, pp: M._ffn_part(pp, xx, cfg))(x, params)
    out[tag + "|got8"] = np.asarray(got)
for arch in ["phi3-mini-3.8b", "mixtral-8x7b", "mamba2-130m"]:
    cfg = ARCHS[arch].smoke().replace(capacity_factor=8.0)
    params = init_params(cfg, jax.random.PRNGKey(0))
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0,
                                          cfg.vocab_size),
             "labels": jax.random.randint(jax.random.PRNGKey(2), (4, 32), 0,
                                          cfg.vocab_size)}
    l1, _ = jax.jit(lambda p, b: loss_fn(p, b, cfg))(params, batch)
    with mesh_context(mesh):
        l8, _ = jax.jit(lambda p, b: loss_fn(p, b, cfg))(params, batch)
    out[arch + "|l1"] = np.float64(l1)
    out[arch + "|l8"] = np.float64(l8)
    for k, v in batch.items():
        out[arch + "|batch|" + k] = np.asarray(v)
    for path, v in jax.tree_util.tree_leaves_with_path(params):
        out[arch + "|p|" + jax.tree_util.keystr(path)] = np.asarray(
            v, dtype=np.float32)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=400, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(GRID[0] * GRID[1], device="cpu", transport="gloo")
    procs = list(p._procs)
    yield p
    p.close()
    ranks.shutdown()          # train(mesh=)'s pool
    assert not any(q.is_alive() for q in procs)


def _moe_cfg(tag, backend="local_gather"):
    E, cf = MOE_CASES[tag]
    return ModelConfig(name="t", family="moe", n_layers=1, d_model=32,
                       n_heads=4, n_kv_heads=4, d_ff=16, vocab_size=64,
                       n_experts=E, top_k=2, capacity_factor=cf,
                       pad_heads_to=0, pad_vocab_to=0, dtype="float32",
                       moe_backend=backend)


def _moe_block(ref, tag):
    block = {"moe": {k: torch.from_numpy(ref[f"{tag}|moe|{k}"])
                     for k in ("router", "w_gate", "w_up", "w_down")},
             "norm2": torch.ones(32)}
    return block, torch.from_numpy(ref[f"{tag}|x"])


def _ffn(pool, ref, tag, backend, grads=False):
    block, x = _moe_block(ref, tag)
    return pool.run(J.sharded_ffn, _moe_cfg(tag, backend), block, x, GRID,
                    grads)[0]


@pytest.mark.parametrize("tag,backend", [
    ("ep", "local_gather"), ("ep", "a2a"), ("ep", "ring"),
    ("tp", "local_gather")])
def test_sharded_moe_equals_the_dense_oracle(pool, ref, tag, backend):
    """The reference's ``test_moe_sharded_matches_single_device_oracle``:
    ``_ffn_part`` over the grid equals its one-device dense oracle."""
    got, _, _ = _ffn(pool, ref, tag, backend)
    np.testing.assert_allclose(got.numpy(), ref[f"{tag}|want"],
                               atol=MOE_TOL, rtol=MOE_TOL)


@pytest.mark.parametrize("backend", ["a2a", "ring"])
def test_exchanges_need_the_ep_layout(pool, ref, backend):
    """E=6 over 4 model ranks is the tp layout, where the reference asserts
    that a2a/ring dispatch needs E % model == 0: the port raises."""
    with pytest.raises(ValueError, match="ep layout"):
        _ffn(pool, ref, "tp", backend)


def test_capacity_drops_equal_the_references_mesh_run(pool, ref):
    """At capacity_factor 1.0 the per-rank capacity, on the rank's own
    tokens, drops copies: the port drops the same ones as the reference's
    8-device ``local_gather``."""
    got, _, _ = _ffn(pool, ref, "drop", "local_gather")
    assert np.abs(ref["drop|got8"] - ref["drop|want"]).max() > 100 * MOE_TOL
    np.testing.assert_allclose(got.numpy(), ref["drop|got8"],
                               atol=MOE_TOL, rtol=MOE_TOL)


@pytest.mark.parametrize("backend", ["a2a", "ring"])
def test_exchange_gradients_equal_local_gather(pool, ref, backend):
    """With nothing dropped the three dispatches compute one function, and
    the exchanges carry its gradient: the block's gradients through a2a
    and ring equal local_gather's."""
    _, _, want = _ffn(pool, ref, "ep", "local_gather", grads=True)
    _, _, got = _ffn(pool, ref, "ep", backend, grads=True)
    for (k, a), (_, b) in zip(tree_leaves_with_path(got),
                              tree_leaves_with_path(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


def _ref_params(ref, arch, cfg):
    spec = init_params_spec(cfg)
    return tree_map_with_path(
        lambda path, s: torch.from_numpy(ref[f"{arch}|p|{path}"]).to(s[1]), spec)


@pytest.mark.parametrize("arch", ARCHS3)
def test_sharded_loss_matches_the_reference(pool, ref, arch):
    """The reference's ``test_sharded_loss_matches_single_device``: the
    loss on the grid within rtol 3e-3 of the one-device and the 8-device
    reference losses, on the reference's parameters and batch (bf16)."""
    cfg = ARCHS[arch].smoke().replace(capacity_factor=8.0)
    params = _ref_params(ref, arch, cfg)
    batch = {k: torch.from_numpy(ref[f"{arch}|batch|{k}"])
             for k in ("tokens", "labels")}
    loss = pool.run(J.sharded_loss, cfg, params, batch, GRID, False)[0][0]
    np.testing.assert_allclose(loss, float(ref[f"{arch}|l1"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, float(ref[f"{arch}|l8"]), rtol=LOSS_RTOL)


def _batch(cfg, B, S, seed=0):
    return {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, B, S, seed)(0).items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_gradients_equal_one_device(pool, arch):
    """Every leaf's gathered gradient within 1e-4 of its largest |g| of the
    one-device gradient of the same loss (f32)."""
    cfg = ARCHS[arch].smoke().replace(capacity_factor=8.0, dtype="float32",
                                      **GRAD_OVER.get(arch, {}))
    params = init_params(cfg, 0, device="cpu")
    batch = _batch(cfg, 4, 32)
    loss, _, _, got = pool.run(J.sharded_loss, cfg, params, batch, GRID,
                               True)[0]
    want, losses = None, []
    for d in range(GRID[0]):          # the data shards' one-device losses
        rows = {k: v[2 * d:2 * d + 2] for k, v in batch.items()}
        l, _, g = loss_and_grads(params, rows, cfg)
        losses.append(float(l))
        want = g if want is None else tree_map(torch.add, want, g)
    np.testing.assert_allclose(loss, np.mean(losses), rtol=1e-5)
    for (k, a), (_, b) in zip(tree_leaves_with_path(got),
                              tree_leaves_with_path(want)):
        b = b / GRID[0]
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= GRAD_TOL * scale, k


def test_train_on_a_mesh_equals_one_device(pool):
    """``train(mesh=make_test_mesh(2, 2))`` over 4 rank processes: three
    steps of the Phi-3 smoke config with the clip binding (grad norm > 1 at
    step 0) give the one-device losses and parameters (rtol 1e-3)."""
    cfg = ARCHS["phi3-mini-3.8b"].smoke().replace(dtype="float32")
    kw = dict(steps=3, batch=4, seq=32, ckpt_dir=None, device="cpu",
              peak_lr=1e-2)
    params = init_params(cfg, 0, device="cpu")
    _, _, g = loss_and_grads(params, _batch(cfg, 4, 32), cfg)
    assert float(_global_norm(g)) > 1.0       # max_grad_norm: the clip binds
    one_state, one = train(cfg, **kw)
    mesh_state, got = train(cfg, mesh=make_test_mesh(2, 2), transport="gloo",
                            **kw)
    np.testing.assert_allclose(got, one, rtol=TRAIN_RTOL)
    for (k, a), (_, b) in zip(tree_leaves_with_path(mesh_state),
                              tree_leaves_with_path(one_state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TRAIN_RTOL,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("first", ["mesh", "one"])
def test_checkpoints_restore_across_layouts(pool, tmp_path, first):
    """Two steps on one layout, checkpointed, then the third on the other
    resumes from it: the same three losses as an uninterrupted run."""
    cfg = ARCHS["phi3-mini-3.8b"].smoke().replace(dtype="float32")
    kw = dict(batch=4, seq=32, device="cpu", peak_lr=1e-2)
    mesh = dict(mesh=make_test_mesh(2, 2), transport="gloo")
    _, whole = train(cfg, steps=3, ckpt_dir=None, **kw)
    a, b = (mesh, {}) if first == "mesh" else ({}, mesh)
    _, head = train(cfg, steps=2, ckpt_dir=str(tmp_path), **a, **kw)
    _, tail = train(cfg, steps=3, ckpt_dir=str(tmp_path), **b, **kw)
    np.testing.assert_allclose(head + tail, whole, rtol=TRAIN_RTOL)
