"""The port's mesh context (``repro_torch.parallel.context``): SPMD by
hand over the rank groups, checked on CPU rank processes (gloo).

* With no context, and under a 1×1 mesh (which needs no rank), ``loss_fn``
  and its gradients are the one-device path bit for bit.
* ``mesh_context`` lays the ranks out as the reference's meshes: rank
  ``d * mp + m`` is data index d, model index m, a ``pod`` axis folded
  into the data group; a larger mesh outside a rank raises.
* ``fsdp_gather`` forward (the all-gather of the ``"dp"`` dims) and
  backward (the sum over the data group, then the rank's slice), and the
  two region operators' gradients: ``enter_model`` (identity forward, sum
  backward) and ``psum_compat`` (sum forward, identity backward).
* ``shard_tree``/``gather_tree`` round trips; ``prefill``/``decode_step``
  run under a 2×2 mesh and equal the one-device calls (within 1e-5 of
  each output's max: the model group sums partial products in another
  order).
The other comparisons are exact: they move values, or sum small integers.
"""
import pytest
import torch

import _torch_rank_jobs as J
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import ARCHS
from repro_torch.core import ranks
from repro_torch.core.skeleton import LoweringError
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import DP_AXES, MODEL_AXIS, make_test_mesh
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import init_params
from repro_torch.parallel import context
from repro_torch.models.model import params_pspecs
from repro_torch.tree import tree_leaves, tree_leaves_with_path

W = 4


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(W, device="cpu", transport="gloo")
    procs = list(p._procs)
    yield p
    p.close()
    assert not any(q.is_alive() for q in procs)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mixtral-8x7b"])
def test_no_context_and_1x1_mesh_are_the_one_device_path(arch):
    cfg = ARCHS[arch].smoke().replace(capacity_factor=1.0, dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, 2, 16)(0).items()}
    l0, m0, g0 = loss_and_grads(params, batch, cfg)
    with context.mesh_context(make_test_mesh(1, 1)) as mc:
        assert context.current_ctx() is mc and context.sharded_ctx() is None
        assert (mc.dp_size, mc.mp_size) == (1, 1)
        l1, m1, g1 = loss_and_grads(params, batch, cfg)
    assert context.current_ctx() is None
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


def test_the_context_is_seen_from_other_threads():
    """The autograd engine runs a CUDA backward, and the recompute of a
    checkpointed block with it, on a thread of its own: the context is
    the process's, not a thread's."""
    import threading
    seen = []
    with context.mesh_context(make_test_mesh(1, 1)) as mc:
        t = threading.Thread(target=lambda: seen.append(context.current_ctx()))
        t.start()
        t.join()
    assert seen == [mc]


def test_a_larger_mesh_outside_a_rank_raises():
    with pytest.raises(LoweringError, match="RankPool"):
        with context.mesh_context(make_test_mesh(2, 2)):
            pass


def test_mesh_names_and_axes():
    m = make_test_mesh(2, 4)
    assert (m.axis_names, m.shape, m.size) == (("data", "model"),
                                               {"data": 2, "model": 4}, 8)
    assert make_test_mesh(2, 2, pod=2).axis_names == ("pod", "data", "model")
    assert DP_AXES() == ("data",) and DP_AXES(True) == ("pod", "data")
    assert MODEL_AXIS == "model"
    assert context.shard(m, "dp", None) is m
    fn = lambda: 0  # noqa: E731
    assert context.manual_model(fn, None, None) is fn
    with pytest.raises(LoweringError, match="model axis"):
        with context.mesh_context(make_test_mesh(1, 1), model_axis="data"):
            pass


@pytest.mark.parametrize("mesh_args", [(2, 2), (1, 2, 2), (4, 1), (1, 4)])
def test_rank_layout_of_the_groups(pool, mesh_args):
    """Rank d*mp + m is data index d and model index m; the model group is
    the grid's row, the data group its column (with the pod folded in)."""
    out = pool.run(J.context_groups, mesh_args)
    mp = mesh_args[1]
    dp = W // mp
    for r, ((dranks, di), (mranks, mi), dps, mps) in enumerate(out):
        assert (dps, mps) == (dp, mp)
        assert (di, mi) == divmod(r, mp)
        assert mranks == tuple(range(di * mp, (di + 1) * mp))
        assert dranks == tuple(range(mi, W, mp))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_fsdp_gather_forward_and_backward(pool, mesh_shape):
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    dp, mp = mesh_shape
    out = pool.run(J.fsdp_gather_job, full, mesh_shape)
    rows = 8 // dp
    for r, (got, grad) in enumerate(out):
        d, m = divmod(r, mp)
        cols = slice(m * (6 // mp), (m + 1) * (6 // mp))
        assert torch.equal(got, full[:, cols])          # the dp dim gathered
        column = [q for q in range(W) if q % mp == m]   # this data group
        want = torch.full((rows, 6 // mp), float(sum(q + 1 for q in column)))
        assert torch.equal(grad, want)


def test_region_operators_gradients(pool):
    """enter_model -> x (m + 1) -> psum_compat over a model group of 2: the
    value is x (1 + 2) on both ranks; x's gradient of the sum is the
    sum over the group of each rank's (m + 1), 3, where enter_model's
    backward sums and psum_compat's passes through."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for got, grad in pool.run(J.region_job, x, (2, 2)):
        assert torch.equal(got, x * 3)
        assert torch.equal(grad, torch.full_like(x, 3.0))


def test_bf16_regions_reduce_in_f32_over_gloo(pool):
    """A bf16 psum over gloo goes through f32 on the wire, as the
    reference's CPU ``psum_compat``: bf16 inputs whose f32 sum is exact."""
    x = torch.tensor([[1.0, 256.0, 0.5]], dtype=torch.bfloat16)
    for got, grad in pool.run(J.region_job, x, (2, 2)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, x * 3)
        assert torch.equal(grad, torch.full_like(x, 3.0))


def test_shard_and_gather_tree_round_trip(pool):
    """``shard_tree`` cuts each leaf to the slice its tokens name (each
    "dp"/"mp" dim halved on a 2×2 mesh); ``gather_tree`` restores it."""
    cfg = ARCHS["phi3-mini-3.8b"].smoke()
    params = init_params(cfg, 0, device="cpu")
    specs = dict(tree_leaves_with_path(params_pspecs(cfg, 2)))
    for shapes, back in pool.run(J.shard_round_trip, cfg, params, (2, 2)):
        for path, full in tree_leaves_with_path(params):
            toks = specs[path] or ()
            want = tuple(n // 2 if i < len(toks) and toks[i] else n
                         for i, n in enumerate(full.shape))
            assert shapes[path] == want, path
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                     tree_leaves(params)))


def test_prefill_and_decode_refuse_a_sharded_mesh(pool):
    """Sharded serving on a 2×2 mesh (it raised before the dry-run slice):
    the Phi-3 smoke config's prefill of 2 × 4 and two decode steps, the
    logits gathered over the data group and the cache gathered, against
    the one-device calls."""
    cfg = ARCHS["phi3-mini-3.8b"].smoke().replace(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tok = lambda s: {"tokens": torch.randint(0, cfg.vocab_size, (2, s),  # noqa: E731
                                             generator=gen)}
    batch, steps = tok(4), [tok(1), tok(1)]
    want, want_cache = J.serve_steps(cfg, params, batch, steps)
    got, cache = pool.run(J.sharded_serve, cfg, params, batch, steps, (2, 2))[0]
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * max(1.0, float(w.abs().max()))
    for k, w in want_cache.items():
        assert cache[k].shape == w.shape
        assert (cache[k] - w).abs().max() <= 1e-5 * max(1.0, float(w.abs().max()))


def test_large_jobs_and_replies_cross_the_pipes_in_frames(pool):
    """A job's argument and its reply of 40 MB each travel as several
    frames of ``ranks._FRAME`` bytes (a read of a whole large message at
    once is very slow on some hosts) and arrive whole."""
    x = torch.arange(10 * 2 ** 20, dtype=torch.float32)
    assert x.numel() * 4 > 2 * ranks._FRAME
    for r, got in enumerate(pool.run(J.echo_plus_rank, x)):
        assert torch.equal(got, x + r)
