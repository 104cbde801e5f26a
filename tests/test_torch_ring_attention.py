"""The port's ring attention over 4 CPU rank processes (gloo) against the
reference's ``repro.parallel.ring_attention`` over 4 forced JAX host
devices, on the same numpy-seeded q, k, v (float32, sequence-sharded):
causal, windowed (a window shorter than a shard, so whole hops and rows
of hops see no key), not causal, and grouped-query.  Both of the port's
hops are held: ``ring_attention`` on CPU tensors (the reference's hop,
``_chunk_body``) and the flash-attention hops of the card path, merged by
their statistics, through the wrapper's plain version on CPU tensors.
Tolerance 2e-5, the reference's own for ring attention in float32
(``tests/test_multidevice.py``).

The gradient (``RingAttentionFn``): on 8 CPU ranks the port's dq, dk, dv
of sum(ring_attention(q, k, v) · dO) against ``jax.grad`` of the same
loss through the reference's ring under ``shard_map`` over 8 forced host
devices, and against ``jax.grad`` of the one-device ``attention_ref``, at
atol 5e-5 / rtol 1e-4: causal MHA, grouped-query (H 4, Hkv 2), and a
window whose hops hold rows with no visible key (the geometry of
``test_window_case_has_hops_with_no_visible_key``: shards of 16, window
12).  One subprocess computes every reference value."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_rank_jobs as J
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4
TOL = 2e-5
B, S, H, D = 2, 64, 4, 16
CASES = {  # name: (Hkv, causal, window)
    "causal": (4, True, None),
    "window": (4, True, 12),
    "full": (4, False, None),
    "gqa": (2, True, None),
    "gqa_window": (1, True, 20),
}

GW = 8                  # ranks of the gradient cases
GB, GS, GH, GD = 1, 128, 4, 16
GRAD_CASES = {  # name: (Hkv, causal, window)
    "grad_causal": (4, True, None),
    "grad_gqa": (2, True, None),
    "grad_window": (4, True, 12),
}
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.kernels.ref import attention_ref
from repro.parallel.ring_attention import ring_attention
data = np.load(sys.argv[2])
cases, grad_cases = json.loads(sys.argv[3]), json.loads(sys.argv[4])
out = {}
def ring(n, causal, window):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    return shard_map(
        lambda q, k, v: ring_attention(q, k, v, axis_name="sp",
                                       causal=causal, window=window),
        mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"))
for name, (hkv, causal, window) in cases.items():
    q, k, v = (jnp.asarray(data[name + x]) for x in "qkv")
    out[name] = np.asarray(jax.jit(ring(4, causal, window))(q, k, v))
for name, (hkv, causal, window) in grad_cases.items():
    q, k, v, do = (jnp.asarray(data[name + x]) for x in ("q", "k", "v", "do"))
    f = ring(8, causal, window)
    g = jax.jit(jax.grad(lambda q, k, v: (f(q, k, v) * do).sum(),
                         argnums=(0, 1, 2)))(q, k, v)
    t = lambda x: x.transpose(0, 2, 1, 3)
    one = lambda q, k, v: (t(attention_ref(t(q), t(k), t(v), causal=causal,
                                           window=window)) * do).sum()
    g1 = jax.jit(jax.grad(one, argnums=(0, 1, 2)))(q, k, v)
    for x, a, b in zip("qkv", g, g1):
        out[name + "d" + x] = np.asarray(a)
        out[name + "one_d" + x] = np.asarray(b)
np.savez(sys.argv[1], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, (hkv, _, _) in CASES.items():
        out[name + "q"] = rng.standard_normal((B, S, H, D)).astype(np.float32)
        out[name + "k"] = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
        out[name + "v"] = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    for name, (hkv, _, _) in GRAD_CASES.items():
        out[name + "q"] = rng.standard_normal((GB, GS, GH, GD)).astype(np.float32)
        out[name + "k"] = rng.standard_normal((GB, GS, hkv, GD)).astype(np.float32)
        out[name + "v"] = rng.standard_normal((GB, GS, hkv, GD)).astype(np.float32)
        out[name + "do"] = rng.standard_normal((GB, GS, GH, GD)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, data):
    tmp = tmp_path_factory.mktemp("ref")
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp / "out.npz"),
         str(tmp / "in.npz"), json.dumps(CASES), json.dumps(GRAD_CASES)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(W, device="cpu", transport="gloo")
    procs = list(p._procs)
    yield p
    p.close()
    assert not any(q.is_alive() for q in procs)


@pytest.fixture(scope="module")
def pool8():
    p = ranks.RankPool(GW, device="cpu", transport="gloo")
    procs = list(p._procs)
    yield p
    p.close()
    assert not any(q.is_alive() for q in procs)


def _ring(pool, data, name, hop):
    _, causal, window = CASES[name]
    q, k, v = (torch.from_numpy(data[name + x]) for x in "qkv")
    out = pool.run(J.ring_attention, q, k, v, causal, window, hop)
    return np.concatenate([o[0] for o in out], axis=1), [o[1] for o in out]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_hop_equals_the_reference(pool, data, ref, name):
    """``ring_attention`` on CPU tensors: the reference's hop."""
    got, _ = _ring(pool, data, name, "auto")
    np.testing.assert_allclose(got, ref[name], atol=TOL, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_hops_equal_the_reference(pool, data, ref, name):
    """The card path's merge: one flash-attention call per hop with its
    statistics, rows whose every key in a hop is masked at zero weight,
    and under ``causal`` the blocks of later ranks skipped — rank r makes
    r + 1 calls, with q_offset 0, S_loc, ..., r·S_loc."""
    got, calls = _ring(pool, data, name, "fa")
    np.testing.assert_allclose(got, ref[name], atol=TOL, rtol=0)
    s_loc = S // W
    _, causal, _ = CASES[name]
    for r, offsets in enumerate(calls):
        if causal:
            assert offsets == [h * s_loc for h in range(r + 1)]
        else:
            assert sorted(offsets) == sorted(((r - src) * s_loc)
                                             for src in range(W))


def test_window_case_has_hops_with_no_visible_key(data):
    """The windowed case is the one the merge must survive: a window of
    12 over shards of 16 leaves every row of the hop two ranks back with
    no key, and the last rows of the hop one rank back too."""
    s_loc, window = S // W, CASES["window"][2]
    qpos = np.arange(s_loc) + 2 * s_loc
    kpos = np.arange(s_loc)
    assert not ((kpos[None, :] > qpos[:, None] - window)).any()
    qpos = np.arange(s_loc) + s_loc
    seen = (kpos[None, :] > qpos[:, None] - window).any(axis=1)
    assert seen[:4].all() and not seen[-1]


def _naive_grads(q, k, v, do, causal, window):
    """out and (dq, dk, dv) of sum(out · do) through autograd of the
    port's one-device ``naive_attention`` (float64)."""
    from repro_torch.models.attention import naive_attention
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    out = naive_attention(q, k, v, causal=causal, window=window)
    (out * do.double()).sum().backward()
    return out.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("hop", ["plain", "auto", "fa"])
def test_inputs_that_require_grad_are_refused(pool, data, hop):
    """With q, k, v requiring grad, ``ring_attention_plain`` (the forward's
    oracle) still raises rather than return a detached result, naming
    ``ring_attention``; ``ring_attention`` ("auto") and
    ``RingAttentionFn`` ("fa", through the wrappers' plain versions on
    CPU tensors) return the output and the gradients of sum(out), equal
    to autograd's through the plain one-device attention at 2e-5."""
    q, k, v = (torch.from_numpy(data["causal" + x]) for x in "qkv")
    got = pool.run(J.ring_attention_grad, q, k, v, hop)
    if hop == "plain":
        for msg in got:
            assert isinstance(msg, str) and "ring_attention" in msg
        return
    want_out, want = _naive_grads(q, k, v, torch.ones(q.shape), True, None)
    cat = lambda i: np.concatenate([g[i] for g in got], axis=1)  # noqa: E731
    np.testing.assert_allclose(cat(0), want_out.numpy(), atol=TOL, rtol=0)
    for i, w in enumerate(want, start=1):
        np.testing.assert_allclose(cat(i), w.numpy(), atol=TOL, rtol=0)


def _grads8(pool8, data, name, hop="auto"):
    _, causal, window = GRAD_CASES[name]
    q, k, v, do = (torch.from_numpy(data[name + x]) for x in ("q", "k", "v", "do"))
    return pool8.run(J.ring_attention_grad, q, k, v, hop, do, causal, window)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_gradients_equal_jax_grad_of_the_reference_ring(pool8, data, ref, name):
    """dq, dk, dv on 8 CPU ranks against ``jax.grad`` of the reference's
    ring under ``shard_map`` over 8 host devices, and of the one-device
    ``attention_ref``: the backward ring's merged statistics, the
    accumulators that travel with their blocks, and the hops with no
    visible key."""
    got = _grads8(pool8, data, name)
    for i, x in enumerate("qkv", start=1):
        mine = np.concatenate([g[i] for g in got], axis=1)
        for key in (name + "d" + x, name + "one_d" + x):
            np.testing.assert_allclose(mine, ref[key], atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=key)


def test_each_rank_ends_with_its_own_blocks_dk_dv(pool8, data, ref):
    """After the backward ring every rank holds the dk, dv of the block it
    owns — rows [r·S_loc, (r + 1)·S_loc) of the full gradient — and not
    its neighbour's: the accumulators' last send brought them home."""
    got = _grads8(pool8, data, "grad_causal", hop="fa")
    s_loc = GS // GW
    for x, i in (("k", 2), ("v", 3)):
        full = ref["grad_causald" + x]
        for r, g in enumerate(got):
            own = full[:, r * s_loc:(r + 1) * s_loc]
            nxt = full[:, ((r + 1) % GW) * s_loc:((r + 1) % GW + 1) * s_loc]
            np.testing.assert_allclose(g[i], own, atol=GRAD_ATOL, rtol=GRAD_RTOL)
            assert np.abs(g[i] - nxt).max() > 1e-2
