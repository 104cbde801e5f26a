"""The port's ring attention over 4 CPU rank processes (gloo) against the
reference's ``repro.parallel.ring_attention`` over 4 forced JAX host
devices, on the same numpy-seeded q, k, v (float32, sequence-sharded):
causal, windowed (a window shorter than a shard, so whole hops and rows
of hops see no key), not causal, and grouped-query.  Both of the port's
hops are held: ``ring_attention`` on CPU tensors (the reference's hop,
``_chunk_body``) and the flash-attention hops of the card path, merged by
their statistics, through the wrapper's plain version on CPU tensors.
Tolerance 2e-5, the reference's own for ring attention in float32
(``tests/test_multidevice.py``)."""
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

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.parallel.ring_attention import ring_attention
mesh = make_mesh((4,), ("sp",))
data = np.load(sys.argv[2])
cases = json.loads(sys.argv[3])
out = {}
for name, (hkv, causal, window) in cases.items():
    q, k, v = (jnp.asarray(data[name + x]) for x in "qkv")
    f = jax.jit(shard_map(
        lambda q, k, v: ring_attention(q, k, v, axis_name="sp",
                                       causal=causal, window=window),
        mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp")))
    out[name] = np.asarray(f(q, k, v))
np.savez(sys.argv[1], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, (hkv, _, _) in CASES.items():
        out[name + "q"] = rng.standard_normal((B, S, H, D)).astype(np.float32)
        out[name + "k"] = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
        out[name + "v"] = rng.standard_normal((B, S, hkv, D)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, data):
    tmp = tmp_path_factory.mktemp("ref")
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp / "out.npz"),
         str(tmp / "in.npz"), json.dumps(CASES)],
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


@pytest.mark.parametrize("hop", ["plain", "auto", "fa"])
def test_inputs_that_require_grad_are_refused(pool, data, hop):
    """Ring attention carries no gradient yet: with q, k, v requiring one,
    both paths (the plain hop, and the flash-attention hops through the
    wrapper's plain version here) raise naming ROADMAP §1 item 11 step 6
    instead of returning a detached result."""
    q, k, v = (torch.from_numpy(data["causal" + x]) for x in "qkv")
    for msg in pool.run(J.ring_attention_grad, q, k, v, hop):
        assert msg is not None and "item 11 step 6" in msg
