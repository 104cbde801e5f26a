"""``optim.compression.ef_int8_psum`` (error-feedback int8 mean
all-reduce) on 8 CPU rank processes (gloo) against the reference's over 8
forced JAX host devices, on the same numpy-seeded gradients.

The reference's bounds (``tests/test_multidevice.py``): the mean's error
below scale/32 and the residual at most scale/64, scale being the largest
|g|.  Port and reference within 1e-6: both share the chunk scale by an
all-reduce max, round half to even, and sum the int8 codes exactly as
int32, so only the f32 arithmetic of the decode may differ.
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
from repro_torch.core import ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 8
TOL = 1e-6
SHAPES = {"row": (256,), "chunks": (3, 1000), "matrix": (40, 64)}

REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.optim import ef_int8_psum
mesh = make_mesh((8,), ("dp",))
data = np.load(sys.argv[2])
out = {}
for name in data.files:
    if not name.endswith("|g"):
        continue
    key = name[:-2]
    g, r = jnp.asarray(data[name]), jnp.asarray(data[key + "|r"])
    def body(g_loc, r):
        o, r2 = ef_int8_psum({"g": g_loc[0]}, {"g": r}, "dp")
        return o["g"], r2["g"]
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P()),
                          out_specs=(P(), P()), check_vma=False))
    approx, resid = f(g, r)
    out[key + "|approx"] = np.asarray(approx)
    out[key + "|resid"] = np.asarray(resid)
np.savez(sys.argv[1], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, shape in SHAPES.items():
        out[name + "|g"] = rng.standard_normal((W,) + shape).astype(np.float32)
        out[name + "|r"] = np.zeros(shape, np.float32)
    # a residual carried in: what quantisation dropped on an earlier step
    out["carried|g"] = rng.standard_normal((W, 256)).astype(np.float32)
    out["carried|r"] = (rng.standard_normal(256) * 0.01).astype(np.float32)
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
         str(tmp / "in.npz")], capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(W, device="cpu", transport="gloo")
    procs = list(p._procs)
    yield p
    p.close()
    assert not any(q.is_alive() for q in procs)


@pytest.mark.parametrize("name", list(SHAPES) + ["carried"])
def test_ef_int8_psum_equals_the_reference(pool, data, ref, name):
    g, r = data[name + "|g"], data[name + "|r"]
    out = pool.run(J.ef_int8, torch.from_numpy(g), torch.from_numpy(r))
    approx = out[0][0].numpy()
    for a, res in out[1:]:                   # every rank holds the mean
        assert np.array_equal(a.numpy(), approx)
    np.testing.assert_allclose(approx, ref[name + "|approx"], atol=TOL, rtol=0)
    # each rank's residual: what its own codes dropped (rank 0's is the
    # reference's replicated output)
    np.testing.assert_allclose(out[0][1].numpy(), ref[name + "|resid"],
                               atol=TOL, rtol=0)
    exact = (g + r).mean(axis=0)
    scale = np.abs(g + r).max()
    assert np.abs(approx - exact).max() < scale / 32
    for _, res in out:
        assert np.abs(res.numpy()).max() <= scale / 64
