"""The port's device channels, device farm exchanges and ``pipeline_apply``
over 8 CPU rank processes (gloo, ``repro_torch.core.ranks``) against the
reference's over 8 forced JAX host devices: the ring, chain, reverse,
``RingChannel`` and double-buffered permutations; ``dispatch``/``combine``
on the ``"a2a"`` and ``"ring"`` exchanges (``tests/test_multidevice.py``'s
case, plus a bf16 wire); ``farm_map`` and ``farm_until`` over round-robin
destinations; ``pipeline_apply``'s output and its gradient.  Every
comparison is exact: the values are small integers in float32 and the
arithmetic moves or adds them.

One reference subprocess computes every reference output at once (the
device count locks at JAX's first use), and one pool of 8 ranks serves the
module."""
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
from repro_torch.core import dfarm, dpipeline, ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 8
CAP = 16
M, MB, D = 5, 2, 3

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core import dchannel, dfarm
from repro.core.dpipeline import pipeline_apply
mesh = make_mesh((8,), ("w",))
out = {}

def run(body, *arrays, specs=None):
    specs = specs or tuple(P("w") for _ in arrays)
    return jax.jit(shard_map(body, mesh=mesh, in_specs=specs,
                             out_specs=P("w"), check_vma=False))(*arrays)

blocks = jnp.repeat(jnp.arange(8, dtype=jnp.float32), 6).reshape(8, 2, 3)
def chans(x):
    x = x[0]
    chan = dchannel.RingChannel("w", capacity=2)
    slots, o, arrived = chan.init(x), x, []
    for _ in range(4):
        got, slots = chan.step(slots, o)
        arrived.append(got)
        o = o + 100
    tot = dchannel.double_buffered_ring(
        lambda hop, carry, block: (carry + block * (hop + 1), None),
        x, jnp.zeros_like(x), "w")
    return {"ring": dchannel.ring_send(x, "w")[None],
            "ring3": dchannel.ring_send(x, "w", 3)[None],
            "chain": dchannel.chain_send(x, "w")[None],
            "reverse": dchannel.reverse_chain_send(x, "w")[None],
            "channel": jnp.stack(arrived)[None],
            "double_buffered": tot[None]}
for k, v in run(chans, blocks).items():
    out[k] = np.asarray(v).tolist()

items = jnp.arange(64 * 4, dtype=jnp.float32).reshape(64, 4)
dest = (jnp.arange(64) * 7 % 8).astype(jnp.int32)
for backend in ("a2a", "ring"):
    for wire in (None, "bfloat16"):
        wd = None if wire is None else getattr(jnp, wire)
        def body(it, de):
            recv, info = dfarm.dispatch(it, de, "w", 16, backend=backend,
                                        wire_dtype=wd)
            back = dfarm.combine(recv * 2.0, info, "w", backend=backend,
                                 wire_dtype=wd)
            return recv, back
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("w"), P("w")),
                               out_specs=(P("w"), P("w"))))
        recv, back = fn(items, dest)
        out[f"recv_{backend}_{wire}"] = np.asarray(recv).tolist()
        out[f"back_{backend}_{wire}"] = np.asarray(back).tolist()

xs = (jnp.arange(80, dtype=jnp.int32) % 70).reshape(80, 1)
for backend in ("a2a", "ring"):
    def body(x):
        de = dfarm.roundrobin_dest(x.shape[0], "w")
        f = lambda v: v * 3 + 1
        mapped = dfarm.farm_map(f, x, de, "w", 3, backend=backend)
        looped = dfarm.farm_until(lambda v: v * 2 + 1, lambda v: v < 64, x,
                                  de, "w", 3, max_trips=32, backend=backend)
        return de[:, None], mapped, looped
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("w"),),
                           out_specs=(P("w"), P("w"), P("w")), check_vma=False))
    de, mapped, looped = fn(xs)
    out[f"dest_{backend}"] = np.asarray(de)[:, 0].tolist()
    out[f"map_{backend}"] = np.asarray(mapped).tolist()
    out[f"until_{backend}"] = np.asarray(looped).tolist()

params = jnp.arange(8, dtype=jnp.float32).reshape(8, 1, 1)
mbs = jnp.ones((5, 2, 3))
def pipe(pl, x):
    return pipeline_apply(lambda p, v: v + p[0], pl, x, axis_name="w")
f = shard_map(pipe, mesh=mesh, in_specs=(P("w"), P()), out_specs=P())
out["pipe"] = np.asarray(jax.jit(f)(params, mbs)).tolist()
out["pipe_grad"] = np.asarray(jax.jit(jax.grad(
    lambda p: jnp.sum(f(p, mbs))))(params)).ravel().tolist()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                           str(path)], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {k: np.asarray(v) for k, v in json.loads(path.read_text()).items()}


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(W, device="cpu", transport="gloo")
    procs = list(p._procs)
    yield p
    p.close()
    assert not any(q.is_alive() for q in procs)


@pytest.fixture(scope="module")
def chans(pool):
    return pool.run(J.channels)


@pytest.mark.parametrize("key", ["ring", "ring3", "chain", "reverse",
                                 "channel", "double_buffered"])
def test_channels_equal_the_reference(chans, ref, key):
    got = np.stack([c[key] for c in chans])
    np.testing.assert_array_equal(got, ref[key])


def test_channel_permutations(chans):
    """What each rank receives, by rule (rank r's block is filled with r):
    the ring from r-1 (or r-3), the chain from r-1 with zeros at rank 0
    (a tree of tensors, int32 leaves kept), the reverse chain from r+1
    with zeros at the last rank, the channel its initial block twice then
    its neighbour's sends, and the double-buffered ring every rank's
    block, hop h weighted h+1."""
    for r, c in enumerate(chans):
        assert (c["ring"] == (r - 1) % W).all()
        assert (c["ring3"] == (r - 3) % W).all()
        assert (c["chain"] == (r - 1 if r else 0)).all()
        assert (c["chain_b"] == (r - 1 + 10 if r else 0)).all()
        assert c["chain_int"].dtype == np.int32
        assert (c["chain_int"] == (r - 1 if r else 0)).all()
        assert (c["reverse"] == (r + 1 if r < W - 1 else 0)).all()
        firsts = c["channel"][:, 0, 0].tolist()
        assert firsts == [r, r, (r - 1) % W, (r - 1) % W + 100]
        want = sum(((r - h) % W) * (h + 1) for h in range(W))
        assert (c["double_buffered"] == want).all()


@pytest.mark.parametrize("backend", ["a2a", "ring"])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_dispatch_combine_equal_the_reference(pool, ref, backend, wire):
    """``tests/test_multidevice.py``'s dispatch/combine round trip: the
    received buffers and the combined items, exactly."""
    items = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    dest = (np.arange(64) * 7 % 8).astype(np.int32)
    out = pool.run(J.exchange, backend, wire, CAP,
                   per_rank=[(items[8 * r:8 * r + 8], dest[8 * r:8 * r + 8])
                             for r in range(W)])
    recv = np.concatenate([o[0] for o in out])
    back = np.concatenate([o[1] for o in out])
    np.testing.assert_array_equal(recv, ref[f"recv_{backend}_{wire}"])
    np.testing.assert_array_equal(back, ref[f"back_{backend}_{wire}"])
    if wire is None:
        np.testing.assert_array_equal(back, items * 2)


@pytest.mark.parametrize("backend", ["a2a", "ring"])
def test_farm_map_and_farm_until_equal_the_reference(pool, ref, backend):
    """Round-robin destinations by global index, a farm round trip and a
    wrap-around loop per rank (capacity 3 drops items past it, as the
    reference does)."""
    xs = (np.arange(80, dtype=np.int32) % 70).reshape(80, 1)
    out = pool.run(J.farms, backend, 3,
                   per_rank=[xs[10 * r:10 * r + 10] for r in range(W)])
    np.testing.assert_array_equal(np.concatenate([o[0] for o in out]),
                                  ref[f"dest_{backend}"])
    np.testing.assert_array_equal(np.concatenate([o[1] for o in out]),
                                  ref[f"map_{backend}"])
    np.testing.assert_array_equal(np.concatenate([o[2] for o in out]),
                                  ref[f"until_{backend}"])


def test_pipeline_apply_output_and_gradient_equal_the_reference(pool, ref):
    """8 stages each adding its parameter to 5 microbatches of (2, 3)
    ones: every stage holds 1 + 0 + ... + 7 after the psum, and each of
    the 8 parameters gets the gradient M·mb·d = 30."""
    out = pool.run(J.pipeline, M, MB, D, "psum")
    for o, grad in out:
        np.testing.assert_array_equal(o, ref["pipe"])
        np.testing.assert_array_equal(o, np.full((M, MB, D), 1 + sum(range(8))))
    np.testing.assert_array_equal([o[1].item() for o in out], ref["pipe_grad"])
    assert [o[1].item() for o in out] == [M * MB * D] * W


def test_pipeline_apply_local_collect_keeps_the_emit_on_the_last_stage(pool):
    out = pool.run(J.pipeline, M, MB, D, "local")
    for r, (o, _) in enumerate(out):
        want = 1 + sum(range(8)) if r == W - 1 else 0
        np.testing.assert_array_equal(o, np.full((M, MB, D), want))
    assert dpipeline.pipeline_utilisation(8, 5) == 5 / 12


def test_one_worker_is_the_identity_and_more_need_a_group():
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    dest = torch.zeros(6, dtype=torch.int32)
    recv, info = dfarm.dispatch(x, dest, 1, 6, wire_dtype=torch.bfloat16)
    assert torch.equal(dfarm.combine(recv, info, 1), x)
    with pytest.raises(ValueError, match="Group"):
        dfarm.dispatch(x, dest, 2, 6)
    with pytest.raises(ValueError, match="collect"):
        dpipeline.pipeline_apply(lambda p, v: v, None, x, group=None,
                                 collect="gather")


def test_a_failing_rank_fails_the_call_and_closes_the_pool(monkeypatch):
    """Rank 1 raises while the others wait for it in a collective: the
    call raises rank 1's error within the grace period and the pool stops
    every rank (no hang, nothing left)."""
    monkeypatch.setattr(ranks, "_GRACE_S", 1.0)
    p = ranks.RankPool(2, device="cpu", transport="gloo")
    procs = list(p._procs)
    try:
        assert p.run(J.channels)[0]["ring"].shape == (2, 3)
        with pytest.raises(ValueError, match="rank 1 gave up"):
            p.run(J.stage_failure)
        assert p.closed
        with pytest.raises(RuntimeError, match="closed"):
            p.run(J.channels)
    finally:
        p.close()
    assert not any(q.is_alive() for q in procs)
