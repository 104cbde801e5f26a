"""Sharded serving: ``prefill`` and ``decode_step`` on 4 CPU rank processes
(gloo) as a (data 2, model 2) mesh, one smoke config of each family —
dense Phi-3, moe Mixtral, ssm Mamba2, hybrid Zamba2, vlm Llama-3.2-Vision,
audio MusicGen — in float32: a prefill of 4 × 16 then 4 decode steps.

* Against the port's one-device calls on the same parameters and inputs:
  every call's logits, gathered over the data group, within 1e-5 of
  max(1, max |logit|); the final cache, gathered (``rules.gather_cache``),
  within 1e-5 of max(1, max |entry|).
* Against the reference's jitted one-device ``prefill``/``decode_step``
  (parameters drawn by its ``init_params`` and carried across), at
  ``tests/test_torch_models.py``'s 1e-4 scaled tolerance, and against the
  same calls under the reference's ``mesh_context(make_test_mesh(2, 2))``
  over 4 forced host devices, at the same tolerance.  One subprocess
  computes every reference value.

The MoE config runs with ``capacity_factor = n_experts / top_k``: the mesh
path's capacity then drops no token, so it computes what the one-device
dropless dispatch does (both packages' mesh paths drop past capacity).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _torch_rank_jobs as J
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import ARCHS as JARCHS
from repro.models import init_params as jinit
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.core import ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, MESH = 4, (2, 2)
B, S, STEPS = 4, 16, 4
TOL = 1e-5              # sharded against one device, both the port's
REF_TOL = 1e-4          # the port against the reference (test_torch_models)
FAMILIES = {"dense": "phi3-mini-3.8b", "moe": "mixtral-8x7b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
            "vlm": "llama-3.2-vision-90b", "audio": "musicgen-medium"}

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS
from repro.launch.mesh import make_test_mesh
from repro.models import decode_step, init_params, prefill
from repro.parallel.context import mesh_context
data = np.load(sys.argv[2])
archs, steps = json.loads(sys.argv[3]), int(sys.argv[4])
out = {}

def pad(cfg, cache):
    if cfg.sliding_window is not None:
        return cache
    return {k: jnp.pad(v, [(0, 0)] * (v.ndim - 3) + [(0, steps), (0, 0), (0, 0)])
            if k in ("k", "v") else v for k, v in cache.items()}

def serve(cfg, p, batch, name):
    logits, cache = jax.jit(lambda p, b: prefill(p, b, cfg))(p, batch)
    outs = [logits]
    cache = pad(cfg, cache)
    dec = jax.jit(lambda p, b, c, n: decode_step(p, b, c, n, cfg))
    S = next(iter(batch.values())).shape[1]
    for t in range(steps):
        step = {k: jnp.asarray(data[f"{name}step{t}{k}"]) for k in batch}
        logits, cache = dec(p, step, cache, jnp.int32(S + t))
        outs.append(logits)
    return outs, cache

for name in archs:
    cfg = ARCHS[name].smoke().replace(dtype="float32")
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    p = init_params(cfg, jax.random.PRNGKey(0))
    keys = [k[len(name + "batch"):] for k in data.files
            if k.startswith(name + "batch")]
    batch = {k: jnp.asarray(data[name + "batch" + k]) for k in keys}
    for where in ("one", "mesh"):
        if where == "mesh":
            with mesh_context(make_test_mesh(2, 2)):
                outs, cache = serve(cfg, p, batch, name)
        else:
            outs, cache = serve(cfg, p, batch, name)
        for t, o in enumerate(outs):
            out[f"{name}{where}logits{t}"] = np.asarray(o)
        for k, v in cache.items():
            out[f"{name}{where}cache{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


def _cfg(arch):
    cfg = ARCHS[arch].smoke().replace(dtype="float32")
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def _inputs(cfg, rng, s):
    b = {}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_patches, cfg.vision_dim)).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def data():
    out = {}
    for i, arch in enumerate(FAMILIES.values()):
        cfg, rng = _cfg(arch), np.random.default_rng(i)
        out[arch] = (_inputs(cfg, rng, S),
                     [_inputs(cfg, rng, 1) for _ in range(STEPS)])
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory, data):
    tmp = tmp_path_factory.mktemp("ref")
    flat = {}
    for arch, (batch, steps) in data.items():
        flat.update({arch + "batch" + k: v for k, v in batch.items()})
        for t, st in enumerate(steps):
            flat.update({f"{arch}step{t}{k}": v for k, v in st.items()})
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp / "out.npz"),
         str(tmp / "in.npz"), json.dumps(list(data)), str(STEPS)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(W, device="cpu", transport="gloo")
    procs = list(p._procs)
    yield p
    p.close()
    assert not any(q.is_alive() for q in procs)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs(pool, data):
    """Per arch: (one-device logits and cache, sharded logits and cache),
    both on the reference's parameters."""
    out = {}
    for arch, (batch, steps) in data.items():
        cfg = _cfg(arch)
        jp = jinit(JARCHS[arch].smoke().replace(
            dtype="float32", capacity_factor=cfg.capacity_factor),
            jax.random.PRNGKey(0))
        params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                           device="cpu")
        tb, ts = _torch(batch), [_torch(s) for s in steps]
        one = J.serve_steps(cfg, params, tb, ts)
        sharded = pool.run(J.sharded_serve, cfg, params, tb, ts, MESH)[0]
        out[arch] = (one, sharded)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_serving_equals_one_device(runs, family):
    arch = FAMILIES[family]
    (one_logits, one_cache), (logits, cache) = runs[arch]
    assert len(logits) == STEPS + 1
    for t, (g, w) in enumerate(zip(logits, one_logits)):
        _close(g, w, TOL, f"{arch} logits of call {t}")
    assert sorted(cache) == sorted(one_cache)
    for k in cache:
        _close(cache[k], one_cache[k], TOL, f"{arch} cache {k}")


@pytest.mark.parametrize("where", ["one", "mesh"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_serving_equals_the_reference(runs, ref, family, where):
    """The reference's one-device calls, and the same calls under its 2×2
    mesh context (GSPMD partitions them), against the port's sharded run."""
    arch = FAMILIES[family]
    _, (logits, cache) = runs[arch]
    for t, g in enumerate(logits):
        _close(g, ref[f"{arch}{where}logits{t}"], REF_TOL,
               f"{arch} logits of call {t} ({where})")
    for k in cache:
        _close(cache[k], ref[f"{arch}{where}cache{k}"], REF_TOL,
               f"{arch} cache {k} ({where})")
