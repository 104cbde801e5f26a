"""The dry run (``repro_torch.launch.dryrun``) against the reference's.

* Every (arch × shape × mesh) record — 40 cells on the 16×16 and the
  2×16×16 mesh — carries the reference's keys for its status, and the 7
  SKIP records of each mesh equal the reference's.
* ``argument_size`` of every applicable single-pod cell equals the bytes
  of the reference's ``input_specs`` leaves cut to their
  ``sharding.shard_shape`` (``jax.eval_shape`` only: a subprocess with 512
  forced host devices, no lowering), less two listed departures of decode
  cells: the reference's ``cache_len`` is a 4-byte int32 scalar where the
  port's is a host int, and the port's k/v caches hold a rank's kv heads
  where GSPMD splits the cache's positions (``models/model.py``'s
  docstring), which differs in bytes where kv heads are fewer than the 16
  model ranks (``KV_DEPARTURES``).
* ``run_cell(..., n_layers=2)`` of a train, a prefill and a decode cell of
  a dense and an MoE arch is OK, with finite FLOPs and collectives.
* ``_account`` on a 2×2 mesh over gloo equals a real step on 4 CPU rank
  processes: the bytes each rank's arguments hold, and the collective
  tally by kind (counts and bytes).
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import _torch_rank_jobs as J
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import ARCHS, SHAPES, ShapeCell, cell_applicable
from repro_torch.core import ranks
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's record keys by status (src/repro/launch/dryrun.py:95-140)
REF_KEYS = {
    "SKIP": {"arch", "shape", "unrolled", "n_layers", "variant", "mesh",
             "status", "reason"},
    "LOWERED": {"arch", "shape", "unrolled", "n_layers", "variant", "mesh",
                "status", "lower_s"},
    "OK": {"arch", "shape", "unrolled", "n_layers", "variant", "mesh",
           "status", "lower_s", "compile_s", "flops_per_device",
           "bytes_accessed_per_device", "argument_size", "output_size",
           "temp_size", "alias_size", "generated_code_size", "collectives",
           "n_devices"},
}
# decode cells whose k/v caches differ in bytes from the reference's
# (kv heads fewer than the 16 model ranks: a rank holds one kv head of the
# whole cache, GSPMD 1/16 of the positions of every kv head)
KV_DEPARTURES = {(a, s.name) for a, c in ARCHS.items() for s in SHAPES
                 if s.kind == "decode" and cell_applicable(a, s)[0]
                 and c.family != "ssm" and c.n_kv_heads != c.n_heads
                 and c.n_kv_heads < 16}

REFERENCE = """
import json, sys
from repro.launch import dryrun        # forces 512 host devices first
import jax, numpy as np
from repro.configs import ARCHS, SHAPES, cell_applicable
from repro.launch.mesh import DP_AXES, make_production_mesh
from repro.launch.steps import input_specs
from repro.parallel.context import mesh_context
out = {"skip": [], "bytes": {}}
for mp in (False, True):
    for a in sorted(ARCHS):
        for s in SHAPES:
            if not cell_applicable(a, s)[0]:
                out["skip"].append(dryrun.run_cell(a, s.name, mp))
mesh = make_production_mesh()
with mesh_context(mesh, dp_axes=DP_AXES(False)) as ctx:
    for a in sorted(ARCHS):
        for s in SHAPES:
            if not cell_applicable(a, s)[0]:
                continue
            specs = input_specs(ARCHS[a], s, ctx)
            total, kv, scalar = 0, 0, 0
            for path, leaf in jax.tree_util.tree_leaves_with_path(specs):
                local = leaf.shape if leaf.sharding is None else \\
                    leaf.sharding.shard_shape(leaf.shape)
                n = math.prod(local) * np.dtype(leaf.dtype).itemsize
                total += n
                key = jax.tree_util.keystr(path)
                if key.startswith("['cache']") and key[-5:] in ("['k']", "['v']"):
                    kv += n
                if key == "['cache_len']":
                    scalar += n
            out["bytes"][a + "/" + s.name] = [total, kv, scalar]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", "import math\n" + textwrap.dedent(REFERENCE)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def lowered():
    """Every cell of both meshes through ``run_cell(compile_=False)``."""
    return {(a, s.name, mp): dryrun.run_cell(a, s.name, mp, compile_=False)
            for mp in (False, True) for a in sorted(ARCHS) for s in SHAPES}


def test_every_record_has_the_reference_keys_and_skips_equal(lowered, ref):
    assert len(lowered) == 80
    statuses = [r["status"] for r in lowered.values()]
    assert statuses.count("SKIP") == 14 and statuses.count("LOWERED") == 66
    for rec in lowered.values():
        assert REF_KEYS[rec["status"]] <= set(rec), rec
    skips = [r for r in lowered.values() if r["status"] == "SKIP"]
    assert skips == ref["skip"]


def _kv_bytes(rec_cell):
    """The bytes of the port's k/v caches in a decode cell, from its
    specs (rank 0 of the single-pod mesh)."""
    arch, shape_name = rec_cell
    shape = next(s for s in SHAPES if s.name == shape_name)
    from repro_torch.core.ranks import simulated
    from repro_torch.launch.mesh import DP_AXES, make_production_mesh
    from repro_torch.launch.steps import input_specs
    from repro_torch.parallel.context import mesh_context
    with simulated(256), mesh_context(make_production_mesh(),
                                      dp_axes=DP_AXES(False)) as ctx:
        cache = input_specs(ARCHS[arch], shape, ctx)["cache"]
        return sum(v.numel() * v.element_size() for k, v in cache.items()
                   if k in ("k", "v"))


def test_argument_size_equals_the_reference_shard_bytes(lowered, ref):
    """Every applicable single-pod cell; the decode cells less the
    reference's 4-byte ``cache_len`` and, in ``KV_DEPARTURES``, with the
    port's k/v cache bytes in place of the reference's."""
    departed = set()
    for (arch, shape, mp), rec in lowered.items():
        if mp or rec["status"] == "SKIP":
            continue
        total, kv, scalar = ref["bytes"][f"{arch}/{shape}"]
        want = total - scalar
        if (arch, shape) in KV_DEPARTURES:
            port_kv = _kv_bytes((arch, shape))
            assert port_kv != kv
            want += port_kv - kv
            departed.add((arch, shape))
        assert rec["argument_size"] == want, (arch, shape, rec["argument_size"],
                                              want)
    assert departed == KV_DEPARTURES and len(departed) == 7


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mixtral-8x7b"])
def test_run_cell_two_layers_is_ok(arch, shape):
    rec = dryrun.run_cell(arch, shape, False, n_layers=2)
    assert rec["status"] == "OK", rec.get("error")
    assert REF_KEYS["OK"] <= set(rec)
    assert rec["n_layers"] == 2 and rec["n_devices"] == 256
    assert math.isfinite(rec["flops_per_device"]) and rec["flops_per_device"] > 0
    assert rec["bytes_accessed_per_device"] is None
    assert rec["generated_code_size"] is None
    assert sum(c["count"] for c in rec["collectives"].values()) > 0
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVES)
    assert rec["temp_size"] > 0 and rec["output_size"] > 0
    assert rec["fits_80gb"] == (rec["argument_size"] + rec["temp_size"] <= 80e9)
    if shape == "train_4k":         # the parameters and AdamW state, in place
        assert rec["alias_size"] > 0


def test_parse_collectives_sums_records_by_kind():
    got = dryrun.parse_collectives([("allreduce_", 8), ("allgather_", 32),
                                    ("allreduce_", 4), ("recv_", 2),
                                    ("alltoall_base_", 16), ("send", 2)])
    assert got == {"all-gather": {"count": 1, "bytes": 32},
                   "all-reduce": {"count": 2, "bytes": 12},
                   "reduce-scatter": {"count": 0, "bytes": 0},
                   "all-to-all": {"count": 1, "bytes": 16},
                   "collective-permute": {"count": 1, "bytes": 2}}


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(4, device="cpu", transport="gloo")
    procs = list(p._procs)
    yield p
    p.close()
    assert not any(q.is_alive() for q in procs)


CELLS = {"train": ShapeCell("t", 32, 4, "train"),
         "decode": ShapeCell("d", 64, 4, "decode")}


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mixtral-8x7b"])
def test_account_equals_a_real_step_on_gloo_ranks(pool, arch, kind):
    """Phase 15 (c)'s rule at smoke size: the meta accounting of rank 0 of
    a 2×2 mesh over gloo against the same step on 4 CPU ranks."""
    cfg, shape = ARCHS[arch].smoke(), CELLS[kind]
    rec = dryrun._account(cfg, shape, make_test_mesh(2, 2), ("data",), "gloo")
    real = pool.run(J.real_step_tally, cfg, shape, (2, 2))
    for arg_bytes, kinds in real:
        assert arg_bytes == rec["argument_size"]
        assert kinds == rec["collectives"]
    assert sum(c["count"] for c in rec["collectives"].values()) > 0
