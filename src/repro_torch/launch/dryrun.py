"""Multi-pod dry run: account every (arch × shape × mesh) cell for one rank.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's sharded step for a 16×16 or 2×16×16 TPU mesh over 512 forced
host devices, then reads XLA's ``memory_analysis``/``cost_analysis`` and
parses the collectives out of the optimized HLO.  Torch has no HLO and no
GSPMD, and the port's collectives are written out by hand
(``parallel/context.py``), so the port compiles nothing.  It runs on the
``meta`` device on purpose: one process plays rank 0 of the 256- or
512-rank mesh (``core.ranks.simulated``: torch's in-process ``"fake"``
process group, which sends nothing), the step's arguments are meta tensors
of the shapes that rank holds (``launch.steps.input_specs``), and the real
step code runs once on them.  No card is touched and no memory is
allocated: Kimi-K2's 1T-parameter tree is built whole.  The kernels have
no form on the meta device, so their plain versions run there, inside
the card's autograd Functions (``FlashAttentionFn``, ``SsdScanFn``): the
step saves for its backward what the card's saves.

A cell's record keeps the reference's keys:

* ``argument_size``: bytes of the tensors among the step's arguments that
  the rank holds (decode's ``cache_len`` is a host int, 0 bytes; the
  reference's is a 4-byte int32 scalar);
* ``output_size``: bytes of the step's outputs;
* ``alias_size``: bytes of the outputs that share storage with an
  argument, i.e. the state updated in place: a train step's parameters
  and AdamW state.  The port's ``decode_step`` writes a new cache, so a
  decode cell's is 0 where the reference donates its cache;
* ``temp_size``: the peak bytes of the live tensors the step made
  (argument storages excluded), by a dispatch mode that adds each new
  storage and drops it once nothing but the mode holds it.  It includes
  the plain versions' transient tensors (an FA block's scores, the plain
  SSD's per-chunk terms), which the kernels do not allocate;
* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the rank's products (the plain attention's and SSD scan's
  included: what the kernels' plain versions multiply);
* ``collectives``: :func:`parse_collectives` of the collectives the step
  issued (``core.dchannel.tally``), by the reference's five kinds, with the
  bytes of each op's result;
* ``n_devices``.

``bytes_accessed_per_device`` and ``generated_code_size`` are null:
nothing here measures them.  Added keys: ``fits_80gb`` (``argument_size +
temp_size`` within an H100's 80 GB, 80e9 bytes; null unless both were
measured), ``device`` ("meta") and ``transport`` (the production run is
NCCL's: 16-bit sums travel as they are).  With ``--no-compile`` the step
is not run: status ``LOWERED``, with the arguments' bytes.  ``--layers n``
cuts the depth; a hybrid or vlm arch keeps whole groups (n rounded up to
``attn_every``/``cross_attn_every``, where the reference's model would
refuse it).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out <path>
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, SHAPES, cell_applicable
from ..core import dchannel, ranks
from ..core.dchannel import COLLECTIVES
from ..parallel.context import Mesh, mesh_context
from .mesh import DP_AXES, make_production_mesh
from .steps import input_specs, step_fn_for

__all__ = ["COLLECTIVES", "parse_collectives", "run_cell", "main", "ARCHS",
           "SHAPES", "cell_applicable", "DP_AXES", "make_production_mesh",
           "mesh_context", "input_specs", "step_fn_for"]

HBM_BYTES = 80e9    # an H100's memory, as fits_80gb reads it


def parse_collectives(records: Iterable[Tuple[str, int]]) -> dict:
    """The reference's ``{kind: {"count", "bytes"}}`` of a tally's records
    ((c10d operator, bytes of its result), ``core.dchannel.Tally``), where
    the reference parses the optimized HLO's text."""
    t = dchannel.Tally()
    t.records.extend(records)
    return t.kinds()


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, tuples, lists and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _storage_bytes(tensors: Iterable[torch.Tensor]) -> Tuple[int, set]:
    """(bytes of the distinct storages of ``tensors``, their keys)."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total, seen


class _LiveBytes(TorchDispatchMode):
    """A dispatch mode that follows the bytes of the storages the step
    makes: each new one adds its size; it is held by the mode and dropped
    once the mode's handle is its only user.  The peak is exact: dead
    storages are dropped whenever the live total would pass it."""

    def __init__(self, skip: set):
        super().__init__()
        self.skip = skip
        self.held: Dict[int, Tuple[Any, int]] = {}
        self.now = self.peak = 0

    def _purge(self) -> None:
        for key, (st, n) in list(self.held.items()):
            if torch._C._storage_Use_Count(st._cdata) <= 1:
                del self.held[key]
                self.now -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.skip or key in self.held:
                continue
            n = st.nbytes()
            self.held[key] = (st, n)
            self.now += n
            if self.now > self.peak:
                self._purge()
                self.peak = max(self.peak, self.now)
        return out


def _run_counted(fn, args, skip: set):
    """``fn(*args)`` under the tally, the FLOP counter and the live-bytes
    mode: (output, records, flops, peak live bytes)."""
    live, flops = _LiveBytes(skip), FlopCounterMode(display=False)
    with dchannel.tally() as tally, flops, live:
        out = fn(*args)
    return out, tally.records, flops.get_total_flops(), live.peak


def _account(cfg, shape, mesh: Mesh, dp_axes, transport: str,
             run: bool = True) -> Dict[str, Any]:
    """One cell's measured keys for rank 0 of ``mesh`` (a simulated rank
    over ``transport``'s rules): the step of ``step_fn_for`` on the meta
    tensors of ``input_specs``, run once when ``run``."""
    with ranks.simulated(mesh.size, 0, transport=transport), \
            mesh_context(mesh, dp_axes=dp_axes) as ctx:
        t0 = time.time()
        fn, argnames = step_fn_for(cfg, shape, ctx)
        specs = input_specs(cfg, shape, ctx)
        args = [specs[a] for a in argnames]
        arg_bytes, arg_keys = _storage_bytes(_tensors(args))
        rec: Dict[str, Any] = {"argument_size": arg_bytes, "device": "meta",
                               "transport": transport,
                               "n_devices": mesh.size,
                               "lower_s": round(time.time() - t0, 1)}
        if not run:
            rec.update(status="LOWERED", fits_80gb=None)
            return rec
        t1 = time.time()
        out, records, flops, peak = _run_counted(fn, args, arg_keys)
        out_tensors = _tensors(out)
        out_bytes, out_keys = _storage_bytes(out_tensors)
        alias = sum(t.untyped_storage().nbytes() for t in
                    {t.untyped_storage()._cdata: t for t in out_tensors
                     if t.untyped_storage()._cdata in arg_keys}.values())
        rec.update(
            status="OK", compile_s=round(time.time() - t1, 1),
            flops_per_device=float(flops), bytes_accessed_per_device=None,
            output_size=out_bytes, temp_size=peak, alias_size=alias,
            generated_code_size=None,
            collectives=parse_collectives(records),
            fits_80gb=bool(arg_bytes + peak <= HBM_BYTES))
        return rec


def _whole_groups(cfg, n_layers: int):
    """``cfg`` cut to ``n_layers``, rounded up to whole groups for the
    hybrid and vlm families."""
    every = {"hybrid": cfg.attn_every, "vlm": cfg.cross_attn_every}.get(
        cfg.family)
    if every:
        n_layers = every * math.ceil(n_layers / every)
    return cfg.replace(n_layers=n_layers)


def run_cell(arch: str, shape_name: str, multi_pod: bool, compile_: bool = True,
             unroll: bool = False, n_layers: int = 0) -> dict:
    cfg = ARCHS[arch]
    shape = next(s for s in SHAPES if s.name == shape_name)
    ok, why = cell_applicable(arch, shape)
    os.environ["REPRO_UNROLL"] = "1" if unroll else "0"
    if n_layers:
        cfg = _whole_groups(cfg, n_layers)
    if unroll:
        # the reference's bigger tiles (its compile's sake); the port's
        # loops count every layer either way
        cfg = cfg.replace(attn_q_chunk=4096, attn_kv_chunk=4096,
                          loss_chunk=0 if shape.kind != "train" else 4096)
    # the reference's variant knobs, recorded in the output record
    variant: Dict[str, Any] = {}
    if os.environ.get("REPRO_MOE_BACKEND"):
        variant["moe_backend"] = os.environ["REPRO_MOE_BACKEND"]
    if os.environ.get("REPRO_SSM_BF16") == "1":
        variant["ssm_compute_dtype"] = "bfloat16"
    if os.environ.get("REPRO_LOSS_CHUNK"):
        variant["loss_chunk"] = int(os.environ["REPRO_LOSS_CHUNK"])
    if os.environ.get("REPRO_MOE_WIRE"):
        variant["moe_wire_dtype"] = os.environ["REPRO_MOE_WIRE"]
    if os.environ.get("REPRO_SSM_CHUNK"):
        variant["ssm_chunk"] = int(os.environ["REPRO_SSM_CHUNK"])
    if os.environ.get("REPRO_CAUSAL_SKIP") == "1":
        variant["causal_skip"] = True
    variant = {k: v for k, v in variant.items() if hasattr(cfg, k)}
    if variant:
        cfg = cfg.replace(**variant)
    rec = {"arch": arch, "shape": shape_name, "unrolled": unroll,
           "n_layers": cfg.n_layers, "variant": variant,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="SKIP", reason=why)
        return rec
    try:
        rec.update(_account(cfg, shape, make_production_mesh(multi_pod=multi_pod),
                            DP_AXES(multi_pod), "nccl", run=compile_))
    except Exception as e:  # the cell's failure is its record
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--no-compile", action="store_true",
                    help="build the specs only (status LOWERED)")
    ap.add_argument("--unroll", action="store_true",
                    help="the reference's unrolled-scan cells (the port's "
                         "layer loops are Python loops: counts are full "
                         "either way)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override n_layers (whole groups for hybrid/vlm)")
    args = ap.parse_args(argv)

    cells = []
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) \
        else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    failures = 0
    out_f = open(args.out, "a") if args.out else None
    try:
        for mp in pods:
            for a in archs:
                for s in shapes:
                    print(f"=== {a} × {s} × mesh={'2x16x16' if mp else '16x16'} "
                          f"===", flush=True)
                    rec = run_cell(a, s, mp, compile_=not args.no_compile,
                                   unroll=args.unroll, n_layers=args.layers)
                    line = f"  -> {rec['status']}"
                    if rec["status"] == "SKIP":
                        line += f" ({rec.get('reason', '')})"
                    elif rec["status"] in ("OK", "LOWERED"):
                        line += (f" argument_size={rec['argument_size']} "
                                 f"lower={rec.get('lower_s')}s")
                    if rec["status"] == "OK":
                        line += (f" run={rec['compile_s']}s temp_size="
                                 f"{rec['temp_size']} flops/dev="
                                 f"{rec['flops_per_device']:.3e}")
                    print(line, flush=True)
                    if rec["status"] == "FAIL":
                        failures += 1
                        print(rec["error"])
                        print(rec.get("trace", "")[-1500:])
                    if out_f:
                        rec.pop("trace", None)
                        out_f.write(json.dumps(rec) + "\n")
                        out_f.flush()
                    cells.append(rec)
    finally:
        if out_f:
            out_f.close()
    done = sum(c["status"] in ("OK", "LOWERED") for c in cells)
    print(f"\n{done} {'LOWERED' if args.no_compile else 'OK'} / "
          f"{sum(c['status'] == 'SKIP' for c in cells)} SKIP / {failures} FAIL "
          f"of {len(cells)} cells")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
