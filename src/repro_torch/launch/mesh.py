"""Mesh factories.

Counterpart of ``repro.launch.mesh``.  A mesh is a small descriptor
(:class:`repro_torch.parallel.context.Mesh`: axis names and sizes) that a
rank job enters with ``mesh_context``; the ranks it names are those of a
``repro_torch.core.ranks.RankPool`` of ``mesh.size`` processes, laid out
row-major (the model axis varies fastest).  ``make_production_mesh`` is
the reference's 256/512-chip TPU mesh as such a descriptor: the dry run
(``launch/dryrun.py``) enters it as one simulated rank of it
(``repro_torch.core.ranks.simulated``).
"""
from __future__ import annotations

from ..parallel.context import Mesh

__all__ = ["Mesh", "make_production_mesh", "make_test_mesh", "DP_AXES",
           "MODEL_AXIS"]

MODEL_AXIS = "model"


def DP_AXES(multi_pod: bool = False):
    return ("pod", "data") if multi_pod else ("data",)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single pod (256 ranks) or 2×16×16 two pods (512 ranks)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod``."""
    if pod:
        return Mesh(("pod", "data", "model"), (pod, data, model))
    return Mesh(("data", "model"), (data, model))
