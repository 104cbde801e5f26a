"""Carry arrays of the reference package across to the port.

The reference hands out jax arrays; ``np.asarray`` of one is a read-only
view, which ``torch.from_numpy`` warns about.  These functions copy, so the
tensor owns its memory.  Like every entry point of the port they place the
result on the card unless the caller names another device.

A bfloat16 jax array comes out of ``np.asarray`` as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses: such leaves go through ``np.float32``
and back to ``torch.bfloat16``, a round trip that is exact.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .kernels.ops import resolve_device
from .tree import tree_leaves_with_path, tree_map

__all__ = ["matrix_from_numpy", "profile_from_numpy", "params_from_numpy",
           "opt_state_from_numpy", "tensor_from_numpy"]


def _f32(a: Any, device: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(
        resolve_device(device))


def matrix_from_numpy(m: Any, *, device: Any = None) -> torch.Tensor:
    """A substitution matrix (A, A), e.g. ``np.asarray(ops.BLOSUM50)`` of
    the reference, as an f32 tensor."""
    m = _f32(m, device)
    if m.dim() != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"substitution matrix must be (A, A), got {tuple(m.shape)}")
    return m


def profile_from_numpy(prof: Any, q_len: int, *,
                       device: Any = None) -> Tuple[torch.Tensor, int]:
    """The reference's ``build_profile`` output ``(prof, q_len)``, with
    ``prof`` taken as ``np.asarray(...)``, as the port's ``(profile, q_len)``:
    an (A, Qp) f32 tensor and the true query length."""
    p = _f32(prof, device)
    if p.dim() != 2 or p.shape[1] % 128 or not 0 <= q_len <= p.shape[1]:
        raise ValueError(f"profile must be (A, Qp) with Qp % 128 == 0 and "
                         f"q_len <= Qp, got {tuple(p.shape)}, q_len={q_len}")
    return p, int(q_len)


def tensor_from_numpy(a: Any, *, device: Any = None) -> torch.Tensor:
    """One array (``np.asarray`` of a jax array) as a tensor of the same
    dtype; bfloat16 goes through float32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(resolve_device(device))


def _tree(tree: Any, device: torch.device) -> Any:
    return tree_map(lambda a: tensor_from_numpy(a, device=device), tree)


def params_from_numpy(tree: Dict[str, Any], cfg: Any, *,
                      device: Any = None) -> Dict[str, Any]:
    """The reference's parameter tree (``init_params`` mapped through
    ``np.asarray``) as the port's: the same keys, shapes and dtypes."""
    from .models.model import init_params_spec
    dev = resolve_device(device)
    want = init_params_spec(cfg)
    out = _tree(tree, dev)
    got = {k: (tuple(v.shape), v.dtype) for k, v in tree_leaves_with_path(out)}
    want = dict(tree_leaves_with_path(want))
    if got != want:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"{sorted(set(got) ^ set(want))} or shapes/dtypes differ")
    return out


def opt_state_from_numpy(state: Any, cfg: Any, *, device: Any = None):
    """The reference's ``AdamWState`` (``step``, ``mu``, ``nu``, each
    mapped through ``np.asarray``; a NamedTuple or a (step, mu, nu) tuple)
    as the port's ``repro_torch.optim.AdamWState``: the step as a 0-d int32
    tensor, the moments with the parameters' keys and shapes in their own
    (moment) dtype."""
    from .models.model import init_params_spec
    from .optim import AdamWState
    step, mu, nu = state
    dev = resolve_device(device)
    want = {k: shape for k, (shape, _)
            in tree_leaves_with_path(init_params_spec(cfg))}
    out = []
    for name, tree in (("mu", mu), ("nu", nu)):
        t = _tree(tree, dev)
        got = {k: tuple(v.shape) for k, v in tree_leaves_with_path(t)}
        if got != want:
            raise ValueError(f"{name} does not match {cfg.name}'s parameter "
                             f"tree: {sorted(set(got) ^ set(want))} or shapes "
                             f"differ")
        out.append(t)
    step = torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev)
    return AdamWState(step, *out)
